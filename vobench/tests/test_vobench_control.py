"""The control on the card: the reference computed with TF32 products, in the
program's place, must come out not correct, while the program comes out
correct, at c2.replay's own size on three seeds.

    python -m pytest vobench/tests/test_vobench_control.py   (on a CUDA card)

It skips where there is no card: TF32 exists only there.
"""

import json
from pathlib import Path

import pytest

from vobench import correct, drivers, inputs
from vobench.program import Program

ROOT = Path(__file__).resolve().parents[2]
CELL = "c2.replay"


@pytest.mark.card
@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**33 + 5])
def test_tf32_control_is_not_correct(cuda_device, seed):
    config_path = ROOT / "vobench" / "configs" / "c2_chip_ba.json"
    config = json.loads(config_path.read_text())
    limits = json.loads((ROOT / "vobench" / "limits" / f"{CELL}.json").read_text())["numbers"]
    inp = inputs.make_inputs(config, seed, cuda_device)
    program = Program(config_path, config["assumed"], cuda_device)
    program.build_luts()
    out = drivers.Replay(program, inp, config).one_pass()
    ref = correct.reference_run(config_path, config, inp, cuda_device)
    ctl = correct.reference_run(config_path, config, inp, cuda_device, control=True)
    ok_program, _ = correct.judge(correct.readings([out], ref), limits)
    ok_control, checks = correct.judge(correct.readings([drivers.PassOut(ctl.T_world,
                                                                         ctl.pose_ok)], ref),
                                       limits)
    assert ok_program
    assert not ok_control, checks
