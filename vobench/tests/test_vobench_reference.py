"""The plain reference against the program's plain path, and its isolation.

On CPU tensors the program runs its kernels' plain twins, so at a small size
the frozen reference and the program must give the same trajectory, pose_ok
and loops on the same frames and draws.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

from vobench import correct, drivers, inputs
from vobench.program import Program

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")


def _run_both(name: str, seed: int):
    path = DATA / f"{name}.json"
    config = json.loads(path.read_text())
    inp = inputs.make_inputs(config, seed, CPU)
    program = Program(path, config["assumed"], CPU)
    program.build_luts()
    out = drivers.Replay(program, inp, config).one_pass()
    return out, correct.reference_run(path, config, inp, CPU)


def test_reference_replay_equals_the_programs_plain_path():
    out, ref = _run_both("tiny_c2", 2**31 + 5)
    torch.testing.assert_close(out.T_world, ref.T_world, rtol=0, atol=1e-6)
    assert torch.equal(out.pose_ok, ref.pose_ok)
    assert bool(ref.pose_ok[1:].all())
    r = correct.readings([out], ref)
    assert r["pose_ok_diff"] == 0 and r["pos_gap_m"] <= 1e-6


def test_reference_loop_leg_equals_the_programs_plain_path():
    out, ref = _run_both("tiny_c3", 9)
    torch.testing.assert_close(out.T_corrected, ref.T_corrected, rtol=0, atol=1e-6)
    assert int(out.n_loops) == int(ref.n_loops)
    r = correct.readings([out], ref)
    assert r["loops_diff"] == 0 and r["leg_pos_gap_m"] <= 1e-6


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys, pkgutil, importlib\n"
            "import vobench.reference as r, vobench.correct, vobench.inputs, vobench.roofline\n"
            "for m in pkgutil.walk_packages(r.__path__, 'vobench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "tops = {k.split('.')[0] for k in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'sosvo', 'sosvo_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
