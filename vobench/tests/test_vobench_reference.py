"""The plain reference against the program's plain path, against its own
saved outputs, its parts looked up by name, and its isolation.

On CPU tensors the program runs its kernels' plain twins, so at a small size
the frozen reference and the program must give the same trajectory, pose_ok
and loops on the same frames and draws. The saved outputs
(`data/reference_<case>.pt`) were written by the reference before its
descriptor family and keyframe mode were modules looked up by name; the
reference must still give them bit for bit.
"""

import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vobench import correct, drivers, inputs
from vobench.program import Program
from vobench.reference.frontend import families, match
from vobench.reference.utils.config import FrontendConfig
from vobench.reference.vo import keyframe_modes

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


# case: (configuration in data/, seed, driver whose draws the reference takes)
SAVED = {"tiny_c2": ("tiny_c2", 2**31 + 5, None), "tiny_c3": ("tiny_c3", 9, None),
         "tiny_live": ("tiny_c3", 2**31 + 9, drivers.Live)}


def _reference(path: Path, seed: int, driver=None):
    config = json.loads(path.read_text())
    inp = inputs.make_inputs(config, seed, CPU)
    kw = {} if driver is None else {"draws": driver.reference_draws(inp, config, CPU),
                                    "leg": driver.LEG}
    return correct.reference_run(path, config, inp, CPU, **kw)


def _assert_saved(ref, case: str):
    saved = torch.load(DATA / f"reference_{case}.pt")
    assert {k for k, v in ref._asdict().items() if v is not None} == set(saved)
    for k, v in saved.items():
        assert torch.equal(getattr(ref, k), v), k


@pytest.mark.parametrize("case", sorted(SAVED))
def test_reference_equals_its_saved_outputs(case):
    name, seed, driver = SAVED[case]
    _assert_saved(_reference(DATA / f"{name}.json", seed, driver), case)


@pytest.mark.parametrize("package,key,built_in", [
    (families, ("frontend", "descriptor"), "brief"),
    (keyframe_modes, ("keyframe_mode",), "stride"),
])
def test_a_part_added_as_a_new_file_is_found_by_name(tmp_path, monkeypatch, package, key,
                                                     built_in):
    """A renamed copy of a built-in part, on the package's path from a
    directory of its own, is picked by a configuration that names it, and
    gives the built-in's outputs."""
    name = f"{built_in}_copy"
    shutil.copy(Path(package.__file__).parent / f"{built_in}.py", tmp_path / f"{name}.py")
    monkeypatch.setattr(package, "__path__", [*package.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    config = json.loads((DATA / "tiny_c2.json").read_text())
    block = config["pipeline"]
    for k in key[:-1]:
        block = block[k]
    block[key[-1]] = name
    path = tmp_path / "tiny_c2.json"
    path.write_text(json.dumps(config))
    try:
        ref = _reference(path, *SAVED["tiny_c2"][1:])
        assert f"{package.__name__}.{name}" in sys.modules
    finally:
        sys.modules.pop(f"{package.__name__}.{name}", None)
    _assert_saved(ref, "tiny_c2")


@pytest.mark.parametrize("look_up,file", [
    (lambda: match.metric_params(FrontendConfig(descriptor="akaze")),
     "vobench/reference/frontend/families/akaze.py"),
    (lambda: keyframe_modes.mode("adaptive"), "vobench/reference/vo/keyframe_modes/adaptive.py"),
])
def test_an_option_with_no_module_names_the_file_to_add(look_up, file):
    with pytest.raises(ValueError, match=f"add {file}"):
        look_up()
