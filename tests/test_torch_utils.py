"""The utils trio of the port: `utils/debug.py` (the numerical sanitizers),
`utils/profiling.py` (trace, timers, H100 rooflines) and `utils/phases.py`
(per-stage timing of the c1 frame and of the image frontend), on the CPU.

`checked` and `strict_numerics` must raise on what the reference's raise
on (a non-finite output; a NaN from any operation) and pass finite work
through unchanged; `library_solvers` flips the reference's flag and changes
no computation (the port's small solvers are the library's already). The
rooflines equal `tools/bounds.py`'s bounds and count the reference's
operations (2 ka kb 256 for the matcher). The phase breakdowns time every
stage under the JAX package's names (PHASES.json's, and its image
breakdown's), and `main` prints one JSON object and writes no file. No
test here calls the JAX package's `strict_numerics` or `main`: they change
JAX state for the whole process.
"""

import inspect
import json
import math

import numpy as np
import pytest
import torch

from sosvo.utils import phases as jax_phases
from sosvo.utils.profiling import roofline_matcher as jax_roofline_matcher
from sosvo_torch.tools import bounds
from sosvo_torch.utils import debug, phases, profiling

torch.set_num_threads(1)
PHASE_NAMES = ("stereo_match", "triangulate", "temporal_match", "ransac_rigid", "refine",
               "ransac_essential", "full_step")
IMAGE_PHASE_NAMES = ("warp", "smooth", "detect", "describe_brief", "describe_sift",
                     "extract_full_2views")


def test_phase_names_are_the_reference_records():
    """The stage names are PHASES.json's and the JAX image breakdown's."""
    from pathlib import Path

    rec = json.loads((Path(__file__).resolve().parents[1] / "PHASES.json").read_text())
    assert tuple(rec["phases_ms"]) == PHASE_NAMES
    src = inspect.getsource(jax_phases.image_phase_breakdown)
    assert all(f't["{n}"]' in src for n in IMAGE_PHASE_NAMES)


def test_checked_passes_finite_outputs_through():
    def step(x):
        return {"a": x * 2.0, "n": torch.tensor(3), "pair": (x + 1.0, [x - 1.0])}

    x = torch.arange(4.0)
    out = debug.checked(step)(x)
    assert torch.equal(out["a"], x * 2.0) and out["n"] == 3


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_checked_raises_on_non_finite_outputs(bad):
    from sosvo_torch.vo.state import StepOutput

    def step(x):
        T = torch.eye(4).expand(2, 4, 4).clone()
        T[1, 0, 3] = x
        z = torch.zeros(2)
        return StepOutput(T_world=T, n_stereo=z.int(), n_temporal=z.int(), n_inliers=z.int(),
                          pose_ok=z.bool(), ess_angle_err=z)

    with pytest.raises(FloatingPointError, match=r"out\.T_world \(1 of 32\)"):
        debug.checked(step)(bad)
    assert debug.checked(step)(0.5).T_world[1, 0, 3] == 0.5


def test_checked_runs_with_library_solvers():
    seen = []
    debug.checked(lambda: seen.append(debug.UNROLLED_SOLVERS))()
    assert seen == [False] and debug.UNROLLED_SOLVERS


def test_strict_numerics_raises_at_the_operation():
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.log(x)).any()  # outside: no check
    with debug.strict_numerics():
        y = torch.sqrt(x.abs())  # finite work passes
        with pytest.raises(FloatingPointError, match="NaN produced by log"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match="NaN produced by"):
            x.sqrt()
    assert torch.equal(y, torch.ones(2))
    assert torch.isnan(torch.log(x)).any()  # the mode is gone after the block


def test_strict_numerics_checks_checked_functions_op_by_op():
    def f(x):
        return torch.log(x).nan_to_num(0.0)  # the NaN is gone by the output

    x = torch.tensor([-1.0])
    assert torch.equal(debug.checked(f)(x), torch.zeros(1))
    with debug.strict_numerics(), pytest.raises(FloatingPointError, match="log"):
        debug.checked(f)(x)


def test_library_solvers_is_a_no_op_here():
    """The flag flips and comes back (also on an exception), and the
    essential RANSAC, the reference's user of its unrolled Cholesky, gives
    the same answer bit for bit inside and outside."""
    from sosvo_torch.geometry.ransac import ransac_essential

    rng = np.random.default_rng(0)
    r1 = torch.tensor(rng.normal(size=(96, 3)), dtype=torch.float32)
    r1 = r1 / r1.norm(dim=-1, keepdim=True)
    R = torch.tensor([[0.99, -0.14, 0.0], [0.14, 0.99, 0.0], [0.0, 0.0, 1.0]])
    r2 = r1 @ R.T
    g = torch.tensor(rng.gumbel(size=(32, 96)), dtype=torch.float32)
    valid = torch.ones(96, dtype=torch.bool)
    out = ransac_essential(g, r1, r2, valid)
    with debug.library_solvers():
        assert debug.UNROLLED_SOLVERS is False
        inside = ransac_essential(g, r1, r2, valid)
    assert debug.UNROLLED_SOLVERS is True
    assert all(torch.equal(a, b) for a, b in zip(out[0], inside[0]))
    assert torch.equal(out[1], inside[1])
    with pytest.raises(ValueError), debug.library_solvers():
        raise ValueError
    assert debug.UNROLLED_SOLVERS is True


@pytest.mark.parametrize("ka, kb, band", [(512, 512, True), (512, 512, False),
                                          (2048, 2048, False), (4096, 1024, False)])
def test_roofline_matcher_is_the_bound(ka, kb, band):
    r = profiling.roofline_matcher(ka, kb, band)
    ms, _ = bounds.matcher_bound_ms(ka, kb, band)
    assert math.isclose(r["sol_fused_s"] * 1e3, ms, rel_tol=1e-12) and r["bound_ms"] == ms
    assert r["ops"] == jax_roofline_matcher(ka, kb)["flops"]
    assert r["sol_xla_s"] >= r["sol_fused_s"] and r["t_mem_xla_s"] > r["t_mem_fused_s"]


@pytest.mark.parametrize("W, L", [(5, 512), (5, 1024), (8, 4096), (2, 2048)])
def test_roofline_schur_is_the_bound(W, L):
    r = profiling.roofline_schur(W, L)
    ms, by = bounds.schur_bound_ms(W, L)
    assert math.isclose(r["sol_s"] * 1e3, ms, rel_tol=1e-12) and r["bound_ms"] == ms
    assert (r["t_mem_s"] >= r["t_compute_s"]) == (by == "bytes")


def test_timers_and_trace(tmp_path):
    calls = []
    t = profiling.time_jitted(lambda a: calls.append(a), 1, n=3, warmup=2)
    assert t >= 0.0 and len(calls) == 5
    calls.clear()
    t = profiling.time_amortized(lambda a: calls.append(a), 2, inner=4, n=3)
    assert t >= 0.0 and len(calls) == 4 * 4
    with profiling.trace(tmp_path / "tr") as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert json.loads((d / "trace.json").read_text())["traceEvents"]
    assert "aten::mm" in (d / "ops.txt").read_text()


def test_phase_breakdown_times_every_stage():
    r = phases.phase_breakdown(k=128, n_landmarks=1024, reps=1, inner=1, device="cpu")
    assert tuple(r["phases_ms"]) == PHASE_NAMES and r["device"] == "cpu" and r["k"] == 128
    assert all(math.isfinite(v) and v > 0 for v in r["phases_ms"].values())


def test_image_phase_breakdown_times_every_stage():
    from sosvo_torch.utils.config import FrontendConfig

    fe = FrontendConfig(max_features=64, pano_height=32, pano_width=256, descriptor_patch=16)
    r = phases.image_phase_breakdown(image_size=192, reps=1, inner=1, cfg=fe, device="cpu")
    assert tuple(r["phases_ms"]) == IMAGE_PHASE_NAMES and r["pano"] == [32, 256]
    assert all(math.isfinite(v) and v > 0 for v in r["phases_ms"].values())


@pytest.mark.parametrize("images", [False, True])
def test_phases_main_prints_json_and_writes_nothing(tmp_path, monkeypatch, capsys, images):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"phases_ms": {"x": 1.0}}

    monkeypatch.setattr(phases, "image_phase_breakdown" if images else "phase_breakdown", fake)
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--k", "64"] + (["--images"] if images else [])
    assert phases.main(argv) == 0
    assert json.loads(capsys.readouterr().out) == {"phases_ms": {"x": 1.0}}
    assert seen == {"k": 64, "device": "cpu"} and not list(tmp_path.iterdir())
