"""The command line over two ranks on the CPU (`python -m sosvo_torch.cli`
started by `sosvo_torch.dist.launch.launch_module`, gloo), at cut sizes
(K=128, H=128, a few frames).

  * c5 (`dist.model_parallel`) with --verify-sharded: the report names the
    model axis of 2 and the largest pose difference from the one-device
    replay (under 1e-3), and its ATE equals the one-process run's;
  * a fault injected after frame 5 and --resume at model_parallel 2: the
    resumed log equals the uninterrupted run's byte for byte;
  * `dist.pgo_shards` 2 on the c3_long observation preset: rank 0 replays,
    the leg runs over both ranks, and it closes the same loops as the
    one-process leg, with the ATE within 1.05 x + 1e-4 of it;
  * `dist.data_parallel` 2 on c4: each rank replays one of two lanes; the
    report's lane ATEs and the log equal the one-process batched run's.
"""

import json
from pathlib import Path

import pytest

from sosvo_torch import cli
from sosvo_torch.dist.launch import launch_module

ROOT = Path(__file__).resolve().parents[1]
CUT = {"frontend": {"max_features": 128}, "ransac": {"n_hyps": 128}}


def _preset(tmp_path, name, run, pipeline):
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg["run"].update(run)
    for k, v in {**CUT, **pipeline}.items():
        cfg["pipeline"][k] = {**cfg["pipeline"].get(k, {}), **v} if isinstance(v, dict) else v
    p = tmp_path / f"{name}_cut.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def _ranks(config, out, *extra, world=2, ok_codes=(0,)):
    args = ["--config", config, "--device", "cpu", "--out", str(out), *extra]
    return launch_module("sosvo_torch.cli", args, world, timeout_s=300, ok_codes=ok_codes,
                         env={"OMP_NUM_THREADS": "1"})


def _report(d):
    return json.loads((d / "report.json").read_text())


@pytest.fixture(scope="module")
def c5(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("c5")
    return tmp, _preset(tmp, "c5_multihost", {"n_frames": 12, "n_landmarks": 2048},
                        {"ba": {"window": 8, "max_landmarks": 256, "iters": 3}})


def test_c5_verify_sharded_at_world_2(c5):
    tmp, config = c5
    _ranks(config, tmp / "w2", "--verify-sharded")
    rep = _report(tmp / "w2")
    assert rep["mesh"] == {"model": 2} and rep["world"] == 2 and rep["frames"] == 12
    assert rep["sharded_vs_single_max_pose_diff"] < 1e-3
    assert abs(rep["ate_rmse_single_device"] - rep["ate_rmse_m"]) < 1e-3
    assert cli.main(["--config", config, "--device", "cpu", "--out", str(tmp / "w1")]) == 0
    one = _report(tmp / "w1")
    assert one["mesh"] == {"model": 1}  # the one-process mesh
    assert abs(one["ate_rmse_m"] - rep["ate_rmse_m"]) < 1e-3


def test_c5_fault_and_resume_at_world_2(c5):
    tmp, config = c5
    args = ("--ckpt-every", "4")
    _ranks(config, tmp / "full", *args)
    exits = _ranks(config, tmp / "faulted", *args, "--fault-inject", "5", ok_codes=(42,))
    assert [e.returncode for e in exits] == [42, 42]
    exits = _ranks(config, tmp / "faulted", *args, "--resume")
    assert "resumed from checkpoint at frame 8" in exits[0].stdout
    a = (tmp / "full" / "frames.jsonl").read_text()
    assert a == (tmp / "faulted" / "frames.jsonl").read_text() and len(a.splitlines()) == 12


def test_pgo_shards_at_world_2(tmp_path):
    config = _preset(tmp_path, "c3_long_mesh", {"n_frames": 40, "n_landmarks": 4096},
                     {"ba": {"window": 5, "max_landmarks": 256, "iters": 3},
                      "keyframe_every": 4, "loop_candidates": 12, "loop_min_inliers": 10})
    _ranks(config, tmp_path / "w2")
    rep = _report(tmp_path / "w2")
    assert cli.main(["--config", config, "--device", "cpu", "--out", str(tmp_path / "w1")]) == 0
    one = _report(tmp_path / "w1")
    assert rep["pgo_shards"] == 2 and rep["pgo_loops"] == one["pgo_loops"] > 0, (rep, one)
    assert rep["ate_rmse_m"] <= one["ate_rmse_m"] * 1.05 + 1e-4
    assert rep["ate_rmse_vo_m"] == one["ate_rmse_vo_m"]


def test_data_parallel_at_world_2(tmp_path):
    config = _preset(tmp_path, "c4_batched_replay", {"n_frames": 6, "n_landmarks": 2048,
                                                     "n_sequences": 2},
                     {"ba": {"window": 3, "max_landmarks": 256, "iters": 2},
                      "dist": {"data_parallel": 2}, "keyframe_every": 3})
    _ranks(config, tmp_path / "w2", "--mode", "ba")
    assert cli.main(["--config", config, "--device", "cpu", "--mode", "ba",
                     "--out", str(tmp_path / "w1")]) == 0
    rep, one = _report(tmp_path / "w2"), _report(tmp_path / "w1")
    assert rep["mesh"] == {"data": 2} and one["mesh"] == {"data": 1}
    assert rep["ate_per_sequence"] == one["ate_per_sequence"]
    assert ((tmp_path / "w2" / "frames.jsonl").read_text()
            == (tmp_path / "w1" / "frames.jsonl").read_text())
