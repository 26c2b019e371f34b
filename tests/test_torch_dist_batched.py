"""The batched replay with its lanes split over ranks
(`sosvo_torch.vo.batched.shard_batched_inputs` / `gather_lanes`), and the
port's twin of tests/test_multihost.py, on the CPU (gloo).

  * 4 lanes over 2 ranks, frame to frame and with window BA: every lane's
    outputs and final state equal the one-process batched replay's bit for
    bit (each rank replays its lanes with those lanes' own generators);
  * two rank processes run the landmark-sharded BA and the time-sharded
    PGO across the process boundary: both ranks report the same costs, the
    BA's poses are within 1e-4 of one process's solve and its cost within
    1e-6 + 1e-3 relative, the pose graph's within 3e-3 of the dense solve
    (scripts/multihost_worker.py's bounds), and both costs fall.
"""

import torch
import pytest

from sosvo_torch.dist.launch import launch
from sosvo_torch.tools.workload import make_batched_workload
from sosvo_torch.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo_torch.vo import batched as tb

S, F, K, SEED = 4, 7, 128, 3
CFG = PipelineConfig(frontend=FrontendConfig(max_features=K), ransac=RansacConfig(n_hyps=128),
                     ba=BAConfig(window=3, max_landmarks=256, iters=2), keyframe_every=3)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return []


@pytest.mark.parametrize("mode", ["f2f", "ba"])
def test_lanes_over_ranks_equal_one_process(mode):
    torch.set_num_threads(1)
    rig, gt, obs = make_batched_workload(CFG, S, F, 2048, "cpu")
    if mode == "ba":
        states = tb.init_batched_ba_states(S, CFG, SEED, T0=gt[:, 0], device="cpu")
        final, outs = tb.run_replay_ba_batched(rig, CFG, states, obs)
    else:
        states = tb.init_batched_states(S, K, SEED, T0=gt[:, 0], device="cpu")
        final, outs = tb.run_replay_batched(rig, CFG, states, obs)
    ranks = launch("tests.torch_dist_ranks:batched_over_ranks", 2,
                   dict(rig=rig, cfg=CFG, obs=obs, T0=gt[:, 0], seed=SEED, mode=mode),
                   device="cpu", timeout_s=300)
    for got_outs, got_final in ranks:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got_outs), _leaves(outs)))
        # generators come back as their states (tensors) from the ranks
        want = [x for x in _leaves(final)]
        got = [x for x in _leaves(got_final)]
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_two_process_ba_and_time_sharded_pgo():
    outs = launch("tests.torch_dist_ranks:multihost", 2, device="cpu", timeout_s=300)
    r0, r1 = sorted(outs, key=lambda o: o["rank"])
    assert r0["world"] == r1["world"] == 2
    assert r0["cost"] == r1["cost"] and r0["pgo_cost"] == r1["pgo_cost"]
    assert r0["cost0"] > 1e-6 and r0["cost"] < r0["cost0"]
    assert r0["x_diff_vs_single"] < 1e-4
    assert abs(r0["cost"] - r0["cost_single"]) < 1e-6 + 1e-3 * r0["cost0"]
    assert r0["pgo_cost"] < 0.1 * r0["pgo_cost0"]
    assert r0["pgo_x_diff_vs_dense"] < 3e-3
