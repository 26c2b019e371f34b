"""The c4 slice: the port's batched replay (`sosvo_torch.vo.batched`) against
the port's own sequential replay and against the JAX package's batched replay.

Sizes are tests/test_batched_replay.py's: S=4 lanes of F=8 frames, K=256
features, 2048 landmarks, 0.2 px noise and 1 % bit flips; frame to frame
with the default config (H=512), and with window BA at W=4, L=512, 3 LM
iterations and a keyframe every 3 frames (H=256). The observations are the
JAX package's, carried across by `sosvo_torch.convert`.

* Port batched == port sequential, lane by lane from the same generators:
  discrete outputs bit-equal, poses within 1e-5 (f2f) and 1e-4 (BA), the
  JAX package's own batched-vs-sequential bounds.
* Port batched vs JAX batched, the port given the reference's lane draws
  (`tools/reference_draws.batched_replay_draws`: lane s starts from
  `split(PRNGKey(1), S)[s]`): the bounds of the sequential parity tests,
  n_inliers within 2, positions and ATE within 1e-3.
* `apply_deferred_gate` against the JAX function on a batch where one lane
  needs the gate.
* The BA replay's `insert_fn`/`ba_fn` hooks stand in for every lane.
On CPU tensors neither kernel launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.geom.lie import so3_exp as jax_so3_exp
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.scene import make_scene as jax_make_scene, observe_sequence as jax_observe
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import batched as jb
from sosvo.vo import pipeline as jp
from sosvo_torch.convert import (ba_state_from_numpy, observations_from_numpy, rig_from_numpy,
                                 track_state_from_numpy)
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.kernels import match_cuda, schur_cuda
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.tools.reference_draws import batched_replay_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import batched as tb
from sosvo_torch.vo import pipeline as tp
from sosvo_torch.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.vo.pipeline import GateCtx, run_replay
from sosvo_torch.vo.keyframes import insert_keyframe
from sosvo_torch.vo.state import StepOutput, init_track_state, lane, stack_lanes

torch.set_num_threads(1)
S, F, K = 4, 8, 256
STATE_SEED = 1  # the reference test's PRNGKey(1), and the port lanes' seed

F2F_CFG = PipelineConfig()
BA_CFG = PipelineConfig(frontend=FrontendConfig(max_features=K), ransac=RansacConfig(n_hyps=256),
                        ba=BAConfig(window=4, max_landmarks=512, iters=3, use_pallas_schur=False),
                        keyframe_every=3)


def _port_cfg(cfg):
    return tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def problem():
    rig = jax_default_rig()
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    scenes = [jax_make_scene(k, n_frames=F, n_landmarks=2048) for k in keys]
    obs = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[jax_observe(rig, sc, K, k, pixel_noise=0.2, desc_flip_prob=0.01)
                         for sc, k in zip(scenes, keys)])
    T0 = jnp.stack([sc.poses[0] for sc in scenes])
    return dict(rig=rig, scenes=scenes, obs=obs, T0=T0, t_rig=rig_from_numpy(rig, "cpu"),
                t_obs=observations_from_numpy(obs, "cpu"), t_T0=torch.tensor(np.asarray(T0)),
                gt=[np.asarray(sc.poses) for sc in scenes])


_RUNS = {}


@pytest.fixture(scope="module", params=["f2f", "ba"])
def runs(request, problem):
    return _runs(request.param, problem)


def _runs(mode, problem):
    """The port's batched replay, its sequential replay of each lane, and
    both packages' batched replays with the reference's draws (once per
    mode)."""
    if mode in _RUNS:
        return _RUNS[mode]
    cfg = F2F_CFG if mode == "f2f" else BA_CFG
    tcfg = _port_cfg(cfg)
    rig, t_rig, t_obs, t_T0 = problem["rig"], problem["t_rig"], problem["t_obs"], problem["t_T0"]
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    if mode == "f2f":
        states = tb.init_batched_states(S, K, STATE_SEED, T0=t_T0, device="cpu")
        _, batched = tb.run_replay_batched(t_rig, tcfg, states, t_obs)
    else:
        states = tb.init_batched_ba_states(S, tcfg, STATE_SEED, T0=t_T0, device="cpu")
        _, batched = tb.run_replay_ba_batched(t_rig, tcfg, states, t_obs)
    seq = []
    for s, gen in enumerate(tb.lane_generators(STATE_SEED, S, "cpu")):
        if mode == "f2f":
            st = init_track_state(K, gen, T0=t_T0[s], device="cpu")
            seq.append(run_replay(t_rig, tcfg, st, lane(t_obs, s))[1])
        else:
            st = init_ba_state(tcfg, gen, T0=t_T0[s], device="cpu")
            seq.append(run_replay_ba(t_rig, tcfg, st, lane(t_obs, s))[1])

    key = jax.random.PRNGKey(STATE_SEED)
    if mode == "f2f":
        j_states = jb.init_batched_states(S, K, key, T0=problem["T0"])
        _, ref = jax.jit(lambda s, o: jb.run_replay_batched(rig, cfg, s, o))(j_states, problem["obs"])
        draws = batched_replay_draws(S, F, cfg.ransac.n_hyps, K, "cpu", seed=STATE_SEED)
        t_states = stack_lanes([track_state_from_numpy(jax.tree.map(lambda x: x[s], j_states),
                                                       torch.Generator(), "cpu") for s in range(S)])
        _, ref_port = tb.run_replay_batched(t_rig, tcfg, t_states, t_obs, draws)
    else:
        j_states = jb.init_batched_ba_states(S, cfg, key, T0=problem["T0"])
        _, ref = jax.jit(lambda s, o: jb.run_replay_ba_batched(rig, cfg, s, o))(
            j_states, problem["obs"])
        draws = batched_replay_draws(S, F, cfg.ransac.n_hyps, K, "cpu", seed=STATE_SEED,
                                     reloc_slots=cfg.ba.max_landmarks)
        t_states = stack_lanes([ba_state_from_numpy(jax.tree.map(lambda x: x[s], j_states),
                                                    torch.Generator(), "cpu") for s in range(S)])
        _, ref_port = tb.run_replay_ba_batched(t_rig, tcfg, t_states, t_obs, draws)
    launches = (match_cuda.launches, schur_cuda.launches)
    _RUNS[mode] = dict(mode=mode, batched=batched, seq=seq, ref=ref, ref_port=ref_port,
                       launches=launches)
    return _RUNS[mode]


def _vo(out, mode):
    return out if mode == "f2f" else out.vo


def test_batched_equals_sequential(runs):
    """Each lane of the batched replay is its sequential replay: discrete
    outputs bit-equal, poses within the JAX package's batched bound."""
    mode = runs["mode"]
    vo_b = _vo(runs["batched"], mode)
    assert bool(vo_b.pose_ok[:, 1:].all())
    bound = 1e-5 if mode == "f2f" else 1e-4
    for s, seq in enumerate(runs["seq"]):
        vo_s = _vo(seq, mode)
        for name in ("pose_ok", "n_stereo", "n_temporal", "n_inliers"):
            assert torch.equal(getattr(vo_b, name)[s], getattr(vo_s, name)), (s, name)
        assert float((vo_b.T_world[s] - vo_s.T_world).abs().max()) < bound
        if mode == "ba":
            for name in ("is_keyframe", "n_landmarks", "reloc_tried"):
                assert torch.equal(getattr(runs["batched"], name)[s], getattr(seq, name)), (s, name)
            torch.testing.assert_close(runs["batched"].ba_cost[s], seq.ba_cost, rtol=1e-5, atol=0)


def test_batched_ba_keyframes_and_cost(problem):
    """The batched BA replay ran the keyframe stage on the stride schedule
    and at least one window solve left a cost."""
    out = _runs("ba", problem)["batched"]
    assert int(out.is_keyframe.sum()) == S * ((F + 2) // 3)
    assert bool((out.ba_cost > 0).any())


def test_batched_matches_jax_batched(runs, problem):
    """With the reference's lane draws the port's batched replay holds the
    sequential parity tests' bounds against the JAX package's."""
    mode = runs["mode"]
    ref, got = _vo(runs["ref"], mode), _vo(runs["ref_port"], mode)
    for name in ("pose_ok", "n_stereo", "n_temporal"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    diff = np.abs(got.n_inliers.numpy().astype(int) - np.asarray(ref.n_inliers).astype(int))
    assert diff.max() <= 2, (got.n_inliers, ref.n_inliers)
    if mode == "ba":
        np.testing.assert_array_equal(runs["ref_port"].is_keyframe.numpy(),
                                      np.asarray(runs["ref"].is_keyframe))
    pos_ref = np.asarray(ref.T_world)[..., :3, 3]
    pos_got = got.T_world.numpy()[..., :3, 3]
    assert np.abs(pos_got - pos_ref).max() < 1e-3
    for s in range(S):
        gt = problem["gt"][s][1:, :3, 3]
        ate_ref = float(jax_ate(ref.T_world[s, 1:, :3, 3], gt)[0])
        ate_got = float(ate_rmse(got.T_world[s, 1:, :3, 3], torch.tensor(gt))[0])
        assert abs(ate_got - ate_ref) < 1e-3, (s, ate_got, ate_ref)
        assert ate_got < 0.05


def test_batched_ba_hooks_replace_insertion_and_solve(problem):
    """`insert_fn` and `ba_fn` stand in for the insertion and the window
    solve in every lane: over frames 0-3 (keyframes 0 and 3) each lane
    inserts twice and solves once; a solve that returns its map with cost 0
    leaves ba_cost 0, the map as inserted, and the pose the window head's."""
    tcfg = _port_cfg(BA_CFG)
    calls = {"insert": 0, "ba": 0}
    solved = []

    def insert_fn(*a, **k):
        calls["insert"] += 1
        return insert_keyframe(*a, **k)

    def ba_fn(m):
        calls["ba"] += 1
        solved.append(m)
        return m, torch.zeros(())

    obs = FrameObservations(*(x[:, :4] for x in problem["t_obs"]))
    states = tb.init_batched_ba_states(S, tcfg, STATE_SEED, T0=problem["t_T0"], device="cpu")
    final, out = tb.run_replay_ba_batched(problem["t_rig"], tcfg, states, obs,
                                          ba_fn=ba_fn, insert_fn=insert_fn)
    assert calls == {"insert": 2 * S, "ba": S}
    assert out.is_keyframe.tolist() == [[True, False, False, True]] * S
    assert not bool(out.ba_cost.any())
    for s, m in enumerate(solved):
        assert torch.equal(final.map.kf_X[s], m.kf_X)
        assert torch.equal(final.map.lm_pos[s], m.lm_pos)
        head = m.kf_X[int(m.head)]
        torch.testing.assert_close(out.vo.T_world[s, 3], torch.linalg.inv(head))


def test_cpu_batched_replay_launches_no_kernel(runs):
    assert runs["launches"] == (0, 0)


def test_apply_deferred_gate_matches_jax(problem):
    """Frame 1 of the 4-lane batch with lane 0 alone needing the gate and
    its rigid rotation 0.5 rad off, so the gate rejects it; lane 1's is off
    too but it does not need the gate, so it keeps verdict True and angle 0."""
    n = S
    cfg = F2F_CFG
    rig, obs = problem["rig"], problem["obs"]
    deferred = jax.jit(jax.vmap(lambda st, ob: jp.step_full(rig, cfg, st, ob, defer_gate=True)))
    states = jb.init_batched_states(n, K, jax.random.PRNGKey(STATE_SEED), T0=problem["T0"])
    states = deferred(states, jax.tree.map(lambda x: x[:, 0], obs))[0]  # frame 0 moves no pose
    new, out, _, ctx = deferred(states, jax.tree.map(lambda x: x[:, 1], obs))
    off = jax_so3_exp(jnp.array([0.0, 0.0, 0.5], jnp.float32))
    ctx = ctx._replace(need=jnp.array([True, False, False, False]),
                       R_rigid=ctx.R_rigid.at[:2].set(ctx.R_rigid[:2] @ off))
    ref_state, ref_out = jp.apply_deferred_gate(cfg, states.T_world, new, out, ctx)

    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    t_new = stack_lanes([track_state_from_numpy(jax.tree.map(lambda x: x[s], new),
                                                torch.Generator(), "cpu") for s in range(n)])
    t_ctx = GateCtx(need=t(ctx.need), prev_rays=t(ctx.prev_rays), rays_curr=t(ctx.rays_curr),
                    pair_valid=t(ctx.pair_valid), R_rigid=t(ctx.R_rigid))
    g_ess = torch.stack([t(jax.random.gumbel(ctx.key[s], (cfg.ransac.n_hyps, K)))
                         for s in range(n)])
    got_state, got_out = tp.apply_deferred_gate(
        _port_cfg(cfg), t(states.T_world), t_new, StepOutput(*(t(x) for x in out)), t_ctx, g_ess)

    np.testing.assert_array_equal(got_out.pose_ok.numpy(), np.asarray(ref_out.pose_ok))
    assert got_out.pose_ok.tolist() == [False, True, True, True]
    assert got_out.ess_angle_err[1:].tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(got_out.ess_angle_err.numpy(), np.asarray(ref_out.ess_angle_err),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got_state.T_world.numpy(), np.asarray(ref_state.T_world))
    np.testing.assert_array_equal(got_out.T_world[0].numpy(), np.asarray(states.T_world[0]))


def test_ba_fn_hook_in_both_replays(problem):
    """The sequential replay takes the batched replay's `ba_fn` too: a solve
    that returns its map with cost 0 leaves every BA cost 0 and the map as
    inserted, in the sequential replay of lane 0 and in the batched replay,
    and lane 0 comes out the same from both."""
    tcfg = _port_cfg(BA_CFG)
    solved = {"seq": [], "batched": []}

    def hook(name):
        def ba_fn(m):
            solved[name].append(m)
            return m, torch.zeros(())
        return ba_fn

    obs = FrameObservations(*(x[:, :7] for x in problem["t_obs"]))
    gen = tb.lane_generators(STATE_SEED, S, "cpu")[0]
    st = init_ba_state(tcfg, gen, T0=problem["t_T0"][0], device="cpu")
    final_1, out_1 = run_replay_ba(problem["t_rig"], tcfg, st, lane(obs, 0), ba_fn=hook("seq"))
    states = tb.init_batched_ba_states(S, tcfg, STATE_SEED, T0=problem["t_T0"], device="cpu")
    final_s, out_s = tb.run_replay_ba_batched(problem["t_rig"], tcfg, states, obs,
                                              ba_fn=hook("batched"))
    assert len(solved["seq"]) == 2 and len(solved["batched"]) == 2 * S  # keyframes 3 and 6
    assert not bool(out_1.ba_cost.any()) and not bool(out_s.ba_cost.any())
    for got, m in ((final_1.map, solved["seq"][-1]), (lane(final_s.map, 0), solved["batched"][-S])):
        assert all(torch.equal(a, b) for a, b in zip(got, m))
    assert torch.equal(out_1.vo.T_world, out_s.vo.T_world[0])
    assert torch.equal(out_1.is_keyframe, out_s.is_keyframe[0])
