"""configs/c3_adaptive.json's composition at test size: image mode, window BA
with motion-adaptive keyframes, then the loop leg over the scan's own
keyframes, the port against the JAX package.

The command line's room, rendered by the JAX package at 768 px along a
variable-speed trajectory: `make_trajectory` over the circle of
tests/test_torch_image_loop_closure.py (radius 0.4), its parameter warped as
tests/test_adaptive_keyframes.py warps it (the first two thirds hovering at
a tenth of the speed, the last third at 3.2x). At the preset's thresholds
(0.04 m, 0.08 rad, gaps 2 to 8) the hover keyframes at the max gap and the
fast third at the min gap, so the adaptive set is not the stride set, and
the room seen again from the fast third gives loops. The JAX package
extracts the observations (K=384, a 96x768 panorama) and replays them; the
port replays the same observations, carried across by
`sosvo_torch.convert`, with the reference's draws (tests/test_torch_ba_pipeline.py's
`_reference_draws`). Each package then closes loops over its own replay's
`nonzero(is_keyframe)` with c3's leg settings cut to size (6 candidates, 20
inliers, DCS 0.1, min_gap 3), the port with the reference's per-pair draws.

The JAX replay is `run_replay_ba`'s scan over `step_ba`'s own two calls,
`step_full` then `step_ba_post` (sosvo/vo/ba_pipeline.py), with the
trigger's inputs recorded beside the outputs: the rig's translation and
rotation since the last keyframe, and the gap. The smallest distance of a
motion-decided frame to its threshold is printed; a frame within f32
resolution of one would decide its flag by rounding.

Held: keyframe flags equal frame for frame; the PoseGraph each package
solves has the scan's keyframes as its nodes (captured from `pgo_solve`);
n_loops equal and at least one; pose_ok equal; positions before the leg
within 1e-3 m (tests/test_torch_ba_pipeline.py's bound); the ATE after the
leg within 1e-3 m of the reference's (tests/test_torch_image_loop_closure.py's);
the leg's correction constant within each governing segment. On CPU
tensors no kernel launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.geom.lie import geodesic_angle
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import ba_pipeline as jbp
from sosvo.vo import loop_closure as jlc
from sosvo.vo.pipeline import step_full as jax_step_full
from sosvo_torch.convert import ba_state_from_numpy, observations_from_numpy, rig_from_numpy
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.geom.lie import mat_inv
from sosvo_torch.kernels import match_cuda, schur_cuda
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import ba_pipeline as tbp
from sosvo_torch.vo import loop_closure as tlc
from sosvo_torch.vo.pipeline import StepDraws

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16)
RC = RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8)
K, H, L, F = FE.max_features, RC.n_hyps, 256, 30
RELOC_FOLD = 0x5e10c
STRIDE = 4  # configs/c3_host_pgo.json's keyframe_every
CFG = PipelineConfig(frontend=FE, ransac=RC, ba=BAConfig(window=5, max_landmarks=L),
                     mode="images", keyframe_mode="adaptive", kf_trans_thresh=0.04,
                     kf_rot_thresh=0.08, kf_min_gap=2, kf_max_gap=8, pose_graph=True,
                     loop_candidates=6, loop_min_inliers=20)
LEG = dict(min_gap=3, min_inliers=CFG.loop_min_inliers, max_candidates=CFG.loop_candidates,
           robust=CFG.pgo_robust, robust_delta=CFG.pgo_robust_delta)
F32_STEP = 1e-6  # a few f32 steps of the trigger's inputs (~0.1 m, ~0.1 rad)


def _poses():
    """tests/test_adaptive_keyframes.py's speed warp over the radius-0.4 circle."""
    slow = F * 2 // 3
    speeds = jnp.where(jnp.arange(F) < slow, 0.1, 3.2)
    times = jnp.concatenate([jnp.zeros(1), jnp.cumsum(speeds)[:-1]])
    return jax_make_trajectory(F, radius=0.4, times=times)


def _reference_draws(key):
    """The Gumbel matrices the reference's BA replay draws, frame by frame."""
    g = {"rigid": [], "ess": [], "reloc": []}
    for _ in range(F):
        key, k_ransac, k_ess = jax.random.split(key, 3)
        g["rigid"].append(np.asarray(jax.random.gumbel(k_ransac, (H, K))))
        g["ess"].append(np.asarray(jax.random.gumbel(k_ess, (H, K))))
        g["reloc"].append(np.asarray(jax.random.gumbel(jax.random.fold_in(key, RELOC_FOLD), (H, L))))
    return StepDraws(*(torch.tensor(np.stack(g[k])) for k in ("rigid", "ess", "reloc")))


def _pair_draws():
    keys = jax.random.split(jax.random.PRNGKey(tlc.LOOP_SEED), CFG.loop_candidates)
    return torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (H, K)))(keys)))


def _jax_replay(rig, state, obs):
    """`run_replay_ba`'s scan over `step_ba`'s calls, the trigger's inputs
    recorded: (outputs, (F, 2) translation and rotation, (F,) gap)."""
    def body(s, o):
        track, out, feats = jax_step_full(rig, CFG, s.track, o)
        rel = s.map.kf_X[s.map.head] @ track.T_world
        motion = jnp.stack([jnp.linalg.norm(rel[:3, 3]),
                            geodesic_angle(rel[:3, :3], jnp.eye(3, dtype=rel.dtype))])
        s2, out2 = jbp.step_ba_post(rig, CFG, s, track, out, feats)
        return s2, (out2, motion, track.frame_idx - 1 - s.map.kf_frame[s.map.head])

    return jax.jit(lambda s, o: jax.lax.scan(body, s, o)[1])(state, obs)


def _spy(monkeypatch, module):
    """Capture the PoseGraph that `module.pgo_solve` is handed."""
    captured = {}
    real = module.pgo_solve

    def spy(g, **kw):
        captured["g"] = g
        return real(g, **kw)

    monkeypatch.setattr(module, "pgo_solve", spy)
    return captured


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    try:
        rig = jax_default_rig(image_size=768)
        poses = _poses()
        images = jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses)
        luts = build_frontend_luts(rig, FE)
        obs = jax.jit(jax.vmap(lambda im: extract_observations(rig, luts, FE, im)))(images)
        key = jax.random.PRNGKey(2)
        state = jbp.init_ba_state(CFG, key, T0=poses[0])
        ref, motion, gap = _jax_replay(rig, state, obs)
        kf_ref = np.nonzero(np.asarray(ref.is_keyframe))[0]
        jax_graph = _spy(mp, jlc)   # traced under jit: its node count is static
        T_ref, n_ref = jlc.pgo_refine_trajectory(rig, CFG, obs, ref.vo.T_world, kf_idx=kf_ref,
                                                 **LEG)

        t_rig = rig_from_numpy(rig, "cpu")
        t_cfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(CFG))
        t_obs = observations_from_numpy(obs, "cpu")
        match_cuda.reset_launches()
        schur_cuda.reset_launches()
        _, got = tbp.run_replay_ba(t_rig, t_cfg, ba_state_from_numpy(state, torch.Generator(),
                                                                     "cpu"),
                                   t_obs, _reference_draws(key))
        kf_got = np.nonzero(got.is_keyframe.numpy())[0]
        port_graph = _spy(mp, tlc)
        T_got, n_got = tlc.pgo_refine_trajectory(t_rig, t_cfg, t_obs, got.vo.T_world,
                                                 kf_idx=kf_got, gumbels=_pair_draws(), **LEG)
        launches = (match_cuda.launches, schur_cuda.launches)
    finally:
        mp.undo()
    gt = np.asarray(poses)[1:, :3, 3]
    return dict(ref=ref, got=got, kf_ref=kf_ref, kf_got=kf_got, motion=np.asarray(motion),
                gap=np.asarray(gap), T_ref=np.asarray(T_ref), n_ref=int(n_ref), T_got=T_got,
                n_got=int(n_got), jax_nodes=jax_graph["g"].X.shape[0], port_g=port_graph["g"],
                gt=gt, launches=launches,
                ate_ref=float(jax_ate(T_ref[1:, :3, 3], jnp.asarray(gt))[0]),
                ate_got=float(ate_rmse(T_got[1:, :3, 3], torch.tensor(gt))[0]))


def test_keyframe_flags_equal(run):
    ref_flags = np.asarray(run["ref"].is_keyframe)
    thr = np.array([CFG.kf_trans_thresh, CFG.kf_rot_thresh])
    decided = [f for f in range(1, F) if CFG.kf_min_gap <= run["gap"][f] < CFG.kf_max_gap]
    margin = {f: float(np.abs(run["motion"][f] - thr).min()) for f in decided}
    closest = min(margin, key=margin.get)
    print(f"keyframes: JAX {run['kf_ref'].tolist()} port {run['kf_got'].tolist()}; "
          f"closest motion-decided frame {closest}: {margin[closest]:.3e} from a threshold "
          f"(translation {run['motion'][closest, 0]:.6f} m, rotation "
          f"{run['motion'][closest, 1]:.6f} rad)")
    for f in decided:
        if margin[f] < F32_STEP:
            print(f"frame {f}: motion {run['motion'][f].tolist()} within {margin[f]:.3e} of a "
                  f"threshold: its flag is decided by rounding")
    np.testing.assert_array_equal(run["got"].is_keyframe.numpy(), ref_flags)
    assert not np.array_equal(run["kf_ref"], jlc.keyframe_indices(F, STRIDE)), run["kf_ref"]


def test_pgo_node_set_equal(run):
    """Both pose graphs have the scan's keyframes as nodes: the port's at
    the poses its replay gave them, the reference's in number."""
    g, kf = run["port_g"], run["kf_ref"]
    assert run["jax_nodes"] == len(kf) and g.X.shape[0] == len(kf)
    np.testing.assert_array_equal(run["kf_got"], kf)
    torch.testing.assert_close(g.X, mat_inv(run["got"].vo.T_world[torch.tensor(kf)]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.X.numpy(), np.linalg.inv(np.asarray(run["ref"].vo.T_world)[kf]),
                               rtol=0, atol=1e-3)


def test_n_loops_equal(run):
    assert run["n_got"] == run["n_ref"] and run["n_ref"] >= 1, (run["n_got"], run["n_ref"])


def test_pose_ok_equal(run):
    np.testing.assert_array_equal(run["got"].vo.pose_ok.numpy(), np.asarray(run["ref"].vo.pose_ok))


def test_positions_before_the_leg_match(run):
    d = np.abs(run["got"].vo.T_world.numpy()[:, :3, 3]
               - np.asarray(run["ref"].vo.T_world)[:, :3, 3]).max()
    assert d < 1e-3, d


def test_ate_after_the_leg_matches(run):
    print(f"ATE after the leg: port {run['ate_got']} JAX {run['ate_ref']}; "
          f"n_loops {run['n_got']}")
    assert abs(run["ate_got"] - run["ate_ref"]) < 1e-3, (run["ate_got"], run["ate_ref"])


def test_correction_is_constant_within_each_segment(run):
    """Every frame moves rigidly with its governing keyframe."""
    gov = tlc.governing_map(F, run["kf_got"])
    corr = (run["T_got"] @ mat_inv(run["got"].vo.T_world)).numpy()
    for k in range(len(run["kf_got"])):
        seg = corr[gov == k]
        assert np.abs(seg - seg[0]).max() < 1e-5, k


def test_cpu_run_never_launches_a_kernel(run):
    assert run["launches"] == (0, 0)
