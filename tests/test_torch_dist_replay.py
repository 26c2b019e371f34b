"""The landmark-sharded BA replay, config c5's composition
(`sosvo_torch.dist.replay_dist`), against the JAX package's and the port's
single-device replay.

tests/test_replay_dist.py's configuration (K=128, H=128, a W=3 window over
L=256 landmark slots, 3 iterations, a keyframe every 3 frames, 10 frames),
the JAX package's observations and its random draws
(`tools/reference_draws.py`, from the state's PRNGKey(2)). The port's 8
ranks (gloo, CPU) replay with every window solve sharded, as the JAX
package's replay does on `model_mesh(8)`:
  * against the JAX sharded replay: discrete outputs equal (keyframes,
    landmark counts, pose_ok, stereo and temporal counts; inliers within
    +-2), positions within 1e-3 m and BA costs within 1e-3 relative
    (tests/test_torch_ba_pipeline.py's bounds);
  * against the port's single-device replay: poses within 1e-3
    (tests/test_replay_dist.py's bound), discrete outputs equal;
  * every rank's outputs bit-equal; BA ran; every window solve's
    collectives are those of tests/test_torch_dist_ba.py, and the map's
    landmarks are gathered once per solve.
"""

import dataclasses

import jax
import numpy as np
import torch

from sosvo.dist.mesh import model_mesh
from sosvo.dist.replay_dist import run_replay_ba_sharded as jax_replay_sharded
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.ba_pipeline import init_ba_state
from sosvo_torch.convert import ba_state_from_numpy, observations_from_numpy, rig_from_numpy
from sosvo_torch.dist.launch import launch
from sosvo_torch.tools.reference_draws import replay_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo.ba_pipeline import run_replay_ba

F, K, L, H = 10, 128, 256, 128


def test_sharded_replay_matches_jax_and_single(devices8):
    rig = default_rig()
    cfg = PipelineConfig(frontend=FrontendConfig(max_features=K), ransac=RansacConfig(n_hyps=H),
                         ba=BAConfig(window=3, max_landmarks=L, iters=3, use_pallas_schur=False),
                         keyframe_every=3)
    scene = make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=2048)
    obs = observe_sequence(rig, scene, K, jax.random.PRNGKey(1), pixel_noise=0.3,
                           desc_flip_prob=0.02)
    s0 = init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
    _, ref = jax.jit(lambda s, o: jax_replay_sharded(model_mesh(8), rig, cfg, s, o))(s0, obs)

    trig, tcfg = rig_from_numpy(rig, "cpu"), tconfig._from_dict(tconfig.PipelineConfig,
                                                                dataclasses.asdict(cfg))
    tobs = observations_from_numpy(obs, "cpu")
    draws = replay_draws(F, H, K, "cpu", seed=2, reloc_slots=L)
    state = ba_state_from_numpy(s0, torch.Generator(), "cpu")
    _, single = run_replay_ba(trig, tcfg, state, tobs, draws)
    outs = launch("tests.torch_dist_ranks:replay_sharded", 8,
                  dict(rig=trig, cfg=tcfg, state=state._replace(
                      track=state.track._replace(generator=None)), obs=tobs, draws=draws),
                  device="cpu", timeout_s=300)
    got, calls = outs[0]

    for name in ("is_keyframe", "n_landmarks"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        assert torch.equal(getattr(got, name), getattr(single, name))
    for name in ("pose_ok", "n_stereo", "n_temporal"):
        np.testing.assert_array_equal(getattr(got.vo, name).numpy(),
                                      np.asarray(getattr(ref.vo, name)))
        assert torch.equal(getattr(got.vo, name), getattr(single.vo, name))
    assert np.abs(got.vo.n_inliers.numpy().astype(int)
                  - np.asarray(ref.vo.n_inliers).astype(int)).max() <= 2
    pos = got.vo.T_world.numpy()[:, :3, 3]
    assert np.abs(pos - np.asarray(ref.vo.T_world)[:, :3, 3]).max() < 1e-3
    np.testing.assert_allclose(got.ba_cost.numpy(), np.asarray(ref.ba_cost), rtol=1e-3,
                               atol=1e-9)
    assert float(torch.max(torch.abs(got.vo.T_world - single.vo.T_world))) < 1e-3
    assert bool(got.is_keyframe.any()) and float(got.ba_cost.max()) > 0.0
    for o, c in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(o, is_leaf=lambda x: isinstance(x, torch.Tensor)),
            jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))))
        assert c == calls
    n_solves = int((got.ba_cost > 0).sum())
    assert calls == {"model.psum": n_solves * (1 + 3 * 3), "model.all_gather": n_solves}
