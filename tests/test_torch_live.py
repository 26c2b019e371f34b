"""The port's live VO (`sosvo_torch.vo.live`) over its `.sosq` reader.

Frames: the command line's room rendered by the port along
`make_trajectory(8, radius=0.4)` through `default_rig(384)`, with the JAX
live tests' frontend and RANSAC settings at 384 px (K=384, a 96x768
panorama) and window BA (W=4, L=384, 3 iterations, a keyframe every 3
frames). Held:
  * `live_vo` and `live_vo_ba` over the port's `SosqReader` equal the
    port's `run_replay_images` / `run_replay_images_ba` on the same frames,
    generator and first pose, bit for bit in every output;
  * `live_vo_ba` with the JAX package's draws (`key`) against JAX
    `live_vo_ba` fed the same frames from a plain list, under
    tests/test_torch_image_pipeline.py's rule for the BA replay: pose_ok
    and keyframes equal, positions and ATE within 1e-3 m, stereo and
    temporal match counts within 2;
  * the stride schedule keeps (n + 2) // 3 keyframes (tests/test_live.py);
  * each output is yielded after the next frame was taken from the
    source, and on CPU tensors no kernel launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.live import live_vo_ba as jax_live_vo_ba
from sosvo_torch.convert import rig_from_numpy
from sosvo_torch.data.native_loader import SosqReader, write_sosq
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend.image_frontend import build_frontend_luts
from sosvo_torch.kernels import match_cuda, schur_cuda
from sosvo_torch.synth.render import RoomScene, render_sequence
from sosvo_torch.synth.scene import make_trajectory
from sosvo_torch.tools.reference_draws import prng_key
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import image_pipeline as tip
from sosvo_torch.vo.ba_pipeline import init_ba_state
from sosvo_torch.vo.live import live_vo, live_vo_ba
from sosvo_torch.vo.state import init_track_state

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
CFG = PipelineConfig(
    frontend=FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16),
    ransac=RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8),
    ba=BAConfig(window=4, max_landmarks=384, iters=3, use_pallas_schur=False),
    keyframe_every=3)
N = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rig = jax_default_rig(image_size=384)
    t_rig = rig_from_numpy(rig, "cpu")
    poses = make_trajectory(N, radius=0.4, device="cpu")
    images = render_sequence(t_rig, poses, ROOM).numpy()
    path = tmp_path_factory.mktemp("live") / "frames.sosq"
    write_sosq(path, images)
    cfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(CFG))
    return dict(rig=rig, poses=np.asarray(poses), images=images, path=path, t_rig=t_rig,
                cfg=cfg, luts=build_frontend_luts(t_rig, cfg.frontend))


def _stream(world, live_fn, **kw):
    with SosqReader(world["path"], readahead=2) as r:
        frames = (r.next() for _ in range(len(r)))
        got = list(live_fn(world["t_rig"], world["cfg"], frames, luts=world["luts"],
                          device="cpu", **kw))
    assert [i for i, _ in got] == list(range(N))
    outs = [o for _, o in got]
    return type(outs[0])(*(torch.stack(x) if isinstance(x[0], torch.Tensor)
                           else type(x[0])(*(torch.stack(y) for y in zip(*x)))
                           for x in zip(*outs)))


def _equal(a, b) -> None:
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def live_runs(world):
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    T0 = torch.tensor(world["poses"][0])
    runs = {"f2f": _stream(world, live_vo, generator=torch.Generator().manual_seed(3)),
            "ba": _stream(world, live_vo_ba, generator=torch.Generator().manual_seed(3), T0=T0),
            "ba_jax_draws": _stream(world, live_vo_ba, key=prng_key(1), T0=T0)}
    runs["launches"] = (match_cuda.launches, schur_cuda.launches)
    return runs


def test_live_vo_equals_replay(world, live_runs):
    state = init_track_state(CFG.frontend.max_features, torch.Generator().manual_seed(3),
                             device="cpu")
    _, ref = tip.run_replay_images(world["t_rig"], world["cfg"], state,
                                   torch.tensor(world["images"]), luts=world["luts"])
    _equal(live_runs["f2f"], ref)
    assert ref.pose_ok[1:].all()


def test_live_vo_ba_equals_replay_ba(world, live_runs):
    state = init_ba_state(world["cfg"], torch.Generator().manual_seed(3),
                          T0=torch.tensor(world["poses"][0]), device="cpu")
    _, ref = tip.run_replay_images_ba(world["t_rig"], world["cfg"], state,
                                      torch.tensor(world["images"]), luts=world["luts"])
    _equal(live_runs["ba"], ref)


def test_live_vo_ba_matches_jax_live(world, live_runs):
    got = live_runs["ba_jax_draws"]
    ref = {}
    for idx, out in jax_live_vo_ba(world["rig"], CFG, list(world["images"]),
                                   key=jax.random.PRNGKey(1), T0=world["poses"][0]):
        ref[idx] = jax.tree.map(np.asarray, out)
    assert sorted(ref) == list(range(N))
    ref_kf = np.array([ref[i].is_keyframe for i in range(N)])
    ref_ok = np.array([ref[i].vo.pose_ok for i in range(N)])
    np.testing.assert_array_equal(got.is_keyframe.numpy(), ref_kf)
    np.testing.assert_array_equal(got.vo.pose_ok.numpy(), ref_ok)
    assert ref_ok[1:].all()
    for name in ("n_stereo", "n_temporal"):
        ref_n = np.array([getattr(ref[i].vo, name) for i in range(N)]).astype(int)
        assert np.abs(getattr(got.vo, name).numpy().astype(int) - ref_n).max() <= 2, name
    pos_ref = np.stack([ref[i].vo.T_world[:3, 3] for i in range(N)])
    assert np.abs(got.vo.T_world.numpy()[:, :3, 3] - pos_ref).max() < 1e-3
    gt = world["poses"][1:, :3, 3]
    ate_ref = float(jax_ate(jnp.asarray(pos_ref[1:]), jnp.asarray(gt))[0])
    ate_got = float(ate_rmse(got.vo.T_world[1:, :3, 3], torch.tensor(gt))[0])
    print(f"ATE port {ate_got} reference {ate_ref}")
    assert abs(ate_got - ate_ref) < 1e-3


def test_stride_keyframes(live_runs):
    for run in ("ba", "ba_jax_draws"):
        assert int(live_runs[run].is_keyframe.sum()) == (N + 2) // 3


def test_outputs_arrive_one_frame_late(world):
    taken = []

    def frames():
        for i, im in enumerate(world["images"][:4]):
            taken.append(i)
            yield im

    seen = []
    for idx, _ in live_vo(world["t_rig"], world["cfg"], frames(), luts=world["luts"],
                          device="cpu", on_frame=lambda i, o: seen.append(i)):
        assert taken[-1] == min(idx + 1, 3)  # frame idx + 1 was taken before idx came out
        assert seen[-1] == idx
    assert seen == [0, 1, 2, 3]


def test_cpu_live_runs_launch_no_kernel(live_runs):
    assert live_runs["launches"] == (0, 0)


def test_generator_and_key_are_exclusive(world):
    with pytest.raises(ValueError, match="not both"):
        next(live_vo(world["t_rig"], world["cfg"], iter(world["images"]),
                     generator=torch.Generator(), key=prng_key(0), device="cpu"))
