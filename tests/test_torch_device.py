"""The port's entry points run on the card unless the caller asks for the CPU.

With `torch.cuda.is_available` patched to False, every entry point that
makes tensors raises instead of dropping to the CPU; with `device="cpu"`
it runs here.
"""

import numpy as np
import pytest
import torch

from sosvo_torch import convert
from sosvo_torch.backend.pose_graph import PoseGraph, pgo_solve
from sosvo_torch.geom.lie import se3_exp
from sosvo_torch.sensor.model import ViewParams
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth import scene
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.utils.device import default_device
from sosvo_torch.vo.ba_pipeline import init_ba_state
from sosvo_torch.vo.keyframes import init_map_state
from sosvo_torch.vo.loop_closure import pgo_refine_trajectory
from sosvo_torch.vo.state import init_track_state

def _pano_geometry():
    """A 2x3 `PanoGeometry`-shaped object of numpy arrays (quad index 0)."""
    z = np.zeros((2, 3), np.float32)
    return type("Geom", (), dict(height=2, width=3, min_elevation=-0.5, max_elevation=0.2,
                                 lut_uv=np.zeros((2, 3, 2), np.float32), valid=z > -1,
                                 idx_r0=np.zeros((2, 3), np.int32), fu=z, fv=z))()


ENTRY_POINTS = {
    "default_rig": lambda **d: default_rig(**d),
    "ViewParams.create": lambda **d: ViewParams.create(0.9, 1, 1, 0, 0, -0.5, 0.2, **d),
    "make_landmarks": lambda **d: scene.make_landmarks(torch.Generator(), 4, **d),
    "make_trajectory": lambda **d: scene.make_trajectory(3, **d),
    "landmark_descriptors": lambda **d: scene.landmark_descriptors(torch.Generator(), 4, **d),
    "descriptor_flips": lambda **d: scene.descriptor_flips(torch.Generator(), (4, 8), 0.1, **d),
    "make_scene": lambda **d: scene.make_scene(torch.Generator(), 2, 16, **d),
    "draw_observation": lambda **d: scene.draw_observation(torch.Generator(), 8, 0.02, **d),
    "init_track_state": lambda **d: init_track_state(8, torch.Generator(), **d),
    "init_map_state": lambda **d: init_map_state(3, 16, **d),
    "init_ba_state": lambda **d: init_ba_state(PipelineConfig(), torch.Generator(), **d),
    "desc_to_torch": lambda **d: convert.desc_to_torch(np.zeros((2, 8), np.uint32), **d),
    "ba_window_from_numpy": lambda **d: convert.ba_window_from_numpy(
        type("Win", (), dict(X=np.eye(4)[None], landmarks=np.zeros((1, 3)),
                             rays=np.zeros((1, 1, 2, 3)), weights=np.zeros((1, 1, 2)),
                             viewpoints=np.zeros((2, 3))))(), **d),
    "images_from_numpy": lambda **d: convert.images_from_numpy(np.zeros((1, 4, 4), np.float32), **d),
    "keypoints_from_numpy": lambda **d: convert.keypoints_from_numpy(
        type("Kps", (), dict(rows=np.zeros(2), cols=np.zeros(2), response=np.zeros(2),
                             valid=np.ones(2, bool)))(), **d),
    "pano_geometry_from_numpy": lambda **d: convert.pano_geometry_from_numpy(
        _pano_geometry(), image_height=4, image_width=4, **d),
    "frontend_luts_from_numpy": lambda **d: convert.frontend_luts_from_numpy(
        type("Luts", (), dict(top=_pano_geometry(), bottom=_pano_geometry()))(),
        image_height=4, image_width=4, **d),
    "pose_graph_from_numpy": lambda **d: convert.pose_graph_from_numpy(
        type("Graph", (), dict(X=np.eye(4)[None].repeat(2, 0), node_valid=np.ones(2, bool),
                               ei=np.ones(1, np.int32), ej=np.zeros(1, np.int32),
                               T_meas=np.eye(4)[None], w=np.ones(1)))(), **d),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    out = ENTRY_POINTS[name](device="cpu")
    leaves = [x for x in torch.utils._pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_single_rank_defaults_to_the_card(monkeypatch):
    """`dist.mesh.single`, the one-process ranks a mesh is made over, takes
    the card unless asked for the CPU, as `init_process_group` does."""
    from sosvo_torch.dist import mesh

    assert mesh.single("cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh.single()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.single().device == torch.device("cuda", 0)


def test_default_device_is_cuda_when_a_card_is_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


def _chain_graph(n: int = 4) -> PoseGraph:
    xi = torch.zeros((n, 6))
    xi[:, 3] = torch.arange(n, dtype=torch.float32) * 0.1
    X = se3_exp(xi)
    ei, ej = torch.arange(1, n), torch.arange(0, n - 1)
    return PoseGraph(X=se3_exp(0.01 * torch.ones((n, 6))) @ X,
                     node_valid=torch.ones(n, dtype=torch.bool), ei=ei, ej=ej,
                     T_meas=X[ei] @ torch.linalg.inv(X[ej]), w=torch.ones(n - 1))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pgo_solve_follows_its_tensors(solver, monkeypatch):
    """No card and no device argument: pgo_solve runs where its graph is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = pgo_solve(_chain_graph(), iters=3, solver=solver, robust="dcs")
    assert all(x.device.type == "cpu" for x in res)
    assert bool(torch.isfinite(res.X).all())


def test_pgo_refine_trajectory_follows_its_tensors(monkeypatch):
    """A tiny CPU replay closes its loops on the CPU with no card: the
    default RANSAC generator is made on the tensors' device."""
    rig = default_rig(device="cpu")
    sc = scene.make_scene(torch.Generator().manual_seed(0), 16, 512, device="cpu")
    obs = scene.observe_sequence(rig, sc, 64, torch.Generator().manual_seed(1), 0.3, 0.02)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T, n_loops = pgo_refine_trajectory(rig, PipelineConfig(), obs, sc.poses, min_gap=2,
                                       min_inliers=8, iters=2)
    assert T.device.type == "cpu" and n_loops.device.type == "cpu"
    assert T.shape == sc.poses.shape and bool(torch.isfinite(T).all())


def test_image_frontend_follows_its_tensors(monkeypatch):
    """No card and no device argument: the renderer, the LUTs, extraction
    and the image replays run where their inputs are."""
    from sosvo_torch.frontend.image_frontend import build_frontend_luts, extract_observations
    from sosvo_torch.synth.render import RoomScene, render_sequence
    from sosvo_torch.utils.config import BAConfig, FrontendConfig
    from sosvo_torch.vo.image_pipeline import run_replay_images, run_replay_images_ba

    rig = default_rig(image_size=192, device="cpu")
    poses = scene.make_trajectory(2, radius=0.4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = render_sequence(rig, poses, RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6,
                                                   texture_scale=2.0))
    fe = FrontendConfig(max_features=64, pano_height=32, pano_width=256, descriptor_patch=16)
    cfg = PipelineConfig(frontend=fe, ba=BAConfig(max_landmarks=64, max_new=32))
    luts = build_frontend_luts(rig, fe)
    obs = extract_observations(rig, luts, fe, images[0])
    _, outs = run_replay_images(rig, cfg, init_track_state(64, torch.Generator(), T0=poses[0],
                                                           device="cpu"), images, luts)
    _, ba_outs = run_replay_images_ba(rig, cfg, init_ba_state(cfg, torch.Generator(), T0=poses[0],
                                                              device="cpu"), images, luts)
    leaves = [images, *luts.top[4:], *obs, *outs, *ba_outs.vo]
    assert all(x.device.type == "cpu" for x in leaves)
