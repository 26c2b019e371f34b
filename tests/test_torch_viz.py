"""The plots and viewers (`sosvo_torch.eval.plots`, `viz`, `html_viewer`) and
the command line's `--viz`, on the CPU.

The text artifacts must equal the JAX package's byte for byte on the same
arrays (numpy from a seed): the PLY map, masked and coloured, and the HTML
viewer. The plots must write PNG files. `--viz` writes what the JAX command
line writes (sosvo/cli.py's --viz block) in each mode: `trajectory.png` and
`viewer.html`, in BA mode `map.ply` (the final map's live landmarks) and
`map_3d.png`, in image mode `keypoints.png` and `matches.png`; without
matplotlib it refuses before anything runs and writes no directory.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sosvo.eval import html_viewer as jax_html
from sosvo.eval import viz as jax_viz
from sosvo_torch import cli
from sosvo_torch.eval import html_viewer, plots, viz

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BASE = ["trajectory.png", "viewer.html"]
BA = BASE + ["map.ply", "map_3d.png"]
IMAGES = ["keypoints.png", "matches.png"]


def _trajectory(rng, n=12):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0).astype(np.float32)
    return T


@pytest.mark.parametrize("colors", [None, "float", "uint8"])
def test_save_ply_matches(tmp_path, colors):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    valid = rng.uniform(size=40) > 0.4
    c = None if colors is None else rng.uniform(size=(40, 3))
    if colors == "uint8":
        c = (c * 255).astype(np.uint8)
    n = viz.save_ply(tmp_path / "a.ply", pts, colors=c, valid=valid)
    n_ref = jax_viz.save_ply(tmp_path / "b.ply", pts, colors=c, valid=valid)
    assert n == n_ref == int(valid.sum())
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


@pytest.mark.parametrize("with_map", [False, True])
def test_html_viewer_matches(tmp_path, with_map):
    rng = np.random.default_rng(1)
    T, G = _trajectory(rng), _trajectory(rng)
    kw = {}
    if with_map:
        kw = dict(landmarks=rng.normal(size=(300, 3)).astype(np.float32),
                  lm_valid=rng.uniform(size=300) > 0.5, ate=0.0123456, max_landmarks=100)
    a = html_viewer.export_html_viewer(tmp_path / "a.html", T, traj_gt=G, title="t", **kw)
    b = jax_html.export_html_viewer(tmp_path / "b.html", T, traj_gt=G, title="t", **kw)
    assert a.read_bytes() == b.read_bytes()
    assert "<canvas" in a.read_text() and "http" not in a.read_text().split("<script>")[1]


@pytest.mark.parametrize("plot", ["trajectories", "frame_stats", "map_3d", "keypoints",
                                  "matches"])
def test_plots_write_png(tmp_path, plot):
    rng = np.random.default_rng(2)
    T = _trajectory(rng)
    img = rng.uniform(size=(64, 64)).astype(np.float32)
    uv = rng.uniform(4, 60, size=(20, 2)).astype(np.float32)
    ok = rng.uniform(size=20) > 0.3
    out = tmp_path / f"{plot}.png"
    if plot == "trajectories":
        plots.plot_trajectories(T, T, out)
    elif plot == "frame_stats":
        rows = [{"frame": i, "n_stereo": 100, "n_temporal": 80, "n_inliers": 60}
                for i in range(10)]
        plots.plot_frame_stats(rows, out)
    elif plot == "map_3d":
        viz.plot_map_3d(out, T, rng.normal(size=(50, 3)), np.ones(50, bool), traj_gt=T)
    elif plot == "keypoints":
        viz.keypoint_overlay(out, img, uv, ok, uv + 2.0, ok)
    else:
        viz.match_overlay(out, img, uv, uv + 3.0, ok)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 1000


def _c1_tiny(tmp_path) -> str:
    cfg = json.loads((ROOT / "configs/c1_cpu_smoke.json").read_text())
    cfg["run"]["n_frames"] = 6
    cfg["pipeline"]["frontend"]["max_features"] = 128
    cfg["pipeline"]["ransac"]["n_hyps"] = 128
    p = tmp_path / "c1_tiny.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def _artifacts(out: Path) -> set[str]:
    return {p.name for p in out.iterdir()} - {"ckpt", "frames.jsonl", "report.json"}


@pytest.mark.parametrize("mode", ["f2f", "ba"])
def test_cli_viz_observation_mode(tmp_path, mode, capsys):
    """The JAX command line's artifacts for the mode; in BA mode the PLY
    holds the final map's live landmarks, as save_ply writes them."""
    out = tmp_path / "run"
    assert cli.main(["--config", _c1_tiny(tmp_path), "--device", "cpu", "--mode", mode,
                     "--viz", "--out", str(out)]) == 0
    want = BA if mode == "ba" else BASE
    assert _artifacts(out) == set(want)
    assert f"viz artifacts: {', '.join(want)}" in capsys.readouterr().out
    for f in want:
        assert (out / f).stat().st_size > 200, f
    if mode == "ba":
        head = (out / "map.ply").read_text().splitlines()
        n = int(head[2].split()[-1])
        assert head[0] == "ply" and n > 0 and len(head) == head.index("end_header") + 1 + n
    html = (out / "viewer.html").read_text()
    data = json.loads(html.split("const DATA = ")[1].split(";\n")[0])
    assert len(data["traj"]) == len(data["gt"]) == 6 and data["ate"] is not None


def test_cli_viz_image_mode(tmp_path):
    """A staged capture (384 px, 6 frames, through the frontend): the
    overlays on frame 0 too."""
    from sosvo_torch.data.sequence import save_sequence
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_trajectory
    from sosvo_torch.tools.workload import render_frames

    rig = default_rig(image_size=384, device="cpu")
    save_sequence(tmp_path / "seq.npz", images=render_frames(rig, 6, range(6), "cpu").numpy(),
                  poses=make_trajectory(6, radius=0.4, device="cpu").numpy())
    cfg = {"run": {}, "pipeline": {
        "frontend": {"max_features": 384, "pano_height": 96, "pano_width": 768,
                     "descriptor_patch": 16},
        "ransac": {"rigid_angle_threshold": 0.02, "essential_threshold": 0.01,
                   "min_inliers": 8}}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    out = tmp_path / "run"
    assert cli.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu", "--mode", "ba",
                     "--sequence", str(tmp_path / "seq.npz"), "--viz", "--out", str(out)]) == 0
    assert _artifacts(out) == set(BA + IMAGES)
    for f in IMAGES:
        assert (out / f).read_bytes()[:4] == b"\x89PNG"


def test_cli_viz_refuses_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(["--config", _c1_tiny(tmp_path), "--device", "cpu", "--mode", "ba", "--viz",
                  "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
