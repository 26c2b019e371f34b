"""The port's sequence files (`sosvo_torch.data.sequence`) and `quat_to_mat`
against the JAX package's (`sosvo.data.sequence`, `sosvo.geom.lie`).

Held: `quat_to_mat` within 1e-7 of the reference on random unit
quaternions with both signs of w; `.npz` bundles written by either package
load in the other with equal arrays; TUM files written by either package
are equal byte for byte, on a VO trajectory and on random rotations, and
each package loads the other's file to poses within 1e-7 of its own load.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.data import sequence as jseq
from sosvo.geom.lie import quat_to_mat as jax_quat_to_mat
from sosvo.synth.scene import make_trajectory
from sosvo_torch.data import sequence as tseq
from sosvo_torch.geom.lie import quat_to_mat

PACKAGES = {"jax": jseq, "torch": tseq}


def _unit_quats(n: int, seed: int = 0) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[::2, 0] = -np.abs(q[::2, 0])   # both signs of w
    q[1::2, 0] = np.abs(q[1::2, 0])
    return q.astype(np.float32)


def _random_poses(n: int, seed: int = 1) -> np.ndarray:
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(jax_quat_to_mat(jnp.asarray(_unit_quats(n, seed))))
    T[:, :3, 3] = np.random.default_rng(seed).uniform(-5, 5, (n, 3))
    return T


def test_quat_to_mat_matches_reference():
    q = _unit_quats(4096)
    ref = np.asarray(jax_quat_to_mat(jnp.asarray(q)))
    got = quat_to_mat(torch.tensor(q)).numpy()
    assert got.dtype == np.float32 and got.shape == (4096, 3, 3)
    assert np.abs(got - ref).max() <= 1e-7


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("parts", ["images_poses", "images", "poses"])
def test_npz_bundles_cross_load(tmp_path, writer, reader, parts):
    rng = np.random.default_rng(2)
    images = rng.random((5, 24, 24)).astype(np.float32) if "images" in parts else None
    poses = np.asarray(make_trajectory(5)) if "poses" in parts else None
    ts = np.linspace(0.0, 0.4, 5)
    p = tmp_path / "seq.npz"
    PACKAGES[writer].save_sequence(p, images=images, poses=poses, timestamps=ts)
    got = PACKAGES[reader].load_sequence(p)
    ref = PACKAGES[writer].load_sequence(p)
    for name in ("images", "poses", "timestamps"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    if images is not None:
        assert np.array_equal(got.images, images)
    assert np.array_equal(got.timestamps, ts)


@pytest.mark.parametrize("poses", ["trajectory", "random"])
def test_tum_files_byte_equal(tmp_path, poses):
    T = np.asarray(make_trajectory(60, radius=0.4)) if poses == "trajectory" else _random_poses(500)
    ts = np.arange(T.shape[0]) * 0.05
    files = {}
    for name, pkg in PACKAGES.items():
        files[name] = tmp_path / f"{name}.txt"
        pkg.save_tum_trajectory(files[name], T, timestamps=ts)
    assert files["jax"].read_text() == files["torch"].read_text()
    for path in files.values():  # each package's file through both loaders
        ts_j, T_j = jseq.load_tum_trajectory(path)
        ts_t, T_t = tseq.load_tum_trajectory(path)
        assert T_t.dtype == np.float32 and T_t.shape == T.shape
        assert np.array_equal(ts_t, ts_j)
        assert np.abs(T_t - T_j).max() <= 1e-7
        assert np.abs(T_t - T).max() < 1e-5  # six decimals in the file


def test_tum_loader_skips_comments(tmp_path):
    p = tmp_path / "gt.txt"
    p.write_text("# timestamp tx ty tz qx qy qz qw\n\n0.5 1 2 3 0 0 0 1\n")
    ts, T = tseq.load_tum_trajectory(p)
    assert ts.tolist() == [0.5] and np.array_equal(T[0, :3, 3], [1, 2, 3])
    assert np.array_equal(T[0, :3, :3], np.eye(3, dtype=np.float32))
