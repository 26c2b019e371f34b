#!/usr/bin/env python
"""f32 precision of the SE(3) log map and the pose-graph solve, in the JAX
package and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/pgo_precision.py [--seed 0] [--no-leg]

Prints one JSON line per item:
  1. `coef`: V^-1's W^2 coefficient of `se3_log`, (1 - (t/2) cot(t/2)) / t^2,
     in f32 against float64 over 4000 angles t in [1e-4, pi): the
     reference's closed form (1 - A / (2B)) / t^2 from its own `_sinc_coeffs`
     (its series below t^2 = 1e-6), and the port's `_vinv_coef`.
  2. `random_graph`: on tests/test_torch_pose_graph.py's random graphs
     (seeds 0, 1), the weighted edge residuals and their endpoint Jacobians
     of each package in f32 against the reference's in float64.
  3. `leg_graph` (unless --no-leg): the JAX package's c3 loop-closure graph
     for one seed, built as `sosvo/vo/loop_closure.py:pgo_refine_trajectory`
     builds it after the BA replay that scripts/ref_c3_pgo_ate.py runs
     (configs/c3_host_pgo.json in observation mode, 160 candidates, 300
     inliers): each package's translation-residual error in f32 against
     float64, then `pgo_solve` (DCS 0.1, 10 iterations; dense and cg with 32
     and 64 iterations) in both packages in f32 and float64: each solve's
     distance from the reference's float64 dense solve, its costs, accepted
     steps and the trajectory's ATE after PGO.
"""

import sys as _sys
from pathlib import Path as _Path
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import argparse
import dataclasses
import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch

from sosvo.backend import pose_graph as jpg
from sosvo.eval.ate import ate_rmse
from sosvo.geom import lie as jlie
from sosvo.sensor.rig import default_rig
from sosvo.synth.scene import make_scene, observe_sequence
from sosvo.utils.config import load_pipeline_config
from sosvo.vo import loop_closure as jlc
from sosvo.vo.ba_pipeline import init_ba_state, run_replay_ba
from sosvo_torch.backend import pose_graph as tpg
from sosvo_torch.convert import pose_graph_from_numpy
from sosvo_torch.geom import lie as tlie

PRESET = _Path(__file__).resolve().parents[1] / "configs" / "c3_host_pgo.json"
KW = dict(iters=10, robust="dcs", robust_delta=0.1)


def _float64(g):
    return g._replace(**{f: jnp.asarray(np.asarray(getattr(g, f)), jnp.float64)
                         for f in ("X", "T_meas", "w")})


def coef_errors() -> dict:
    theta = np.logspace(-4, np.log10(np.pi - 1e-3), 4000)
    half = theta / 2
    exact = (1 - half * np.cos(half) / np.sin(half)) / theta ** 2
    t2 = jnp.asarray(theta ** 2, jnp.float32)
    a, b, _ = jlie._sinc_coeffs(t2)
    ref = np.asarray(jnp.where(t2 < 1e-6, 1 / 12 + t2 / 720, (1 - a / (2 * b)) / t2), np.float64)
    port = tlie._vinv_coef(torch.tensor(theta ** 2, dtype=torch.float32)).double().numpy()
    out = {}
    for name, v in (("reference_f32", ref), ("port_f32", port)):
        rel = np.abs(v - exact) / exact
        out[name] = {"max_rel_err": float(rel.max()), "at_rad": float(theta[rel.argmax()])}
    return out


def edge_term_errors(g) -> dict:
    """Each package's f32 residuals and Jacobians against the reference's
    float64 ones on JAX graph `g`."""
    with jax.enable_x64(True):
        exact = [np.asarray(x) for x in jax.jit(jpg._edge_terms)(_float64(g))]
    ref = [np.asarray(x, np.float64) for x in jax.jit(jpg._edge_terms)(g)]
    port = [x.double().numpy() for x in tpg._edge_terms(pose_graph_from_numpy(g, "cpu"))]
    return {pkg: {n: float(np.abs(a - e).max()) for n, a, e in zip(("r", "J_i", "J_j"), got, exact)}
            for pkg, got in (("reference_f32", ref), ("port_f32", port))}


def leg_graph(seed: int):
    """(the JAX package's c3 pose graph of the BA replay of `seed`, the
    replayed trajectory, its keyframes, the ground-truth positions)."""
    cfg = dataclasses.replace(load_pipeline_config(PRESET), mode="observations")
    run = json.loads(PRESET.read_text())["run"]
    rig = default_rig()
    scene = make_scene(jax.random.PRNGKey(seed), n_frames=run["n_frames"],
                       n_landmarks=run["n_landmarks"])
    obs = observe_sequence(rig, scene, cfg.frontend.max_features, jax.random.PRNGKey(seed + 1),
                           pixel_noise=0.3, desc_flip_prob=0.02)
    state = init_ba_state(cfg, jax.random.PRNGKey(seed + 2), T0=scene.poses[0])
    _, outs = jax.jit(lambda s, o: run_replay_ba(rig, cfg, s, o))(state, obs)
    T = outs.vo.T_world
    kf = np.nonzero(np.asarray(outs.is_keyframe))[0]
    X = jax.vmap(jlie.mat_inv)(T[kf])
    n = len(kf)
    oi, oj = jnp.arange(1, n, dtype=jnp.int32), jnp.arange(0, n - 1, dtype=jnp.int32)
    T_odom = jnp.einsum("nij,njk->nik", X[oi], jax.vmap(jlie.mat_inv)(X[oj]))
    obs_kf = jax.tree.map(lambda x: x[jnp.asarray(kf)], obs)
    li, lj, T_loop, w_loop = jax.jit(lambda o: jlc.detect_loops(
        rig, cfg, o, 3, cfg.loop_min_inliers, max_candidates=cfg.loop_candidates))(obs_kf)
    g = jpg.PoseGraph(X=X, node_valid=jnp.ones(n, bool), ei=jnp.concatenate([oi, li]),
                      ej=jnp.concatenate([oj, lj]), T_meas=jnp.concatenate([T_odom, T_loop]),
                      w=jnp.concatenate([jnp.ones(n - 1, jnp.float32), w_loop]))
    return g, np.asarray(T, np.float64), kf, np.asarray(scene.poses[1:, :3, 3])


def leg_report(seed: int) -> dict:
    g, T, kf, gt = leg_graph(seed)
    gov = jlc.governing_map(len(T), kf)

    def ate(X):
        corr = np.linalg.inv(np.asarray(X, np.float64)) @ np.linalg.inv(T[kf])
        return float(ate_rmse(jnp.asarray((corr[gov] @ T)[1:, :3, 3], jnp.float32), gt)[0])

    with jax.enable_x64(True):
        g64 = _float64(g)
        exact_r = np.asarray(jax.vmap(jpg.edge_residual)(g64.X[g64.ei], g64.X[g64.ej], g64.T_meas))
    ref_r = np.asarray(jax.vmap(jpg.edge_residual)(g.X[g.ei], g.X[g.ej], g.T_meas), np.float64)
    tg = pose_graph_from_numpy(g, "cpu")
    port_r = tpg.edge_residual(tg.X[tg.ei], tg.X[tg.ej], tg.T_meas).double().numpy()
    solves = {}
    for solver, cg_iters in (("dense", 32), ("cg", 32), ("cg", 64)):
        name = solver if solver == "dense" else f"cg{cg_iters}"
        kw = dict(KW, solver=solver, cg_iters=cg_iters)
        with jax.enable_x64(True):
            solves[f"reference_float64_{name}"] = jax.jit(lambda gg: jpg.pgo_solve(gg, **kw))(g64)
        solves[f"reference_f32_{name}"] = jax.jit(lambda gg: jpg.pgo_solve(gg, **kw))(g)
        solves[f"port_f32_{name}"] = tpg.pgo_solve(tg, **kw)
        solves[f"port_float64_{name}"] = tpg.pgo_solve(
            tg._replace(X=tg.X.double(), T_meas=tg.T_meas.double(), w=tg.w.double()), **kw)
    exact_X = np.asarray(solves["reference_float64_dense"].X)
    err = {pkg: np.abs(r - exact_r)[:, 3:] for pkg, r in (("reference_f32", ref_r),
                                                         ("port_f32", port_r))}
    worst = np.unravel_index(err["reference_f32"].argmax(), err["reference_f32"].shape)
    e, c = int(worst[0]), 3 + int(worst[1])
    out = {"nodes": int(g.X.shape[0]), "edges": int(g.w.shape[0]), "ate_before_m": ate(g.X),
           "translation_residual_err": {pkg: float(v.max()) for pkg, v in err.items()},
           "worst_edge": {"edge": e, "component": c,
                          "rotation_rad": float(np.linalg.norm(exact_r[e, :3])),
                          "float64": float(exact_r[e, c]), "reference_f32": float(ref_r[e, c]),
                          "port_f32": float(port_r[e, c])}}
    for name, r in solves.items():
        X = r.X.double().numpy() if isinstance(r.X, torch.Tensor) else np.asarray(r.X, np.float64)
        acc = r.accepted.int().tolist() if isinstance(r.accepted, torch.Tensor) else \
            np.asarray(r.accepted).astype(int).tolist()
        out[name] = {"max_abs_from_reference_float64_dense": float(np.abs(X - exact_X).max()),
                     "cost0": float(r.cost0), "cost": float(r.cost), "accepted": acc,
                     "ate_after_m": ate(X)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-leg", action="store_true", help="skip the c3 leg graph (about a minute)")
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps({"item": "coef", **coef_errors()}), flush=True)
    from tests.test_torch_pose_graph import _random_graph
    for s in (0, 1):
        print(json.dumps({"item": "random_graph", "seed": s, **edge_term_errors(_random_graph(s))}),
              flush=True)
    if not args.no_leg:
        print(json.dumps({"item": "leg_graph", "seed": args.seed, **leg_report(args.seed)}),
              flush=True)


if __name__ == "__main__":
    main()
