"""Pose-graph optimisation: `sosvo_torch.backend.pose_graph` against the JAX
package's `sosvo.backend.pose_graph`.

Random graphs made with numpy from a seed (N=12 nodes on a loop trajectory
of radius 1 m: 11 chain edges and 4 loop edges with noisy measurements, one
gross outlier loop edge, drifted initial poses, the last node invalid) go to
both packages as numpy arrays.

Tolerances come from the f32 rounding of the edge residual, measured
against a float64 evaluation of the same graphs. The reference's own f32
`se3_log` takes V^-1's coefficient from a closed form that cancels at small
angles, which leaves it up to 7.8e-6 from float64 in the residual and up to
4.0e-4 in its Jacobians on these graphs; the port's series leaves it within
4.3e-7 of float64 in both. So: the robust kernels on the same squared
norms within 1e-6; residuals within 1e-5 of the reference, the weights and
costs made from them within 1e-4 relative; edge Jacobians
(`torch.func.jacfwd`) within 2e-4 of the reference's `jax.jacfwd` in
float64; H and b within 1e-4 of each one's largest magnitude; two builds
bit-identical (the assembly is a product with one-hot endpoint matrices,
no atomics), and on a graph with edges repeated into one block, in both
directions, H and b within 1e-6 of the reference's scatter-adds done in
float64 on the same edge terms. `pgo_solve`
with the dense and the cg solver under none, huber and dcs: X within 1e-4,
cost0 and cost within 1e-4 relative, and `accepted` equal on every
iteration in which the same solve in float64 still lowers the cost by more
than 1e-4 relative. Later on a candidate's cost and the current one differ
by less than their f32 rounding, and the decisions are rounding
(ROADMAP.md section 3 records the flips). Then the
JAX package's own cases through the port: a drifted chain pulled back onto
the ground truth, an invalid node pinned, and a wrong loop edge that DCS
rejects.

Last, a graph shaped like c3's loop-closure graph, built with the JAX
package's trajectory, exp map and odometry edges: 50 keyframes of a
200-frame trajectory with drifted estimates, 49 odometry edges and 160
loop edges among pairs at least 3 keyframes apart, measured with 0.5 mrad
and 5 mm noise and weighted 1.75-4, so its loop residuals sit at ~1e-3 rad,
where the reference's f32 coefficient is worst. With c3's settings (DCS
0.1, 10 iterations) the port's f32 solves, dense and cg, are held to the
reference's solve in float64 (X within 1e-5, costs within 1e-5 relative,
and nearer to it than the reference's own f32 solve), to each other
within 1e-5, and the port's float64 solve to the reference's within 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.backend import pose_graph as jpg
from sosvo.geom.lie import mat_inv as jmat_inv, se3_exp as jse3_exp
from sosvo.synth.scene import make_trajectory
from sosvo_torch.backend import pose_graph as tpg
from sosvo_torch.convert import pose_graph_from_numpy
from tests.test_pose_graph import N as REF_N, _make_loop_problem

torch.set_num_threads(1)
N = 12
KERNELS = ("none", "huber", "dcs")
DELTA = 0.05
ITERS = 8
COST_RTOL = 1e-4  # f32 rounding of a cost on these graphs (module docstring)


def _random_graph(seed: int):
    """A JAX PoseGraph of numpy-made poses and edges (see module doc)."""
    rng = np.random.default_rng(seed)
    poses = np.asarray(make_trajectory(N, radius=1.0, yaw_per_frame=0.5))
    X_gt = np.asarray(jax.vmap(jmat_inv)(poses))
    loops_i, loops_j = [N - 1, N - 2, N - 4, 8], [0, 1, 2, 3]
    ei = np.array(list(range(1, N)) + loops_i + [N - 3], np.int32)
    ej = np.array(list(range(0, N - 1)) + loops_j + [5], np.int32)
    T_gt = np.einsum("eij,ejk->eik", X_gt[ei], np.asarray(jax.vmap(jmat_inv)(X_gt[ej])))
    noise = rng.normal(size=(len(ei), 6)) * 0.01
    noise[-1] = [0.3, -0.2, 0.25, 0.4, -0.3, 0.2]  # the gross outlier
    T_meas = np.einsum("eij,ejk->eik", np.asarray(jse3_exp(jnp.asarray(noise, jnp.float32))), T_gt)
    drift = np.cumsum(rng.normal(size=(N, 6)) * 0.03, axis=0)
    drift[0] = 0.0
    X0 = np.einsum("nij,njk->nik", np.asarray(jse3_exp(jnp.asarray(drift, jnp.float32))), X_gt)
    w = np.concatenate([np.ones(N - 1), [1.0, 2.0, 1.5, 1.0, 2.0]]).astype(np.float32)
    valid = np.ones(N, bool)
    valid[-1] = False
    return jpg.PoseGraph(X=jnp.asarray(X0, jnp.float32), node_valid=jnp.asarray(valid),
                         ei=jnp.asarray(ei), ej=jnp.asarray(ej),
                         T_meas=jnp.asarray(T_meas, jnp.float32), w=jnp.asarray(w))


@pytest.fixture(scope="module", params=[0, 1])
def graphs(request):
    g = _random_graph(request.param)
    return g, pose_graph_from_numpy(g, "cpu")


def _edge_residuals_ref(g):
    return np.asarray(jax.vmap(jpg.edge_residual)(g.X[g.ei], g.X[g.ej], g.T_meas))


def test_edge_residual_matches(graphs):
    g, tg = graphs
    got = tpg.edge_residual(tg.X[tg.ei], tg.X[tg.ej], tg.T_meas).numpy()
    np.testing.assert_allclose(got, _edge_residuals_ref(g), rtol=0, atol=1e-5)


@pytest.mark.parametrize("robust", KERNELS)
def test_robust_weights_and_costs_match(graphs, robust):
    g, tg = graphs
    s2 = np.sum(_edge_residuals_ref(g) ** 2, axis=-1) * np.asarray(g.w) ** 2
    for fn in ("robust_omega", "robust_rho"):
        ref = np.asarray(getattr(jpg, fn)(jnp.asarray(s2), robust, DELTA))
        got = getattr(tpg, fn)(torch.tensor(s2), robust, DELTA).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, err_msg=fn)
    np.testing.assert_allclose(tpg._robust_edge_weight(tg, robust, DELTA).numpy(),
                               np.asarray(jpg._robust_edge_weight(g, robust, DELTA)),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(tpg._robust_cost(tg, robust, DELTA)),
                               float(jpg._robust_cost(g, robust, DELTA, None)), rtol=1e-4)


def test_unknown_kernel_raises(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="robust"):
        tpg.pgo_solve(tg, robust="cauchy")
    with pytest.raises(ValueError, match="solver"):
        tpg.pgo_solve(tg, solver="lu")


def _float64(g):
    """`g`'s float fields in float64 (inside `jax.enable_x64`)."""
    return g._replace(**{f: jnp.asarray(np.asarray(getattr(g, f)), jnp.float64)
                         for f in ("X", "T_meas", "w")})


def test_edge_jacobians_match_jacfwd(graphs):
    """Against `jax.jacfwd` of the reference evaluated in float64: in f32
    the reference's V^-1 coefficient cancels at these residuals' angles
    (~1e-2 rad), which moves its own Jacobians by up to ~3e-4."""
    g, tg = graphs
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in jax.jit(jpg._edge_terms)(_float64(g))]
    got = [x.double().numpy() for x in tpg._edge_terms(tg)]
    for name, a, b in zip(("r", "J_i", "J_j"), got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=name)


def test_edge_jacobians_at_zero_residual():
    """At the ground truth every residual is 0 and only the small-angle
    branches run: J_i = -J_j = w * I up to the adjoint, as JAX gives."""
    g, _ = _make_loop_problem(jax.random.PRNGKey(0), drift=0.0)
    tg = pose_graph_from_numpy(g, "cpu")
    ref = [np.asarray(x) for x in jax.jit(jpg._edge_terms)(g)]
    got = [x.numpy() for x in tpg._edge_terms(tg)]
    assert np.all(np.isfinite(got[1])) and np.all(np.isfinite(got[2]))
    for name, a, b in zip(("r", "J_i", "J_j"), got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=name)


def test_build_system_matches(graphs):
    g, tg = graphs
    H_ref, b_ref, c_ref = (np.asarray(x) for x in jax.jit(jpg.build_system)(g))
    H, b, c = tpg.build_system(tg)
    for name, a, r in (("H", H.numpy(), H_ref), ("b", b.numpy(), b_ref)):
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(float(c), float(c_ref), rtol=1e-4)
    np.testing.assert_allclose(float(tpg.pgo_cost(tg)), float(jpg.pgo_cost(g)), rtol=1e-4)


def test_build_system_repeats_bit_identical(graphs):
    """The assembly has no atomics: two builds (and two cg matrix-free
    scatters) give the same bits."""
    _, tg = graphs
    for a, b in zip(tpg.build_system(tg), tpg.build_system(tg)):
        assert torch.equal(a, b)
    r, J_i, _ = tpg._edge_terms(tg)
    src = torch.einsum("erc,er->ec", J_i, r)
    assert torch.equal(tpg._scatter_rows(N, tg.ei, src), tpg._scatter_rows(N, tg.ei, src))


def test_build_system_with_repeated_edges_matches_float64_assembly():
    """Edges repeated into one block, in both directions: H and b equal the
    reference's scatter-adds done in float64 on the same edge terms, within
    1e-6 of each one's largest magnitude."""
    g = _random_graph(0)
    ei = np.concatenate([np.asarray(g.ei), [3, 3, 5, 3, 3]])
    ej = np.concatenate([np.asarray(g.ej), [5, 5, 3, 5, 5]])
    rng = np.random.default_rng(4)
    T = np.einsum("eij,ejk->eik", np.asarray(jse3_exp(jnp.asarray(
        rng.normal(size=(5, 6)) * 0.01, jnp.float32))), np.asarray(g.T_meas)[[15] * 5])
    tg = pose_graph_from_numpy(g._replace(
        ei=jnp.asarray(ei), ej=jnp.asarray(ej),
        T_meas=jnp.concatenate([g.T_meas, jnp.asarray(T, jnp.float32)]),
        w=jnp.concatenate([g.w, jnp.asarray([1.0, 2.0, 0.5, 1.5, 1.0], jnp.float32)])), "cpu")
    H, b, _ = tpg.build_system(tg)
    r, J_i, J_j = (x.double().numpy() for x in tpg._edge_terms(tg))
    H64, b64 = np.zeros((N, N, 6, 6)), np.zeros((N, 6))
    for e, (i, j) in enumerate(zip(ei, ej)):
        H64[i, i] += J_i[e].T @ J_i[e]
        H64[j, j] += J_j[e].T @ J_j[e]
        H64[i, j] += J_i[e].T @ J_j[e]
        H64[j, i] += J_j[e].T @ J_i[e]
        b64[i] += J_i[e].T @ r[e]
        b64[j] += J_j[e].T @ r[e]
    assert np.abs(H64[3, 5]).max() > 0
    np.testing.assert_allclose(H.numpy(), H64, rtol=0, atol=1e-6 * np.abs(H64).max())
    np.testing.assert_allclose(b.numpy(), b64, rtol=0, atol=1e-6 * np.abs(b64).max())


@functools.lru_cache(maxsize=None)
def _jax_solver(solver, robust):
    return jax.jit(lambda gg: jpg.pgo_solve(gg, iters=ITERS, solver=solver, cg_iters=40,
                                            robust=robust, robust_delta=DELTA))


def _decisive_iterations(tg, **kw) -> int:
    """The number of leading iterations in which the port's solve in
    float64 still lowers the cost by more than COST_RTOL relative: the
    decisions that are not decided by f32 rounding of the cost."""
    g64 = tg._replace(X=tg.X.double(), T_meas=tg.T_meas.double(), w=tg.w.double())
    prev = float(tpg.pgo_solve(g64, iters=1, **kw).cost0)
    for k in range(1, ITERS + 1):
        cost = float(tpg.pgo_solve(g64, iters=k, **kw).cost)
        if prev - cost <= COST_RTOL * prev:
            return k - 1
        prev = cost
    return ITERS


@pytest.mark.parametrize("robust", KERNELS)
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pgo_solve_matches(graphs, solver, robust):
    g, tg = graphs
    ref = _jax_solver(solver, robust)(g)
    got = tpg.pgo_solve(tg, iters=ITERS, solver=solver, cg_iters=40, robust=robust,
                        robust_delta=DELTA)
    decisive = _decisive_iterations(tg, solver=solver, cg_iters=40, robust=robust,
                                    robust_delta=DELTA)
    assert decisive >= 2
    np.testing.assert_array_equal(got.accepted.numpy()[:decisive],
                                  np.asarray(ref.accepted)[:decisive])
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-4)
    for name in ("cost0", "cost"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(ref, name)),
                                   rtol=1e-4, err_msg=name)
    # the invalid node never moves
    np.testing.assert_array_equal(got.X[-1].numpy(), tg.X[-1].numpy())


def test_odometry_edges_match():
    g = _random_graph(2)
    ref = jpg.odometry_edges(g.X, g.node_valid, weight=2.0)
    tg = pose_graph_from_numpy(g, "cpu")
    got = tpg.odometry_edges(tg.X, tg.node_valid, weight=2.0)
    for name, a, b in zip(("ei", "ej", "T", "w"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)


def test_port_recovers_drifted_chain():
    """tests/test_pose_graph.py:57 through the port."""
    g, X_gt = _make_loop_problem(jax.random.PRNGKey(1), drift=0.03)
    res = tpg.pgo_solve(pose_graph_from_numpy(g, "cpu"), iters=10)
    assert float(res.cost) < 1e-8, float(res.cost)
    t_err = np.linalg.norm(res.X[:, :3, 3].numpy() - np.asarray(X_gt[:, :3, 3]), axis=-1)
    assert t_err.max() < 1e-3, t_err


def test_port_pins_invalid_nodes():
    """tests/test_pose_graph.py:70 through the port."""
    g, X_gt = _make_loop_problem(jax.random.PRNGKey(2), drift=0.02)
    g = g._replace(node_valid=g.node_valid.at[REF_N - 1].set(False),
                   w=jnp.where((g.ei == REF_N - 1) | (g.ej == REF_N - 1), 0.0, g.w))
    tg = pose_graph_from_numpy(g, "cpu")
    res = tpg.pgo_solve(tg, iters=8)
    assert float((res.X[REF_N - 1] - tg.X[REF_N - 1]).abs().max()) < 1e-6
    t_err = np.linalg.norm(res.X[:-1, :3, 3].numpy() - np.asarray(X_gt[:-1, :3, 3]), axis=-1)
    assert t_err.max() < 1e-3


def test_port_dcs_rejects_wrong_loop_edge():
    """tests/test_pose_graph.py:112 through the port: the gross edge drags
    the L2 solve away, DCS recovers the chain."""
    g, X_gt = _make_loop_problem(jax.random.PRNGKey(4), drift=0.02)
    bogus = jse3_exp(jnp.asarray([0.3, -0.2, 0.25, 0.4, -0.3, 0.2]))
    g = g._replace(ei=jnp.concatenate([g.ei, jnp.asarray([REF_N - 3], jnp.int32)]),
                   ej=jnp.concatenate([g.ej, jnp.asarray([1], jnp.int32)]),
                   T_meas=jnp.concatenate([g.T_meas, bogus[None]]),
                   w=jnp.concatenate([g.w, jnp.asarray([2.0], jnp.float32)]))
    tg = pose_graph_from_numpy(g, "cpu")
    X_gt = np.asarray(X_gt)

    def ate(X):
        return float(np.max(np.linalg.norm(X[:, :3, 3].numpy() - X_gt[:, :3, 3], axis=-1)))

    assert ate(tpg.pgo_solve(tg, iters=12).X) > 0.5
    dcs = tpg.pgo_solve(tg, iters=12, robust="dcs", robust_delta=0.05)
    assert ate(dcs.X) < 5e-3, ate(dcs.X)
    assert float(dcs.cost) < float(dcs.cost0)


def _c3_shaped_graph():
    """A JAX PoseGraph shaped like c3's loop-closure graph (module doc)."""
    rng = np.random.default_rng(5)
    n, n_loops = 50, 160
    X_gt = np.asarray(jax.vmap(jmat_inv)(make_trajectory(4 * n)[::4]))
    step = rng.normal(size=(n, 6)) * np.array([3e-4] * 3 + [2e-3] * 3)
    step[0] = 0.0
    X0 = jnp.einsum("nij,njk->nik", jse3_exp(jnp.asarray(np.cumsum(step, axis=0), jnp.float32)),
                    jnp.asarray(X_gt, jnp.float32))
    valid = jnp.ones(n, bool)
    oi, oj, T_odom, w_odom = jpg.odometry_edges(X0, valid)
    ii, jj = np.nonzero(np.arange(n)[None, :] - np.arange(n)[:, None] >= 3)
    pick = rng.choice(len(ii), n_loops, replace=False)
    li, lj = jj[pick].astype(np.int32), ii[pick].astype(np.int32)
    noise = rng.normal(size=(n_loops, 6)) * np.array([5e-4] * 3 + [5e-3] * 3)
    T_gt = np.einsum("eij,ejk->eik", X_gt[li], np.asarray(jax.vmap(jmat_inv)(X_gt[lj])))
    T_loop = jnp.einsum("eij,ejk->eik", jse3_exp(jnp.asarray(noise, jnp.float32)),
                        jnp.asarray(T_gt, jnp.float32))
    w_loop = jnp.asarray(rng.uniform(1.75, 4.0, n_loops), jnp.float32)
    return jpg.PoseGraph(X=X0, node_valid=valid, ei=jnp.concatenate([oi, jnp.asarray(li)]),
                         ej=jnp.concatenate([oj, jnp.asarray(lj)]),
                         T_meas=jnp.concatenate([T_odom, T_loop]),
                         w=jnp.concatenate([w_odom, w_loop]))


C3_KW = dict(iters=10, robust="dcs", robust_delta=0.1)


@pytest.fixture(scope="module")
def c3_graph():
    """The graph, the reference's solves in float64 and in f32, and the
    port's in f32 and in float64, dense and cg."""
    g = _c3_shaped_graph()
    tg = pose_graph_from_numpy(g, "cpu")
    tg64 = tg._replace(X=tg.X.double(), T_meas=tg.T_meas.double(), w=tg.w.double())
    out = dict(g=g, tg=tg)
    for solver in ("dense", "cg"):
        with jax.enable_x64(True):
            r = jax.jit(lambda gg, s=solver: jpg.pgo_solve(gg, solver=s, **C3_KW))(_float64(g))
            out[f"jax64_{solver}"] = jax.tree.map(np.asarray, r)
        out[f"jax32_{solver}"] = jax.tree.map(
            np.asarray, jax.jit(lambda gg, s=solver: jpg.pgo_solve(gg, solver=s, **C3_KW))(g))
        out[f"port32_{solver}"] = tpg.pgo_solve(tg, solver=solver, **C3_KW)
        out[f"port64_{solver}"] = tpg.pgo_solve(tg64, solver=solver, **C3_KW)
    return out


def test_c3_graph_is_c3_shaped(c3_graph):
    """50 nodes, 209 edges; loop residuals of ~1e-3 rad, as on the JAX
    package's c3 leg graph (scripts/pgo_precision.py: its worst-rounded
    edge sits at 1.17 mrad)."""
    tg = c3_graph["tg"]
    r = tpg.edge_residual(tg.X[tg.ei], tg.X[tg.ej], tg.T_meas)[49:, :3].norm(dim=-1)
    assert tg.X.shape[0] == 50 and tg.w.shape[0] == 209
    assert 5e-4 < float(r.median()) < 3e-3 and float(r.max()) < 1e-2, r


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_c3_graph_solve_matches_float64(c3_graph, solver):
    """The port's f32 solve within 1e-5 of the reference's float64 solve,
    and nearer to it than the reference's own f32 solve; the port's float64
    solve equal to the reference's to 1e-9."""
    ref = c3_graph[f"jax64_{solver}"]
    got = c3_graph[f"port32_{solver}"]
    err = float(np.abs(got.X.double().numpy() - ref.X).max())
    err_ref32 = float(np.abs(c3_graph[f"jax32_{solver}"].X - ref.X).max())
    assert err < 1e-5, err
    assert err < err_ref32, (err, err_ref32)
    for name in ("cost0", "cost"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(ref, name)),
                                   rtol=1e-5, err_msg=name)
    assert float(got.cost) < float(got.cost0) and bool(got.accepted.any())
    np.testing.assert_allclose(c3_graph[f"port64_{solver}"].X.numpy(), ref.X, rtol=0, atol=1e-9)


def test_c3_graph_cg_matches_dense(c3_graph):
    """The port's f32 cg and dense solves within 1e-5 of each other (the
    reference's tolerance is 1e-3, tests/test_pose_graph.py:165)."""
    dense, cg = c3_graph["port32_dense"], c3_graph["port32_cg"]
    assert float((cg.X - dense.X).abs().max()) < 1e-5
