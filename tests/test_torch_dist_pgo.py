"""The port's distributed pose-graph solvers against the JAX package's.

  * `sosvo_torch.dist.pgo_time.pgo_solve_time_sharded` (nodes split along
    time over 8 ranks, ring halos, loop edges gathered and summed) on
    tests/test_pgo_scale.py's loopy graphs (n = 32, 8 loop edges, plain and
    with DCS against one gross outlier loop edge): against dense
    `pgo_solve` with tests/test_pgo_scale.py's bounds (initial cost within
    1e-5 relative, X within 3e-3, within 2e-2 of ground truth, cost below a
    tenth of the initial one), the same against the JAX package's
    time-sharded solve on `model_mesh(8)`, and every rank's X bit-equal.
    The two packages' f32 log maps differ near zero rotation (ROADMAP.md
    section 3: the reference's f32 `se3_log` cancels); at these graphs'
    3e-3 bound that difference does not show, so no float64 leg is needed.
  * the edge-sharded `pgo_solve` (tests/test_pose_graph.py's padded loop
    graph at D = 8, nodes replicated, edges split): cost under 1e-8, X
    within 1e-4 of the JAX package's sharded and single solves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from sosvo.backend.pose_graph import PGOResult, PoseGraph, pgo_solve as jax_pgo_solve
from sosvo.dist.mesh import MODEL_AXIS, model_mesh
from sosvo.dist.pgo_time import TimeShardedGraph as JaxTimeGraph
from sosvo.dist.pgo_time import pgo_solve_time_sharded as jax_time_sharded
from sosvo.geom.lie import se3_exp
from sosvo_torch.backend.pose_graph import pgo_solve
from sosvo_torch.convert import pose_graph_from_numpy
from sosvo_torch.dist.launch import launch
from sosvo_torch.dist.pgo_time import TimeShardedGraph
from tests.test_pgo_scale import _flat_graph, _make_loopy_graph
from tests.test_pose_graph import _make_loop_problem

RANKS = "tests.torch_dist_ranks"


def _time_graph(n, X0, odo, loop):
    _, _, T_odo = odo
    li, lj, T_loop = loop
    return JaxTimeGraph(
        X=X0, node_valid=jnp.ones(n, bool),
        T_odo=jnp.concatenate([T_odo, jnp.eye(4, dtype=jnp.float32)[None]]),
        w_odo=jnp.ones(n, jnp.float32).at[n - 1].set(0.0),
        loop_i=li, loop_j=lj, T_loop=T_loop, w_loop=jnp.ones(li.shape[0], jnp.float32))


def _port(g: JaxTimeGraph) -> TimeShardedGraph:
    t = {f: torch.tensor(np.asarray(getattr(g, f))) for f in g._fields}
    return TimeShardedGraph(**{**t, "loop_i": t["loop_i"].long(), "loop_j": t["loop_j"].long()})


@pytest.mark.parametrize("robust", ["none", "dcs"])
def test_time_sharded_matches_jax_and_dense(devices8, robust):
    n, d = 32, 8
    if robust == "none":
        X_gt, X0, odo, loop = _make_loopy_graph(n, e_loop=8, seed=3)
        kw, iters = {}, 6
    else:
        X_gt, X0, odo, loop = _make_loopy_graph(n, e_loop=8, seed=5, noise=0.02)
        li, lj, T_loop = loop
        bogus = se3_exp(jnp.asarray([0.3, -0.25, 0.2, 0.5, -0.4, 0.3]))
        loop = (li, lj, T_loop.at[-1].set(bogus @ T_loop[-1]))
        kw, iters = dict(robust="dcs", robust_delta=0.05), 8
    g_flat = _flat_graph(n, X0, odo, loop)
    dense = jax.jit(lambda g: jax_pgo_solve(g, iters=iters, **kw))(g_flat)
    g_time = _time_graph(n, X0, odo, loop)
    ref = jax_time_sharded(model_mesh(d), MODEL_AXIS, g_time, iters=iters, cg_iters=60, **kw)

    outs = launch(f"{RANKS}:pgo_time_sharded", d,
                  dict(g=_port(g_time), iters=iters, cg_iters=60, **kw), device="cpu")
    res, calls = outs[0]
    X = res.X.numpy()
    assert float(res.cost) < 0.1 * float(res.cost0)
    np.testing.assert_allclose(float(res.cost0), float(dense.cost0), rtol=1e-5)
    np.testing.assert_allclose(X, np.asarray(dense.X), atol=3e-3)
    np.testing.assert_allclose(X, np.asarray(ref.X), atol=3e-3)
    assert np.abs(X - np.asarray(X_gt)).max() < 2e-2
    port_dense = pgo_solve(pose_graph_from_numpy(g_flat, "cpu"), iters=iters, **kw)
    np.testing.assert_allclose(X, port_dense.X.numpy(), atol=3e-3)
    for o, c in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, res)) and c == calls
    # per GN step: the terms (an all-gather), b and the diagonal (a sum),
    # 60 PCG iterations of one all-gather and three sums, the candidate's
    # cost (an all-gather and a sum); and the initial cost and the result
    assert calls == {"data.all_gather": 2 + iters * (2 + 60), "data.psum": 1 + iters * (3 + 60 * 3)}


def test_edge_sharded_pgo_matches_jax(devices8):
    g, _ = _make_loop_problem(jax.random.PRNGKey(3), drift=0.03)
    E = g.ei.shape[0]
    pad = -(-E // 8) * 8 - E
    g_pad = g._replace(
        ei=jnp.concatenate([g.ei, jnp.zeros((pad,), jnp.int32)]),
        ej=jnp.concatenate([g.ej, jnp.zeros((pad,), jnp.int32)]),
        T_meas=jnp.concatenate([g.T_meas, jnp.tile(jnp.eye(4, dtype=jnp.float32), (pad, 1, 1))]),
        w=jnp.concatenate([g.w, jnp.zeros((pad,))]))
    mesh = model_mesh(8)
    specs = PoseGraph(X=P(), node_valid=P(), ei=P(MODEL_AXIS), ej=P(MODEL_AXIS),
                      T_meas=P(MODEL_AXIS), w=P(MODEL_AXIS))
    fn = shard_map(functools.partial(jax_pgo_solve, iters=10, axis_name=MODEL_AXIS),
                   mesh=mesh, in_specs=(specs,),
                   out_specs=PGOResult(X=P(), cost=P(), cost0=P(), accepted=P()),
                   check_vma=False)
    ref_s = jax.jit(fn)(jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                                     g_pad, specs))
    ref_1 = jax_pgo_solve(g_pad, iters=10)
    outs = launch(f"{RANKS}:pgo_edge_sharded", 8,
                  dict(g=pose_graph_from_numpy(g_pad, "cpu"), iters=10), device="cpu")
    res = outs[0]
    assert float(res.cost) < 1e-8
    assert float(np.max(np.abs(res.X.numpy() - np.asarray(ref_s.X)))) < 1e-4
    assert float(np.max(np.abs(res.X.numpy() - np.asarray(ref_1.X)))) < 1e-4
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, res))
