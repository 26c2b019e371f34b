"""The port's ranks, mesh and collectives (`sosvo_torch.dist.mesh`, `launch`) on the CPU.

Ranks are processes started by `sosvo_torch.dist.launch` with gloo on CPU
tensors. On a 2 x 2 (data, model) mesh of 4 ranks: `psum` is the sum and
bit-identical on every rank of an axis, the all-gather and both ring halos
are exact, a broadcast is the source's value; at world size 1 every helper
is the identity and no group exists. A rank that fails fails the launch,
and a launch that hangs is killed at its timeout.
"""

import numpy as np
import pytest
import torch

from sosvo_torch.dist import mesh
from sosvo_torch.dist.launch import LaunchError, launch, launch_module
from tests import torch_dist_ranks

RANKS = "tests.torch_dist_ranks"


def _x(r):
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) * 0.1 + r


def test_collectives_at_world_4():
    outs = launch(f"{RANKS}:collectives", 4, dict(data=2, model=2), device="cpu")
    for r, out in enumerate(outs):
        d, m = divmod(r, 2)
        for name, peers, idx in (("model", [2 * d, 2 * d + 1], m), ("data", [m, 2 + m], d)):
            o = out[name]
            assert (o["size"], o["index"]) == (2, idx)
            want = _x(peers[0]) + _x(peers[1])
            torch.testing.assert_close(o["psum"], want, rtol=1e-6, atol=0)
            torch.testing.assert_close(o["psum_scalar"],
                                       torch.tensor(peers[0] ** 0.5 + peers[1] ** 0.5))
            assert torch.equal(o["psum_one"], o["psum"])
            assert torch.equal(o["gather"], torch.cat([_x(p) for p in peers]))
            assert torch.equal(o["next"], _x(peers[(idx + 1) % 2])[0])
            assert torch.equal(o["prev"], _x(peers[(idx - 1) % 2])[0])
            assert torch.equal(o["bcast"], _x(peers[0]) * (peers[0] + 1))
    # psum is bit-identical on every rank of an axis
    for a, b, name in ((0, 1, "model"), (2, 3, "model"), (0, 2, "data"), (1, 3, "data")):
        assert torch.equal(outs[a][name]["psum"], outs[b][name]["psum"])
        assert torch.equal(outs[a][name]["psum_scalar"], outs[b][name]["psum_scalar"])


def test_world_1_is_the_identity():
    """One process, no group: the mesh the command line clamps to on one card."""
    ranks = mesh.init_process_group("cpu", rank=0, world_size=1)
    assert ranks.backend is None and not torch.distributed.is_initialized()
    m = mesh.make_mesh(ranks, 1, 1)
    mesh.reset_calls()
    out = torch_dist_ranks.collectives(ranks, 1, 1)
    for name in ("model", "data"):
        o = out[name]
        x = _x(0)
        assert (o["size"], o["index"]) == (1, 0)
        assert torch.equal(o["psum"], x) and torch.equal(o["gather"], x)
        assert torch.equal(o["next"], x[0]) and torch.equal(o["prev"], x[0])
    assert not mesh.calls and m.member


def test_backend_rule():
    assert mesh.choose_backend(torch.device("cpu"), 4)[0] == "gloo"
    with pytest.raises(ValueError):
        mesh.make_mesh(mesh.single("cpu"), 2, 1)


def test_failing_rank_fails_the_launch():
    with pytest.raises(LaunchError, match="rank 1 fails"):
        launch(f"{RANKS}:fail_on_rank_1", 3, device="cpu", timeout_s=120)


def test_hanging_launch_is_killed():
    with pytest.raises(LaunchError, match="timed out"):
        launch_module("tests.torch_dist_ranks", ["--hang"], 2, timeout_s=3)


def test_launch_module_reports_exit_codes():
    exits = launch_module("tests.torch_dist_ranks", ["--exit", "42"], 2, timeout_s=120,
                          ok_codes=(42,))
    assert [e.returncode for e in exits] == [42, 42]
    assert np.all([f"rank {e.rank} of 2" in e.stdout for e in exits])


def test_dryrun_on_the_cpu():
    """The 2 data x 4 model dryrun (`sosvo_torch.dist.dryrun`, the twin of
    `__graft_entry__.dryrun_multichip`) on 8 CPU ranks: it checks its own
    bounds (BA within 1e-4 of one rank, PGO within 3e-3 of dense, 1e-3 at
    c5 scale) and prints the reference's line."""
    from sosvo_torch.dist.dryrun import dryrun

    line = dryrun(8, device="cpu", timeout_s=300)
    assert line.startswith("dryrun_multichip OK: mesh=(2 data x 4 model), dp vo step ok=2/2")
    assert "c5-scale ba W=8 L=4096" in line


def test_scaling_report_on_the_cpu():
    from sosvo_torch.dist.scaling import measure_scaling

    rep = measure_scaling((1, 2), n_frames=3, k=64, seqs_per_rank=1, device="cpu", timeout_s=300)
    assert rep["device"] == "cpu" and "not a device rate" in rep["note"]
    assert [r["ranks"] for r in rep["rows"]] == [1, 2]
    assert all(r["frames_per_s"] > 0 for r in rep["rows"])
