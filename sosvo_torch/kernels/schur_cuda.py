"""BA Schur reduction: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel `sosvo/kernels/schur_pallas.py:
schur_reduce_pallas` (body `_schur_kernel`) and its wrapper
`reduce_camera_system_pallas`, with that wrapper's contract: it takes the
UNDAMPED landmark blocks H_ll and the damping lam, and returns
(S (W, W, 6, 6), b_red (W, 6), H_ll_inv (L, 3, 3)). The kernel is
`sosvo_torch/csrc/schur_reduce.cu`; its header says what it computes, what
bounds it on the card (bytes, far below one launch's latency) and how one
thread-block cluster sums its CTAs' partials in a fixed order through
distributed shared memory (bit-identical outputs from call to call).

Each call is one kernel launch: the five outputs are views of one
`torch.empty`, and a Python float lam goes to the kernel by value. Windows
large enough to take several clusters sum the clusters' partials through a
scratch kept per (device, stream). `schedule` is the kernel's work split
(clusters, tile size and landmark groups per CTA for the cluster shape the
card schedules), shared with the tests' emulation of its summation order.

The shard-partial form (config c5, `reduce_camera_system_pallas(axis_name=
...)`): with `axis`, `reduce_camera_system_cuda` launches the same kernel
on this rank's landmark shard, sums its S_off and b_sub over the axis (one
all-reduce of the (6W)^2 + 6W floats), and assembles S and b_red from the
global, already-damped H_cc and b_c; still one launch per call. The LM
step (`backend/ba.py:lm_step`) takes the same route through `schur_parts`,
with H_cc, b_c and the gauge coupling in the same all-reduce.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise); CPU tensors run the plain version, `inv3x3` followed by
`sosvo_torch.backend.schur.reduce_camera_system`. There is no fallback from
one to the other. `launches` counts kernel launches, so a run can show that
its BA went through the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.backend.schur import assemble_camera_system, inv3x3, schur_terms
from sosvo_torch.kernels import build

launches = 0  # kernel launches since import or the last reset_launches()
THREADS = 512        # threads per CTA (csrc/schur_reduce.cu: kThreads)
SLOTS = 42           # floats per camera-block pair: 36 of S_off, 6 of b_sub
MAX_TILE = 64        # landmarks per tile, at most
MAX_PER_GROUP = 8    # landmarks per group per tile, at most
MAX_SMEM = 140 * 1024  # bytes of shared memory per CTA (csrc/schur_reduce.cu: kMaxSmem)
LM_PER_CTA = 32      # landmarks per CTA beyond which a window takes more clusters
MAX_CLUSTERS = 16    # clusters per launch (csrc/schur_reduce.cu: kMaxClusters)

_cluster: dict[int, tuple[int, int]] = {}  # per device index
_scratch: dict[tuple[int, int], torch.Tensor] = {}  # per (device, stream): cluster partials, ticket


def reset_launches() -> None:
    global launches
    launches = 0


def smem_bytes(W: int, tile: int, groups: int) -> int:
    """Dynamic shared memory per CTA (csrc/schur_reduce.cu: smem_floats):
    two raw tile buffers and the tile's A, H, inverses and b_l, or later
    the groups' sums and the CTA's partial, whichever is larger."""
    return 4 * max(tile * (72 * W + 36), (groups + 1) * W * (W + 1) // 2 * SLOTS)


def schedule(W: int, L: int, cluster: int, resident: int) -> tuple[int, int, int]:
    """(clusters, tile, groups): the kernel's grid of clusters of `cluster`
    CTAs, its landmarks per tile and its landmark groups per CTA for a W x L
    window on a card that holds `resident` such clusters at once.

    One cluster while it gives each CTA at most LM_PER_CTA landmarks, else
    as many as that needs, at most `resident` (one wave). A CTA's threads
    are the W (W + 1) / 2 camera-block pairs times `groups`; each group
    takes the same number of a tile's landmarks, as few as give every CTA a
    tile and at most MAX_PER_GROUP (and MAX_TILE a tile).
    """
    pairs = W * (W + 1) // 2
    groups = min(THREADS // pairs, MAX_TILE)
    if groups == 0:
        raise ValueError(f"schur_reduce_cuda: W={W} has {pairs} camera-block pairs, "
                         f"more than the kernel's {THREADS} threads")
    clusters = max(1, min(resident, MAX_CLUSTERS, -(-L // (cluster * LM_PER_CTA))))
    ctas = clusters * cluster
    per_group = max(1, min(-(-L // (ctas * groups)), MAX_PER_GROUP, MAX_TILE // groups))
    tile = groups * per_group
    smem = smem_bytes(W, tile, groups)
    if smem > MAX_SMEM:
        raise ValueError(f"schur_reduce_cuda: W={W} needs {smem} B of shared memory per CTA")
    return clusters, tile, groups


def cluster_shape(device: torch.device) -> tuple[int, int]:
    """(CTAs per cluster, clusters resident at once) on `device`: 16 CTAs
    where the card schedules a non-portable cluster of 16, else 8; a
    cluster's CTAs share one GPC, so the card may hold fewer clusters than
    its SMs / CTAs (asked once per device)."""
    shape = _cluster.get(device.index)
    if shape is None:
        lib = build.load()
        c = build.launch(device, lib.sosvo_schur_cluster_size)
        if c == 0:
            raise RuntimeError(f"schur_reduce_cuda: {device} schedules no cluster of 8 or 16 CTAs")
        shape = _cluster[device.index] = (c, build.launch(device, lib.sosvo_schur_resident_clusters))
    return shape


def _cluster_scratch(device: torch.device, stream: int, floats: int) -> tuple[int, int]:
    """Pointers (cluster partials, ticket) into the scratch of `stream`: the
    partials need no initial value; the ticket, its last element, is 0 at
    allocation and every call leaves it so."""
    key = (device.index, stream)
    s = _scratch.get(key)
    if s is None or s.numel() < floats + 1:
        s = torch.zeros(max(floats, 4096) + 1, dtype=torch.int32, device=device)
        _scratch[key] = s
    return s.data_ptr(), s.data_ptr() + 4 * (s.numel() - 1)


class SchurParts(NamedTuple):
    """The kernel's outputs: its raw sums and the assembled system."""

    S_off: torch.Tensor     # (W, W, 6, 6) sum_l A H_cl^T
    b_sub: torch.Tensor     # (W, 6) sum_l A b_l
    H_ll_inv: torch.Tensor  # (L, 3, 3) (H_ll + lam I)^-1
    S: torch.Tensor         # (W, W, 6, 6) blockdiag(H_cc [+ lam I]) - S_off
    b_red: torch.Tensor     # (W, 6) b_c - b_sub


def schur_reduce_plain(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True) -> SchurParts:
    """The plain version: `inv3x3` of the damped landmark blocks, then
    `reduce_camera_system`'s two steps, in eager torch ops on any device."""
    eye3 = torch.eye(3, dtype=H_ll.dtype, device=H_ll.device)
    H_ll_inv = inv3x3(H_ll + lam * eye3[None])
    S_off, b_sub = schur_terms(H_cl, H_ll_inv, b_l)
    if damp_H_cc:
        H_cc = H_cc + lam * torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)[None]
    S, b_red = assemble_camera_system(H_cc, b_c, S_off, b_sub)
    return SchurParts(S_off, b_sub, H_ll_inv, S, b_red)


def _check(name: str, t: torch.Tensor, shape: tuple, device, contiguous: bool = True) -> None:
    if t.dtype != torch.float32 or t.shape != shape or t.device != device:
        raise ValueError(f"schur_reduce_cuda: {name} must be float32 {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"schur_reduce_cuda: {name} must be contiguous")


def schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True) -> SchurParts:
    """Launch the kernel on the current stream; no synchronisation.

    H_cc (W, 6, 6), H_cl (W, L, 6, 3) with its trailing 6 x 3 contiguous (any
    W and L strides), H_ll (L, 3, 3), b_c (W, 6), b_l (L, 3), all float32 on
    one CUDA device and, but for H_cl, contiguous. lam is a Python float or
    a one-element float32 tensor on that device (read by the kernel, never
    by the host).
    """
    global launches
    device = H_cl.device
    if device.type != "cuda":
        raise ValueError(f"schur_reduce_cuda needs CUDA tensors, got {device}")
    if H_cl.dim() != 4:
        raise ValueError(f"schur_reduce_cuda: H_cl must be (W, L, 6, 3), got {tuple(H_cl.shape)}")
    W, L = H_cl.shape[0], H_cl.shape[1]
    if W == 0 or L == 0:
        raise ValueError("schur_reduce_cuda: empty window")
    _check("H_cl", H_cl, (W, L, 6, 3), device, contiguous=False)
    if H_cl.stride(3) != 1 or H_cl.stride(2) != 3:
        raise ValueError("schur_reduce_cuda: H_cl's trailing (6, 3) blocks must be contiguous")
    _check("H_cc", H_cc, (W, 6, 6), device)
    _check("H_ll", H_ll, (L, 3, 3), device)
    _check("b_c", b_c, (W, 6), device)
    _check("b_l", b_l, (L, 3), device)
    if isinstance(lam, torch.Tensor):
        if lam.device != device or lam.dtype != torch.float32 or lam.numel() != 1:
            raise ValueError("schur_reduce_cuda: lam must be one float32 on the tensors' device")
        lam_ptr, lam_value = lam.data_ptr(), 0.0
    else:
        lam_ptr, lam_value = None, float(lam)

    lib = build.load()
    cluster, resident = cluster_shape(device)
    clusters, tile, groups = schedule(W, L, cluster, resident)
    n_blk = W * W * 36
    out = torch.empty(2 * n_blk + 12 * W + 9 * L, dtype=torch.float32, device=device)
    S_off, b_sub, H_ll_inv, S, b_red = out.split_with_sizes((n_blk, 6 * W, 9 * L, n_blk, 6 * W))
    parts = SchurParts(S_off=S_off.view(W, W, 6, 6), b_sub=b_sub.view(W, 6),
                       H_ll_inv=H_ll_inv.view(L, 3, 3), S=S.view(W, W, 6, 6), b_red=b_red.view(W, 6))
    stream = build.stream_of(device)
    cl_part, ticket = _cluster_scratch(device, stream, clusters * W * (W + 1) // 2 * SLOTS)
    status = build.launch(
        device, lib.sosvo_schur_reduce,
        H_cl.data_ptr(), H_cl.stride(0), H_cl.stride(1), H_ll.data_ptr(), b_l.data_ptr(),
        H_cc.data_ptr(), b_c.data_ptr(), lam_ptr, lam_value, W, L, tile, groups, cluster,
        clusters, int(damp_H_cc), H_ll_inv.data_ptr(), S_off.data_ptr(), b_sub.data_ptr(),
        S.data_ptr(), b_red.data_ptr(), cl_part, ticket, stream)
    if status != 0:
        raise RuntimeError(f"schur_reduce kernel launch failed with CUDA error {status}")
    launches += 1
    return parts


def schur_parts(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True) -> SchurParts:
    """The Schur reduction's parts, by the tensors' device: CUDA tensors
    launch the kernel, CPU tensors run the plain version."""
    if H_cl.device.type == "cuda":
        return schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    if H_cl.device.type == "cpu":
        return schur_reduce_plain(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    raise ValueError(f"schur_parts: no Schur reduction for device {H_cl.device}")


def reduce_camera_system_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True,
                              axis=None):
    """Fused Schur reduction with `reduce_camera_system_pallas`'s contract:
    (S (W, W, 6, 6), b_red (W, 6), H_ll_inv (L, 3, 3)).

    `damp_H_cc=False` when the caller already damped H_cc (the LM step
    does); lam then only damps the landmark blocks. CUDA tensors go through
    the kernel, CPU tensors through the plain version. With `axis`
    (landmark sharding) H_cl, H_ll and b_l are this rank's shard, H_cc and
    b_c are global: the shard's S_off and b_sub are summed over the axis
    before S and b_red are assembled.
    """
    parts = schur_parts(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    if axis is None:
        return parts.S, parts.b_red, parts.H_ll_inv
    S_off, b_sub = axis.psum(parts.S_off, parts.b_sub)
    if damp_H_cc:
        H_cc = H_cc + lam * torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)[None]
    S, b_red = assemble_camera_system(H_cc, b_c, S_off, b_sub)
    return S, b_red, parts.H_ll_inv
