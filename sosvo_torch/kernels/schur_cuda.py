"""BA Schur reduction: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel `sosvo/kernels/schur_pallas.py:
schur_reduce_pallas` (body `_schur_kernel`) and its wrapper
`reduce_camera_system_pallas`, with that wrapper's contract: it takes the
UNDAMPED landmark blocks H_ll and the damping lam, and returns
(S (W, W, 6, 6), b_red (W, 6), H_ll_inv (L, 3, 3)). The kernel is
`sosvo_torch/csrc/schur_reduce.cu`; its header says what it computes, what
bounds it on the card (launch latency: the work is microseconds of bytes and
FLOPs below it) and how its blocks, which run in no order, are summed in a
fixed order (bit-identical outputs from call to call).

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


def reset_launches() -> None:
    global launches
    launches = 0


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
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
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
        lam_t = lam.reshape(())
    else:
        lam_t = torch.full((), float(lam), dtype=torch.float32, device=device)

    lib = build.load()
    n = 6 * W
    blocks = -(-L // lib.sosvo_schur_tile_l())
    partial = torch.empty((blocks, n * n + n), dtype=torch.float32, device=device)
    out = SchurParts(S_off=torch.empty((W, W, 6, 6), dtype=torch.float32, device=device),
                     b_sub=torch.empty((W, 6), dtype=torch.float32, device=device),
                     H_ll_inv=torch.empty((L, 3, 3), dtype=torch.float32, device=device),
                     S=torch.empty((W, W, 6, 6), dtype=torch.float32, device=device),
                     b_red=torch.empty((W, 6), dtype=torch.float32, device=device))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.sosvo_schur_reduce(
            H_cl.data_ptr(), H_cl.stride(0), H_cl.stride(1), H_ll.data_ptr(), b_l.data_ptr(),
            H_cc.data_ptr(), b_c.data_ptr(), lam_t.data_ptr(), W, L, int(damp_H_cc),
            partial.data_ptr(), out.H_ll_inv.data_ptr(), out.S_off.data_ptr(),
            out.b_sub.data_ptr(), out.S.data_ptr(), out.b_red.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"schur_reduce kernel launch failed with CUDA error {status}")
    launches += 1
    return out


def reduce_camera_system_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc: bool = True):
    """Fused Schur reduction with `reduce_camera_system_pallas`'s contract:
    (S (W, W, 6, 6), b_red (W, 6), H_ll_inv (L, 3, 3)).

    `damp_H_cc=False` when the caller already damped H_cc (the LM step
    does); lam then only damps the landmark blocks. CUDA tensors go through
    the kernel, CPU tensors through the plain version.
    """
    if H_cl.device.type == "cuda":
        parts = schur_reduce_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    elif H_cl.device.type == "cpu":
        parts = schur_reduce_plain(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc)
    else:
        raise ValueError(f"reduce_camera_system_cuda: no Schur reduction for device {H_cl.device}")
    return parts.S, parts.b_red, parts.H_ll_inv
