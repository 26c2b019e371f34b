"""Hamming matcher: the CUDA kernel's wrapper and the matcher the pipeline calls.

Replaces the Pallas TPU kernel `sosvo/kernels/match_pallas.py:
match_stats_pallas` (body `_match_kernel`) and its wrapper `match_pallas`.
The kernel is `sosvo_torch/csrc/match_hamming.cu`; its header says what it
computes, what bounds it on the card (launch latency and per-column atomics
at K <= 2048, not bytes or FLOPs) and how the design handles blocks that run
in no order (register-resident rows, shared-memory B tiles, a packed 64-bit
atomicMin for the column argmin).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (or
raise); CPU tensors run the plain twin `sosvo_torch.frontend.match.
match_stats`. There is no fallback from one to the other. `launches` counts
kernel launches, so a run can show that its matches went through the kernel.
The epilogue (threshold, strict ratio test, cross-check) is torch ops on the
kernel's outputs, as in `match_pallas`.
"""

from __future__ import annotations

import torch

from sosvo_torch.frontend.match import MatchResult, MatchStats, WORDS, match_from_stats, match_stats
from sosvo_torch.kernels import build

launches = 0  # kernel launches since import or the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"match_stats_cuda: {name} must be {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def match_stats_cuda(desc_a: torch.Tensor, desc_b: torch.Tensor,
                     valid_a: torch.Tensor, valid_b: torch.Tensor,
                     az_a: torch.Tensor | None = None, az_b: torch.Tensor | None = None,
                     band: float = 0.0) -> MatchStats:
    """Launch the kernel on the current stream; no synchronisation.

    desc_*: (K, 8) int32 bit patterns; valid_*: (K,) bool; az_*: (K,) f32,
    needed only when band > 0. Returns the same MatchStats as `match_stats`.
    """
    global launches
    device = desc_a.device
    if device.type != "cuda":
        raise ValueError(f"match_stats_cuda needs CUDA tensors, got {device}")
    ka, kb = desc_a.shape[0], desc_b.shape[0]
    if ka == 0 or kb == 0:
        raise ValueError("match_stats_cuda: empty descriptor set")
    _check("desc_a", desc_a, torch.int32, (ka, WORDS), device)
    _check("desc_b", desc_b, torch.int32, (kb, WORDS), device)
    _check("valid_a", valid_a, torch.bool, (ka,), device)
    _check("valid_b", valid_b, torch.bool, (kb,), device)
    use_band = band > 0.0
    if use_band:
        if az_a is None or az_b is None:
            raise ValueError("match_stats_cuda: band > 0 needs az_a and az_b")
        _check("az_a", az_a, torch.float32, (ka,), device)
        _check("az_b", az_b, torch.float32, (kb,), device)
        az_a, az_b = az_a.contiguous(), az_b.contiguous()
    desc_a, desc_b = desc_a.contiguous(), desc_b.contiguous()
    valid_a, valid_b = valid_a.contiguous(), valid_b.contiguous()

    lib = build.load()
    d_best = torch.empty(ka, dtype=torch.float32, device=device)
    d_second = torch.empty(ka, dtype=torch.float32, device=device)
    idx_b = torch.empty(ka, dtype=torch.int32, device=device)
    col_key = torch.full((kb,), -1, dtype=torch.int64, device=device)  # ~0: atomicMin identity
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.sosvo_match_hamming(
            desc_a.data_ptr(), desc_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(),
            az_a.data_ptr() if use_band else None, az_b.data_ptr() if use_band else None,
            ka, kb, float(band) if use_band else 0.0,
            d_best.data_ptr(), d_second.data_ptr(), idx_b.data_ptr(), col_key.data_ptr(),
            stream)
    if status != 0:
        raise RuntimeError(f"match_hamming kernel launch failed with CUDA error {status}")
    launches += 1
    col_argmin = (col_key & 0xFFFFFFFF).to(torch.int32)  # low word: the row
    return MatchStats(d_best, d_second, idx_b, col_argmin)


def match_hamming(desc_a: torch.Tensor, desc_b: torch.Tensor,
                  valid_a: torch.Tensor, valid_b: torch.Tensor,
                  max_distance: float = 64.0, ratio: float = 0.8,
                  az_a: torch.Tensor | None = None, az_b: torch.Tensor | None = None,
                  band: float = 0.0) -> MatchResult:
    """Brute-force Hamming matching with ratio test and cross-check.

    Same contract as `sosvo.kernels.match_pallas.match_pallas`. CUDA tensors
    go through the kernel, CPU tensors through the plain matcher.
    """
    if desc_a.device.type == "cuda":
        stats = match_stats_cuda(desc_a, desc_b, valid_a, valid_b, az_a, az_b, band)
    elif desc_a.device.type == "cpu":
        stats = match_stats(desc_a, desc_b, valid_a, valid_b, az_a, az_b, band)
    else:
        raise ValueError(f"match_hamming: no matcher for device {desc_a.device}")
    return match_from_stats(stats, valid_a, max_distance, ratio)
