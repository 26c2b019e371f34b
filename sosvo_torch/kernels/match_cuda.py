"""Hamming matcher: the CUDA kernel's wrapper and the matcher the pipeline calls.

Replaces the Pallas TPU kernel `sosvo/kernels/match_pallas.py:
match_stats_pallas` (body `_match_kernel`) and its wrapper `match_pallas`.
The kernel is `sosvo_torch/csrc/match_hamming.cu`; its header says what it
computes, what bounds it on the card (latency: one launch, the loads and
the per-column atomics, at K <= 2048) and how it is built for Hopper
(b1 AND/popc tensor-core products, a register epilogue, a packed 64-bit
atomicMin for the column argmin decoded by the block that finishes last).

Each call is one kernel launch: the four statistics are views of one
`torch.empty`, and the column keys, the row partials of a split grid and
the ticket counter live in a scratch kept per (device, stream), filled with
its identity when it is allocated and left clean by every call (calls on
one stream are ordered).

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
SCRATCH_MIN = 4096  # columns a new scratch holds at least

_scratch: dict[tuple[int, int], torch.Tensor] = {}
_row_part_words: dict[int, int] = {}  # per device: 16 float4 per SM, in int64 words


def reset_launches() -> None:
    global launches
    launches = 0


def _scratch_for(device: torch.device, stream: int, kb: int) -> tuple[int, int, int]:
    """Pointers (column keys, ticket, row partials) into the scratch of
    `stream`: an int64 tensor of `cap` column keys at ~0, room for 16 row
    states (float4) per SM of the card, and the ticket counter at 0 in its
    last element. Allocated (and filled) only when the stream has none or a
    smaller one."""
    key = (device.index, stream)
    s = _scratch.get(key)
    if s is None or s.numel() < kb + _row_part_words[device.index] + 1:
        if device.index not in _row_part_words:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            _row_part_words[device.index] = 2 * 16 * sms
        cap = max(kb, SCRATCH_MIN)
        cap += cap & 1  # even, so the row partials start 16-byte aligned
        s = torch.full((cap + _row_part_words[device.index] + 1,), -1, dtype=torch.int64,
                       device=device)
        s[-1] = 0
        _scratch[key] = s
    base, n = s.data_ptr(), s.numel()
    return base, base + 8 * (n - 1), base + 8 * (n - 1 - _row_part_words[device.index])


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype or t.shape != shape or t.device != device:
        raise ValueError(f"match_stats_cuda: {name} must be {dtype} {tuple(shape)} on {device}, "
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
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("match_stats_cuda: descriptors must start on a 16-byte boundary")

    lib = build.load()
    stream = build.stream_of(device)
    col_key, ticket, row_part = _scratch_for(device, stream, kb)
    out = torch.empty(3 * ka + kb, dtype=torch.float32, device=device)
    # split_with_sizes, not split: Tensor.split's Python layer costs as much
    # host time as the views themselves
    d_best, d_second, ints = out.split_with_sizes((ka, ka, ka + kb))
    idx_b, col_argmin = ints.view(torch.int32).split_with_sizes((ka, kb))
    status = build.launch(
        device, lib.sosvo_match_hamming,
        desc_a.data_ptr(), desc_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(),
        az_a.data_ptr() if use_band else None, az_b.data_ptr() if use_band else None,
        ka, kb, float(band) if use_band else 0.0,
        d_best.data_ptr(), d_second.data_ptr(), idx_b.data_ptr(), col_argmin.data_ptr(),
        col_key, ticket, row_part, stream)
    if status != 0:
        raise RuntimeError(f"match_hamming kernel launch failed with CUDA error {status}")
    launches += 1
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
