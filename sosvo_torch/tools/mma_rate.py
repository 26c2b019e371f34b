"""Tensor-core throughput in the b1 AND/popc form of the matcher's work, beside int8.

    python -m sosvo_torch.tools.mma_rate

NVIDIA's data sheet gives no rate for b1 products, so the matcher's bound
(`sosvo_torch/tools/bounds.py:B1_OP_PER_S`) rests on this measurement: the
probe kernels of `sosvo_torch/csrc/probes.cu` issue back-to-back tensor-core
products in four forms:
  * mma.sync: 4 independent chains of `m16n8k256 .b1.and.popc` (the
    matcher's instruction) or `m16n8k32 .s8` per warp, 8 warps per block,
    4 blocks per SM;
  * wgmma: `m64n256k256 .b1.and.popc` or `m64n256k32 .s8` with both
    operands in shared memory, two warpgroups per block, one block per SM,
    4 products per commit group with one group in flight.
Operations are counted as the data sheet's int8 rate counts them, two per
multiply-add (per bit pair for b1: a 64 x 256 x 256 product is 8388608).
Time by CUDA events over back-to-back launches after a warm-up; the best of
three repeats. The int8 lines show how near each form comes to the data
sheet's 1979e12 int8 rate; the b1 rate of the bound is the faster of the
two b1 lines.
"""

from __future__ import annotations

import torch

from sosvo_torch.kernels import build
from sosvo_torch.tools.workload import card_info, cuda_ms
from sosvo_torch.utils.device import default_device

# name -> (sosvo_mma_rate's kind, blocks per SM)
KINDS = {"mma.sync int8": (0, 4), "mma.sync b1": (1, 4), "wgmma int8": (2, 1), "wgmma b1": (3, 1)}


def mma_rate(name: str, iters: int = 1024, reps: int = 5) -> float:
    """Operations per second of the throughput loop `name` (a key of KINDS)."""
    default_device()
    device = torch.device("cuda", torch.cuda.current_device())  # the index the launch needs
    lib = build.load()
    kind, per_sm = KINDS[name]
    blocks = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.int32, device=device)
    stream = build.stream_of(device)

    def launch():
        if build.launch(device, lib.sosvo_mma_rate, kind, blocks, iters, out.data_ptr(), stream) != 0:
            raise RuntimeError(f"{name} probe launch failed")

    ms = min(cuda_ms(launch, reps) for _ in range(3))
    return lib.sosvo_mma_rate_ops(kind, blocks, iters) / (ms * 1e-3)


def main() -> None:
    print(f"card: {card_info()}", flush=True)
    b1 = 0.0
    for name in KINDS:
        for iters in (256, 1024):
            rate = mma_rate(name, iters)
            if name.endswith("b1") and iters == 1024:
                b1 = max(b1, rate)
            print(f"{name}: iters={iters} op_per_s={rate:.6e}", flush=True)
    print(f"b1 rate for the bound (the faster b1 form at 1024 iterations): {b1:.6e}", flush=True)


if __name__ == "__main__":
    main()
