"""The device an entry point uses when its caller names none: the CUDA card.

The port runs on the card. A caller that wants the CPU (the parity tests, a
rehearsal) passes `device="cpu"`; nothing here falls back to it.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """`torch.device("cuda")`; raises where no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError("sosvo_torch runs on a CUDA device and none is available; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve(device: torch.device | str | None) -> torch.device | str:
    """`device`, or the card where it is None."""
    return default_device() if device is None else device
