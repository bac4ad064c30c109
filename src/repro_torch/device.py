"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless its caller names another device.
Nothing falls back to the CPU silently: asking for the card where there is
none is an error.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (default: the CUDA card).

    Raises ``RuntimeError`` when the card is asked for (explicitly or by
    default) and CUDA is unavailable; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU):
    the end of a timed region on the host clock."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
