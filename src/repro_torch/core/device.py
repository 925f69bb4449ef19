"""Where the port's entry points run: on the card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Asking for a CUDA device where there is none
    raises: the port never carries on on the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device (a no-op on the CPU): what a device-boundary
    timer needs before it reads the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
