"""Where the port's entry points make their tensors."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point makes its tensors on. Asking for the
    card on a machine without one raises; nothing moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
