"""Normalization layers (fp32 internals regardless of activation dtype)."""
from __future__ import annotations

import torch


def init_rmsnorm(ini, path: str, d: int, stack: int = 0) -> None:
    shape, names = (d,), ("embed",)
    if stack:
        shape, names = (stack,) + shape, ("layers",) + names
    ini.make(path, shape, names, init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
