"""Normalization layers (fp32 internals regardless of activation dtype)."""
from __future__ import annotations

import torch

from repro_torch.sharding import dtensor as sdt


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


def groupnorm_heads(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    n_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group per head over the last dim (RWKV6 'ln_x').
    x: (..., H*dh). The variance is the population one (``jnp.var``):
    torch's default ``var`` is the unbiased estimate, hence
    ``correction=0``."""
    shp = x.shape
    xh = sdt.split_last(x, (n_heads, shp[-1] // n_heads)).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    y = sdt.pinned(((xh - mu) / torch.sqrt(var + eps)).reshape(shp))
    return (y * scale.float() + bias.float()).to(x.dtype)
