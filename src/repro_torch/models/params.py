"""Parameter factory (the port's ``repro.models.params``).

Params are a FLAT dict path -> tensor, with their logical axes in a
parallel dict path -> names (``Initializer.axes``). Scan-stacked layer params carry a
leading "layers" axis. Subtree selection is by path prefix. Paths,
shapes, init kinds and scales are the reference's; the random numbers
are torch's, one generator per path seeded with the path's CRC-32
started from the model seed. On the ``meta`` device the factory allocates nothing and
gives only shapes and dtypes.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Axes = Dict[str, Tuple[Optional[str], ...]]


class Initializer:
    def __init__(self, dtype: torch.dtype, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.dtype = dtype
        self.seed = seed
        self.device = torch.device(device)
        self.params: Params = {}
        self.axes: Axes = {}

    def _gen_for(self, path: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        # the CPU generator keeps 32 bits of a seed: start the path's CRC
        # from the model seed (a bijection for each path) rather than
        # shifting the seed out of reach
        g.manual_seed(zlib.crc32(path.encode(), self.seed & 0xFFFFFFFF))
        return g

    def make(self, path: str, shape: Tuple[int, ...],
             names: Tuple[Optional[str], ...], init: str = "normal",
             scale: Optional[float] = None) -> None:
        """``names`` are the reference's logical axes, one per dim, kept
        in ``self.axes`` (the sharding rules read them)."""
        if len(shape) != len(names):
            raise ValueError(f"{path}: shape {shape} vs axes {names}")
        if path in self.params:
            raise ValueError(f"duplicate param {path}")
        if init not in ("zeros", "ones", "normal", "uniform"):
            raise ValueError(init)
        self.axes[path] = tuple(names)
        kw = dict(dtype=self.dtype, device=self.device)
        if self.device.type == "meta":
            p = torch.empty(shape, **kw)
        elif init == "zeros":
            p = torch.zeros(shape, **kw)
        elif init == "ones":
            p = torch.ones(shape, **kw)
        elif init == "normal":
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            p = torch.randn(shape, generator=self._gen_for(path),
                            device=self.device).mul_(s).to(self.dtype)
        else:  # "uniform", e.g. RG-LRU Lambda
            s = scale if scale is not None else 1.0
            p = torch.rand(shape, generator=self._gen_for(path),
                           device=self.device).mul_(s).to(self.dtype)
        self.params[path] = p


def subtree(params: Params, prefix: str) -> Params:
    pfx = prefix if prefix.endswith("/") else prefix + "/"
    return {k[len(pfx):]: v for k, v in params.items() if k.startswith(pfx)}


def merge(params: Params, prefix: str, sub: Params) -> None:
    pfx = prefix if prefix.endswith("/") else prefix + "/"
    for k, v in sub.items():
        params[pfx + k] = v
