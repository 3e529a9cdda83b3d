"""Public model API: init / forward / prefill / decode_step.

Everything is functional over a flat params dict; `Model` binds a
ModelConfig and the kernel route: ``impl="pallas"`` (default) sends the
sequence kernels of a tensor on the card to the hand-written CUDA
kernels, ``impl="xla"`` to their plain PyTorch versions. The training
loss waits for a later slice.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as pp
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


class Model:
    def __init__(self, cfg: ModelConfig, impl: str = "pallas"):
        if impl not in ("pallas", "xla"):
            raise ValueError(f"impl {impl!r}: 'pallas' or 'xla'")
        self.cfg = cfg
        self.impl = impl

    # ---- parameters ----
    def init(self, seed: int = 0, device="cuda") -> pp.Params:
        ini = pp.Initializer(self.cfg.param_torch_dtype, seed=seed,
                             device=resolve_device(device))
        tfm.init_model(ini, self.cfg)
        return ini.params

    def abstract_params(self) -> pp.Params:
        """Params on the ``meta`` device: shapes and dtypes, no memory."""
        ini = pp.Initializer(self.cfg.param_torch_dtype, device="meta")
        tfm.init_model(ini, self.cfg)
        return ini.params

    def num_params(self) -> int:
        return sum(math.prod(v.shape) for v in self.abstract_params().values())

    # ---- full sequence ----
    def forward_train(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Logits (B, S, V) in fp32 and the aux losses (none for the
        ported block kinds)."""
        x, _ = tfm.forward(params, self.cfg, mode="train",
                           tokens=batch["tokens"], impl=self.impl)
        return tfm.logits_from_hidden(params, x, self.cfg), {}

    # ---- serving ----
    def prefill(self, params, batch):
        """Full-sequence forward; returns (last_logits (B, V), cache)."""
        x, cache = tfm.forward(params, self.cfg, mode="prefill",
                               tokens=batch["tokens"], impl=self.impl)
        logits = tfm.logits_from_hidden(params, x[:, -1:], self.cfg)
        return logits[:, 0], cache

    def decode_step(self, params, batch, cache, cur_len: int):
        """One-token decode (serve_step): batch["tokens"] is (B, 1) at
        position ``cur_len``. Returns (logits (B, V), cache); the cache's
        tensors are updated in place."""
        x, new_cache = tfm.forward(params, self.cfg, mode="decode",
                                   tokens=batch["tokens"], cur_len=cur_len,
                                   cache=cache, impl=self.impl)
        logits = tfm.logits_from_hidden(params, x, self.cfg)
        return logits[:, 0], new_cache

    # ---- caches ----
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return tfm.init_cache(self.cfg, batch, max_len,
                              device=resolve_device(device))

    def extend_cache(self, cache, max_len: int):
        """A prefill cache moved into a ``max_len`` decode cache."""
        return tfm.extend_cache(self.cfg, cache, max_len)
