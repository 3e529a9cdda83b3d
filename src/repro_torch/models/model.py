"""Public model API: init / loss / prefill / decode_step.

Everything is functional over a flat params dict; `Model` binds a
ModelConfig and the kernel route: ``impl="pallas"`` (default) sends the
sequence kernels of a tensor on the card to the hand-written CUDA
kernels (with their backward kernels), ``impl="xla"`` to their plain
PyTorch versions.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import params as pp
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.losses import total_loss


def mean_metrics(per):
    """The mean of each metric over a list of metric dicts."""
    return {k: torch.stack([m[k] for m in per]).mean() for k in per[0]}


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
    def _inputs(self, batch) -> Dict:
        """The model inputs of a batch: tokens or embeddings, and cond and
        mrope_positions where the config takes them."""
        return {k: batch.get(k) for k in ("tokens", "embeddings", "cond",
                                          "mrope_positions")}

    def forward_train(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Logits (B, S, V) in fp32 and the aux losses (each MoE layer's
        load-balance and router z-loss summed over the stack; {} for a
        model without MoE layers)."""
        x, _, aux = tfm.forward(params, self.cfg, mode="train",
                                impl=self.impl, **self._inputs(batch))
        return tfm.logits_from_hidden(params, x, self.cfg), aux

    def loss_fn(self, params, batch):
        """(loss, metrics) of a batch {tokens, labels}, differentiable in
        the params. A batch larger than ``cfg.microbatch`` is the mean
        over its microbatches (``_loss_accum``)."""
        cfg = self.cfg
        if cfg.microbatch and batch["labels"].shape[0] > cfg.microbatch:
            return self._loss_accum(params, batch)
        logits, aux = self.forward_train(params, batch)
        return total_loss(logits, batch["labels"], aux, cfg)

    def microbatches(self, batch):
        """The batch as ``cfg.microbatch``-row pieces (the whole batch
        when it is not larger); ``mrope_positions`` (3, B, S) is split on
        its batch axis, 1."""
        b = batch["labels"].shape[0]
        mb = self.cfg.microbatch
        if not mb or b <= mb:
            return [batch]
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of the "
                             f"microbatch {mb}")
        return [{k: (v[:, i:i + mb] if k == "mrope_positions"
                     else v[i:i + mb]) for k, v in batch.items()}
                for i in range(0, b, mb)]

    def _loss_accum(self, params, batch):
        """The reference's microbatch loss: the mean of the microbatches'
        losses, metrics averaged over them. As one expression it keeps
        every microbatch's graph alive until its backward; the train step
        (``launch.steps.loss_and_grads``) backpropagates a microbatch at
        a time instead."""
        per = [self.loss_fn(params, mb) for mb in self.microbatches(batch)]
        return (sum(loss for loss, _ in per) / len(per),
                mean_metrics([m for _, m in per]))

    # ---- serving ----
    def prefill(self, params, batch):
        """Full-sequence forward; returns (last_logits (B, V), cache)."""
        x, cache, _ = tfm.forward(params, self.cfg, mode="prefill",
                                  impl=self.impl, **self._inputs(batch))
        logits = tfm.logits_from_hidden(params, x[:, -1:], self.cfg)
        return logits[:, 0], cache

    def decode_step(self, params, batch, cache, cur_len):
        """One-token decode (serve_step): batch carries tokens (B, 1) or
        embeddings (B, 1, d) at position ``cur_len`` (and optionally cond
        and mrope_positions (3, B, 1)). ``cur_len`` is an int, every row
        at that position, or a (B,) int tensor on the cache's device, each
        row at its own position (its k/v written at its own index, its
        mask its own; the continuous batcher's slots). Returns (logits
        (B, V), cache); the cache's tensors are updated in place."""
        x, new_cache, _ = tfm.forward(params, self.cfg, mode="decode",
                                      cur_len=cur_len, cache=cache,
                                      impl=self.impl, **self._inputs(batch))
        logits = tfm.logits_from_hidden(params, x, self.cfg)
        return logits[:, 0], new_cache

    # ---- caches ----
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return tfm.init_cache(self.cfg, batch, max_len,
                              device=resolve_device(device))

    def extend_cache(self, cache, max_len: int):
        """A prefill cache moved into a ``max_len`` decode cache."""
        return tfm.extend_cache(self.cfg, cache, max_len)
