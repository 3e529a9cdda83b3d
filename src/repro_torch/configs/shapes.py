"""Concrete model-input batches for smoke runs, tests and examples,
drawn from a ``torch.Generator`` (the port's counterpart of
``repro.configs.shapes.concrete_batch``; the dry-run's abstract specs
wait for the mesh tooling)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def concrete_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                   gen: torch.Generator, kind: str = "train",
                   vocab: Optional[int] = None, device="cuda"
                   ) -> Dict[str, torch.Tensor]:
    """train/prefill: full sequences; decode: one token per sequence.

    Draws on ``gen``'s device (the CPU for a default generator), then
    moves the batch to ``device``, so a seed gives the same batch on
    every machine."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}")
    if cfg.input_kind != "tokens" or cfg.cross_attn or cfg.pos_kind == "mrope":
        raise NotImplementedError(
            "embedding inputs, conditioning and M-RoPE positions wait for "
            "a later slice (ROADMAP.md)")
    dev = resolve_device(device)
    vocab = vocab or cfg.vocab_size
    s = 1 if kind == "decode" else seq_len
    batch = {"tokens": torch.randint(0, vocab, (batch_size, s), generator=gen,
                                     dtype=torch.int32)}
    if kind == "train":
        batch["labels"] = torch.randint(0, vocab, (batch_size, s),
                                        generator=gen, dtype=torch.int32)
    return {k: v.to(dev) for k, v in batch.items()}
