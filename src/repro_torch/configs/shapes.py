"""Model-input batches (the port of ``repro.configs.shapes``): abstract
specs for the dry run (``meta`` tensors: shapes and dtypes, no memory)
with their logical axes, and concrete batches for smoke runs, tests and
examples, drawn from a ``torch.Generator``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import InputShape, ModelConfig

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Abstract model-input batch for (cfg, shape), on the meta device.

    train/prefill: full sequences; decode: one new token per sequence.
    Embedding-input archs (audio/vlm) get frontend-stub embeddings;
    decode reads the conditioning k/v cached at prefill, so it has no
    ``cond``."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    act = dict(dtype=cfg.torch_dtype, device=META)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.input_kind == "tokens":
        batch["tokens"] = torch.empty((b, s), **i32)
    else:
        batch["embeddings"] = torch.empty((b, s, cfg.d_model), **act)
    if shape.kind == "train":
        batch["labels"] = torch.empty((b, s), **i32)
    if cfg.cross_attn and shape.kind != "decode":
        batch["cond"] = torch.empty((b, cfg.cond_len, cfg.d_model), **act)
    if cfg.pos_kind == "mrope":
        batch["mrope_positions"] = torch.empty((3, b, s), **i32)
    return batch


BATCH_AXES = {
    "tokens": ("act_batch", None),
    "labels": ("act_batch", None),
    "embeddings": ("act_batch", None, None),
    "cond": ("act_batch", None, None),
    "mrope_positions": (None, "act_batch", None),
}


def batch_axes(batch) -> Dict[str, Tuple]:
    return {k: BATCH_AXES[k] for k in batch}


def concrete_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                   gen: torch.Generator, kind: str = "train",
                   vocab: Optional[int] = None, device="cuda"
                   ) -> Dict[str, torch.Tensor]:
    """train/prefill: full sequences; decode: one token per sequence.
    Embedding-input archs get frontend-stub embeddings (0.02·normal in
    ``cfg.dtype``), cross-attention archs a conditioning sequence of
    ``cfg.cond_len`` (the same draw), M-RoPE archs position ids (3, B, S)
    = 0..S-1 on every stream (decode: 0, the reference's batch; the
    model's forward derives them from ``cur_len`` when none is passed).

    Draws on ``gen``'s device (the CPU for a default generator), then
    moves the batch to ``device``, so a seed gives the same batch on
    every machine."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}")
    dev = resolve_device(device)
    vocab = vocab or cfg.vocab_size
    s = 1 if kind == "decode" else seq_len
    batch = {}
    if cfg.input_kind == "tokens":
        batch["tokens"] = torch.randint(0, vocab, (batch_size, s),
                                        generator=gen, dtype=torch.int32)
    else:
        batch["embeddings"] = 0.02 * torch.randn(
            (batch_size, s, cfg.d_model), generator=gen).to(cfg.torch_dtype)
    if kind == "train":
        batch["labels"] = torch.randint(0, vocab, (batch_size, s),
                                        generator=gen, dtype=torch.int32)
    if cfg.cross_attn:
        batch["cond"] = 0.02 * torch.randn(
            (batch_size, cfg.cond_len, cfg.d_model),
            generator=gen).to(cfg.torch_dtype)
    if cfg.pos_kind == "mrope":
        pos = torch.arange(s, dtype=torch.int32)[None].expand(batch_size, s)
        batch["mrope_positions"] = torch.stack([pos, pos, pos])
    return {k: v.to(dev) for k, v in batch.items()}
