"""Synthetic token/embedding data (the port of
``repro.data.synthetic``).

A random bigram Markov chain with Zipf-ish marginals, so the train
driver shows real loss decrease (a uniform stream plateaus at ln V).
The stream is drawn with numpy exactly as the reference draws it, so a
seed gives the reference's tokens bit for bit; the tensors go to an
explicit device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


class BigramTask:
    """Markov-chain language over `vocab` tokens; low-entropy transitions
    make next-token prediction learnable."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = branching
        # each token transitions to `branching` successors
        self.successors = rng.integers(0, vocab, size=(vocab, branching),
                                       dtype=np.int32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            choice = rng.integers(0, self.branching, size=batch)
            toks[:, t + 1] = self.successors[toks[:, t], choice]
        return toks


def token_batches(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                  task: Optional[BigramTask] = None, device="cuda"
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of {tokens, labels} int32 on ``device`` (+ the
    reference's stub inputs for embedding-input, conditioned and M-RoPE
    archs: embeddings and cond in ``cfg.dtype``, M-RoPE positions
    (3, B, S) int32)."""
    dev = resolve_device(device)
    task = task or BigramTask(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    emb_rng = np.random.default_rng(seed + 2)

    def t(x, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(x))
        return out.to(device=dev, dtype=dtype or out.dtype)

    while True:
        toks = task.sample(rng, batch, seq)
        out: Dict[str, torch.Tensor] = {}
        if cfg.input_kind == "tokens":
            out["tokens"] = t(toks[:, :-1])
        else:
            # frontend stub: embeddings correlated with token ids
            e = emb_rng.normal(size=(batch, seq, cfg.d_model)) * 0.02
            out["embeddings"] = t(e, cfg.torch_dtype)
        out["labels"] = t(toks[:, 1:])
        if cfg.cross_attn:
            c = emb_rng.normal(size=(batch, cfg.cond_len, cfg.d_model)) * 0.02
            out["cond"] = t(c, cfg.torch_dtype)
        if cfg.pos_kind == "mrope":
            pos = torch.arange(seq, dtype=torch.int32, device=dev)
            pos = pos[None].expand(batch, seq)
            out["mrope_positions"] = torch.stack([pos, pos, pos])
        yield out
