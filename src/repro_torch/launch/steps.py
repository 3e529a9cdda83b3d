"""The serving steps shared by the launchers (the serving half of the
port's ``repro.launch.steps``). PyTorch runs eagerly, so a step is the
plain function; the mesh and sharding artifacts of the reference wait
for the mesh tooling, and the train step for the training slice
(ROADMAP.md)."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch, cur_len: int):
        logits, new_cache = model.decode_step(params, batch, cache, cur_len)
        # greedy next token (sampling is the server loop's business)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache
    return serve_step
