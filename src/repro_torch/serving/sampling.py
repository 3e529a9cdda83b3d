"""Token sampling strategies for serving (greedy / temperature / top-k /
nucleus), the port of ``repro.serving.sampling`` with an explicit
``torch.Generator`` in place of the reference's key."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           *, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0
           ) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32. temperature <= 0 is greedy
    (argmax, the first of tied maxima). Otherwise the logits are scaled by
    1 / temperature in fp32; top-k masks every logit below the k-th
    largest (ties with it stay); nucleus keeps the logits at or above the
    reference's cutoff, the sorted logit at index sum(cumsum(softmax(
    sorted descending)) < top_p); the draw is a categorical over what is
    left, from ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p; an index past the end
        # (cum rounds below top_p) masks nothing, as the reference's gather
        cutoff_idx = torch.sum(cum < top_p, dim=-1).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
