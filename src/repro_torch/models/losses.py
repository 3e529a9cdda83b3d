"""Training losses: masked cross-entropy (+ router aux/z losses), the
port of ``repro.models.losses``. The MoE layers' aux losses (summed over
the stack by ``transformer.forward``) enter as their mean per MoE layer,
weighted by ``cfg.router_aux_weight`` and ``cfg.router_z_weight``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V), labels (B, S) int; labels < 0 are masked.
    Returns (sum of the fp32 negative log-likelihoods, n_valid fp32)."""
    mask = labels >= 0
    lbl = labels.clamp_min(0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lbl[..., None])[..., 0]
    nll = (lse - ll) * mask
    return nll.sum(), mask.sum().float()


def total_loss(logits: torch.Tensor, labels: torch.Tensor,
               aux: Dict[str, torch.Tensor], cfg
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce_sum, n = cross_entropy(logits, labels)
    ce = ce_sum / n.clamp_min(1.0)
    loss = ce
    metrics = {"ce": ce, "n_tokens": n}
    if aux:
        n_moe = max(sum(1 for k in cfg.block_pattern if k == "moe"), 1)
        scale = 1.0 / (n_moe * max(cfg.n_cycles, 1) + n_moe * cfg.n_rem)
        if "load_balance" in aux:
            lb = aux["load_balance"] * scale
            loss = loss + cfg.router_aux_weight * lb
            metrics["load_balance"] = lb
        if "router_z" in aux:
            rz = aux["router_z"] * scale
            loss = loss + cfg.router_z_weight * rz
            metrics["router_z"] = rz
    metrics["loss"] = loss
    return loss, metrics
