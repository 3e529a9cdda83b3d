"""Training losses: masked cross-entropy (+ router aux/z losses), the
port of ``repro.models.losses``. The MoE layers' aux losses (summed over
the stack by ``transformer.forward``) enter as their mean per MoE layer,
weighted by ``cfg.router_aux_weight`` and ``cfg.router_z_weight``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.sharding import dtensor as sdt


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V), labels (B, S) int; labels < 0 are masked.
    Returns (sum of the fp32 negative log-likelihoods, n_valid fp32)."""
    mask = labels >= 0
    lbl = labels.clamp_min(0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = label_logits(logits, lbl)
    nll = (lse - ll) * mask
    return nll.sum(), mask.sum().float()


def label_logits(logits: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """logits[..., lbl]: each position's logit of its label. DTensor
    logits sharded over the vocabulary gather on each rank from its own
    shard (0 where the label lies elsewhere) into a partial sum."""
    if not sdt.is_dtensor(logits):
        return torch.gather(logits, -1, lbl[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    x_pl = [p if isinstance(p, Shard) else Replicate()
            for p in logits.placements]
    l_pl = [Replicate() if p == Shard(last) else p for p in x_pl]
    o_pl = [Partial() if p == Shard(last) else p for p in x_pl]
    vdims = [i for i, p in enumerate(x_pl) if p == Shard(last)]

    def fn(xl, ll):
        lo = sdt.coord(mesh, vdims) * xl.shape[-1]
        inside = (ll >= lo) & (ll < lo + xl.shape[-1])
        idx = torch.where(inside, ll - lo, 0)
        got = torch.gather(xl, -1, idx[..., None])[..., 0]
        return torch.where(inside, got, 0.0)
    return sdt.local(fn, mesh, o_pl, (x_pl, l_pl), (x_pl, l_pl))(logits,
                                                                lbl)


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
