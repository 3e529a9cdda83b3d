"""Mixture-of-experts FFN with capacity-based dispatch (the port of
``repro.models.layers.moe``).

Tokens-choose-top-k routing into per-expert capacity buffers (E, C, d);
the experts run as one grouped product (``torch.bmm`` over E), so the
expert compute is 2·E·C·d·f and dispatch / combine are copies. Top-k
gates renormalised, the Switch load-balance loss, the router z-loss, and
the optional parallel dense FFN (Arctic's dense-MoE hybrid) and shared
expert (Llama-4), as in the reference.

Determinism: an assignment that overflows its expert's capacity is
dropped (the reference adds it to a waste row that is thrown away). The
kept assignments have unique slots, so dispatch writes only those rows
(``index_copy_``), never an atomic sum: the same inputs give the same
bits on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers.mlp import _act, init_mlp, mlp


def init_moe(ini, pfx: str, cfg, stack: int = 0) -> None:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("router", (d, e), ("embed", "experts"))
    mk("w_in", (e, d, f), ("experts", "embed", "expert_mlp"))
    if cfg.mlp_gated:
        mk("w_gate", (e, d, f), ("experts", "embed", "expert_mlp"))
    mk("w_out", (e, f, d), ("experts", "expert_mlp", "embed"))
    if cfg.moe_dense_residual:
        init_mlp(ini, f"{pfx}/dense", cfg, stack=stack)
    if cfg.shared_expert:
        init_mlp(ini, f"{pfx}/shared", cfg, stack=stack)


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, ties to the lower index (``jax.lax.top_k``'s order; a stable
    descending sort gives it on every device)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Dict[str, torch.Tensor], xf: torch.Tensor, cfg):
    """Router of tokens xf (t, d): the fp32 logits (t, E) of a product in
    the activation dtype, the softmax, the top-k gates renormalised (floor
    1e-9) and their experts (t, k), and the aux losses."""
    e = cfg.n_experts
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance: E * sum_e (frac tokens to e) * (mean prob e)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(0)
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return gate, idx, aux


def slots(idx: torch.Tensor, cap: int, e: int):
    """Each assignment's position in its expert's buffer, counted over the
    token-major flattening of (t, k): (keep (t*k,) bool, slot (t*k,) with
    E*C for the dropped ones)."""
    flat = idx.reshape(-1)
    oh = torch.nn.functional.one_hot(flat, e).to(torch.int32)
    before = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    pos = before.gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos, torch.full_like(flat, e * cap))
    return keep, slot


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux_losses)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = capacity(cfg, t)
    dt = x.dtype
    xf = x.reshape(t, d)
    gate, idx, aux = route(p, xf, cfg)
    keep, slot = slots(idx, cap, e)

    # dispatch: the kept assignments into (E*C, d), the rest dropped
    kept = keep.nonzero()[:, 0]
    buf = torch.zeros((e * cap, d), dtype=dt, device=x.device)
    buf = buf.index_copy(0, slot[kept], xf[kept // k])
    buf = buf.view(e, cap, d)

    # expert FFN (grouped product over the experts)
    h = torch.bmm(buf, p["w_in"].to(dt))
    if cfg.mlp_gated:
        h = _act(cfg.act)(torch.bmm(buf, p["w_gate"].to(dt))) * h
    else:
        h = _act(cfg.act)(h)
    out = torch.bmm(h, p["w_out"].to(dt)).reshape(e * cap, d)

    # combine: gather the slots back, weight by gate * keep in the
    # activation dtype, sum over k in that dtype
    gathered = torch.where(keep[:, None], out[slot.clamp_max(e * cap - 1)],
                           torch.zeros((), dtype=dt, device=x.device))
    w = (gate.reshape(-1) * keep).to(dt)[:, None]
    y = (gathered * w).reshape(t, k, d).sum(1).reshape(b, s, d)

    if cfg.moe_dense_residual:
        y = y + mlp({kk[len("dense/"):]: v for kk, v in p.items()
                     if kk.startswith("dense/")}, x, cfg)
    if cfg.shared_expert:
        y = y + mlp({kk[len("shared/"):]: v for kk, v in p.items()
                     if kk.startswith("shared/")}, x, cfg)
    return y, aux
