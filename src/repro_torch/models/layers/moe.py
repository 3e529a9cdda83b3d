"""Mixture-of-experts FFN with capacity-based dispatch (the port of
``repro.models.layers.moe``).

Tokens-choose-top-k routing into per-expert capacity buffers (E, C, d);
the experts run as one grouped product (``torch.bmm`` over E), so the
expert compute is 2·E·C·d·f and dispatch / combine are copies. Top-k
gates renormalised, the Switch load-balance loss, the router z-loss, and
the optional parallel dense FFN (Arctic's dense-MoE hybrid) and shared
expert (Llama-4), as in the reference.

Determinism: an assignment that overflows its expert's capacity goes
to a waste row that is thrown away, as in the reference. The kept
assignments have unique slots, so dispatch copies rows
(``index_copy``) and never sums: the same inputs give the same bits on
the card. Every shape is fixed by the config and the token count (no
``nonzero``), so the layer traces under ``FakeTensorMode`` and syncs
with the host nowhere.

On a mesh the routing, dispatch and combine run on every rank over all
tokens (the tokens gathered, the slots replicated), the expert buffers
are pinned to (experts over 'model', capacity over 'data') as the
reference pins them, and the output to the batch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers.mlp import _act, init_mlp, mlp
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain


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


def dispatch(xf: torch.Tensor, router: torch.Tensor, cfg):
    """Tokens xf (t, d) into the expert buffers (E, C, d): each kept
    assignment's token copied to its slot, the dropped ones to a waste
    row (E*C) that is cut off. Returns (buffers, gate, keep, slot, aux)
    for ``combine``."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    gate, idx, aux = route({"router": router}, xf, cfg)
    keep, slot = slots(idx, cap, e)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_copy(0, slot, xf.repeat_interleave(k, dim=0))
    return buf[:-1].view(e, cap, d), gate, keep, slot, aux


def combine(out: torch.Tensor, gate: torch.Tensor, keep: torch.Tensor,
            slot: torch.Tensor, k: int) -> torch.Tensor:
    """The experts' outputs (E, C, d) back to the tokens (t, d): each
    assignment's slot gathered, weighted by gate * keep in the activation
    dtype, summed over its k in that dtype."""
    ec, d = out.shape[0] * out.shape[1], out.shape[2]
    out = out.reshape(ec, d)
    gathered = torch.where(keep[:, None], out[slot.clamp_max(ec - 1)],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
    w = (gate.reshape(-1) * keep).to(out.dtype)[:, None]
    return (gathered * w).reshape(-1, k, d).sum(1)


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux_losses)."""
    b, s, d = x.shape
    k = cfg.top_k
    dt = x.dtype
    xf = x.reshape(b * s, d)
    router = p["router"]
    if sdt.is_dtensor(x):
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * x.device_mesh.ndim
        buf, gate, keep, slot, aux_v = sdt.local(
            lambda xl, rl: _dispatch_flat(xl, rl, cfg), x.device_mesh,
            (rep,) * 5, (rep, rep))(xf, router)
        aux = {"load_balance": aux_v[0], "router_z": aux_v[1]}
    else:
        buf, gate, keep, slot, aux = dispatch(xf, router, cfg)
    buf = constrain(buf, "act_experts", "act_capacity", None)

    # expert FFN (grouped product over the experts)
    h = torch.bmm(buf, p["w_in"].to(dt))
    if cfg.mlp_gated:
        h = _act(cfg.act)(torch.bmm(buf, p["w_gate"].to(dt))) * h
    else:
        h = _act(cfg.act)(h)
    h = constrain(h, "act_experts", "act_capacity", None)
    out = constrain(torch.bmm(h, p["w_out"].to(dt)), "act_experts",
                    "act_capacity", None)

    if sdt.is_dtensor(out):
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * out.device_mesh.ndim
        y = sdt.local(lambda *a: combine(*a, k), out.device_mesh, rep,
                      (rep,) * 4)(out, gate, keep, slot)
    else:
        y = combine(out, gate, keep, slot, k)
    y = y.reshape(b, s, d)

    if cfg.moe_dense_residual:
        y = y + mlp({kk[len("dense/"):]: v for kk, v in p.items()
                     if kk.startswith("dense/")}, x, cfg)
    if cfg.shared_expert:
        y = y + mlp({kk[len("shared/"):]: v for kk, v in p.items()
                     if kk.startswith("shared/")}, x, cfg)
    return constrain(y, "act_batch", "act_seq", "act_embed"), aux


def _dispatch_flat(xf, router, cfg):
    """``dispatch`` with its aux losses as one (2,) tensor (a local
    function's outputs are tensors)."""
    buf, gate, keep, slot, aux = dispatch(xf, router, cfg)
    return buf, gate, keep, slot, torch.stack(
        [aux["load_balance"], aux["router_z"]])
