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

On a mesh whose ranks hold their own token rows (the train step and the
prefill: the rows over the ``act_batch`` axes), each rank routes,
dispatches and combines its own tokens (``sharded_dispatch``,
``sharded_combine``) into the reference's expert buffers, (experts
over 'model', capacity over 'data'), replicated over 'pod':

* the router product runs on the rank's tokens and its own expert
  columns, and the fp32 logits are gathered over 'model' for the softmax
  and the top-k;
* an assignment's position in its expert is its count over the
  token-major order of all the microbatch's tokens, as in one process:
  the rank's own count plus the per-expert counts of the token blocks
  before it (an all-gather of (E,) int32 counts), so ``keep`` and
  ``slot`` are the one-process values bit for bit and the capacity is
  the microbatch's;
* each rank copies its kept rows bound for its own experts into a zero
  (E/M, C, d) buffer, a partial sum over the token ranks with one
  contributor a slot, reduced onto the tiles (a reduce-scatter over
  'data', then a sum over 'pod');
* the combine gathers the experts' outputs over 'data', takes its
  tokens' slots of its own experts, and sums the gate-weighted partials
  over 'model'; the aux losses are partial sums over the token ranks.

Tokens that every rank holds whole (the decode under its rule override,
or a microbatch whose rows the data ranks do not divide) are routed on
every rank over all of them, as the reference replicates them there.
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


def slots(idx: torch.Tensor, cap: int, e: int, earlier=None):
    """Each assignment's position in its expert's buffer, counted over the
    token-major flattening of (t, k): (keep (t*k,) bool, slot (t*k,) with
    E*C for the dropped ones). ``earlier`` (E,) int32 are the counts of
    assignments to each expert that come before these tokens (the
    earlier token blocks of a sharded microbatch); None: none."""
    flat = idx.reshape(-1)
    oh = torch.nn.functional.one_hot(flat, e).to(torch.int32)
    before = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    if earlier is not None:
        before = before + earlier
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
    router = p["router"]
    rows = _token_dims(x)
    if rows:
        xf = _rows_only(x, rows).reshape(b * s, d)
        buf, routed, aux = sharded_dispatch(xf, router, cfg)
    elif sdt.is_dtensor(x):
        from torch.distributed.tensor import Replicate
        xf = x.reshape(b * s, d)
        rep = [Replicate()] * x.device_mesh.ndim
        buf, gate, keep, slot, aux_v = sdt.local(
            lambda xl, rl: _dispatch_flat(xl, rl, cfg), x.device_mesh,
            (rep,) * 5, (rep, rep))(xf, router)
        aux = {"load_balance": aux_v[0], "router_z": aux_v[1]}
    else:
        xf = x.reshape(b * s, d)
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

    if rows:
        y = sharded_combine(out, routed, k)
    elif sdt.is_dtensor(out):
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


# ---- each rank its own tokens (rows sharded over the act_batch axes) ----

def _token_dims(x) -> Tuple[int, ...]:
    """The mesh dims that shard a DTensor's rows (dim 0): its token
    blocks. None of them (a plain tensor, or rows whole on every rank)
    routes every token on every rank."""
    if not sdt.is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(i for i, pl in enumerate(x.placements) if pl == Shard(0))


def _rows_only(x, rows):
    """``x`` with its rows sharded over mesh ``rows`` and whole along every
    other dim and mesh dim (a sequence shard gathered, so each rank's
    tokens are one block of the token-major order)."""
    from torch.distributed.tensor import Replicate, Shard
    pls = [Shard(0) if i in rows else Replicate()
           for i in range(x.device_mesh.ndim)]
    return x if pls == list(x.placements) else x.redistribute(
        x.device_mesh, pls)


def sharded_dispatch(xf, router, cfg):
    """``dispatch`` of tokens xf (t, d), a DTensor whose rows are sharded
    (its other dims whole): the expert buffers (E, C, d) as a DTensor on
    the rules' tiles, the routing ``sharded_combine`` needs (the gates
    (t, k) as a DTensor; this rank's ``keep`` and ``slot``, the
    one-process values of its assignments, and its own assignments' rows
    in the buffers of its experts), and the aux losses over all t
    tokens. See the module docstring."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.sharding.rules import sharding_for
    mesh = xf.device_mesh
    rows = _token_dims(xf)
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    n = mesh.ndim
    tile = sharding_for((e, cap, d), ("act_experts", "act_capacity", None),
                        mesh)
    # mesh dims that split the experts (and not the tokens)
    experts = tuple(i for i in range(n) if i not in rows
                    and tile[i] == Shard(0))
    rep = [Replicate()] * n
    tok = [Shard(0) if i in rows else Replicate() for i in range(n)]
    part = [Partial() if i in rows else Replicate() for i in range(n)]

    # router: each rank's tokens on its own expert columns, the fp32
    # logits then gathered over those columns' mesh dims
    logits = sdt.contract(lambda a, w: (a @ w.to(a.dtype)).float(), xf,
                          router)

    def route_rows(lg):
        probs = torch.softmax(lg, dim=-1)
        gate, idx = top_k(probs, k)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        first = torch.nn.functional.one_hot(idx[:, 0], e).float()
        counts = torch.nn.functional.one_hot(idx.reshape(-1), e).sum(
            0, dtype=torch.int32)
        return (gate, idx, probs.sum(0) / t, first.sum(0) / t,
                (torch.logsumexp(lg, dim=-1) ** 2).sum() / t, counts[None])
    gate, idx, me, ce, z, counts = sdt.local(
        route_rows, mesh, (tok, tok, part, part, part, tok), (tok,))(logits)
    # Switch load-balance: E * sum_e (frac tokens to e) * (mean prob e)
    aux = {"load_balance": e * torch.sum(me.redistribute(mesh, rep)
                                         * ce.redistribute(mesh, rep)),
           "router_z": z.redistribute(mesh, rep)}

    # positions over all the microbatch's tokens: this block's counts
    # after those of the blocks before it
    block = sdt.coord(mesh, rows)
    every = counts.redistribute(mesh, rep).to_local()
    earlier = every[:block].sum(0, dtype=torch.int32)
    keep, slot = slots(idx.to_local(), cap, e, earlier)

    # this rank's kept assignments to its own experts, as rows of its
    # (E/M * C + 1, d) buffer (the last one the waste row)
    e_loc = e
    for i in experts:
        e_loc //= mesh.size(i)
    e0 = sdt.coord(mesh, experts) * e_loc
    flat = idx.to_local().reshape(-1)
    mine = keep & (flat >= e0) & (flat < e0 + e_loc)
    local_slot = torch.where(mine, slot - e0 * cap,
                             torch.full_like(slot, e_loc * cap))

    def scatter(xl):
        buf = torch.zeros((e_loc * cap + 1, d), dtype=xl.dtype,
                          device=xl.device)
        buf = buf.index_copy(0, local_slot, xl.repeat_interleave(k, dim=0))
        return buf[:-1].view(e_loc, cap, d)
    own = [Partial() if i in rows else Shard(0) if i in experts
           else Replicate() for i in range(n)]
    x_grad = [Shard(0) if i in rows else Partial() if i in experts
              else Replicate() for i in range(n)]
    buf = sdt.local(scatter, mesh, own, (tok,), (x_grad,))(xf)
    # the partial sums reduced onto the tiles: first where the tile
    # shards (a reduce-scatter), then the rest (a sum of the tile)
    first = [tile[i] if isinstance(pl, Partial) and isinstance(tile[i], Shard)
             else pl for i, pl in enumerate(own)]
    if first != own:
        buf = buf.redistribute(mesh, first)
    buf = constrain(buf, "act_experts", "act_capacity", None)
    routed = dict(gate=gate, keep=keep, slot=slot, mine=mine,
                  local_slot=local_slot, rows=rows, experts=experts)
    return buf, routed, aux


def sharded_combine(out, routed, k):
    """``combine`` for ``sharded_dispatch``'s tokens: the experts' outputs
    (E, C, d) whole along the capacity on every rank, each rank's tokens'
    slots in its own experts weighted by their gates, the partials summed
    over the experts' mesh dims. y (t, d) with its rows sharded as the
    tokens were."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = out.device_mesh
    n = mesh.ndim
    rows, experts = routed["rows"], routed["experts"]
    mine, local_slot = routed["mine"], routed["local_slot"]
    whole = [Shard(0) if i in experts else Replicate() for i in range(n)]
    tok = [Shard(0) if i in rows else Replicate() for i in range(n)]

    def gather(ol, gl):
        e_loc, cap, d = ol.shape
        flat = ol.reshape(e_loc * cap, d)
        got = torch.where(mine[:, None],
                          flat[local_slot.clamp_max(e_loc * cap - 1)],
                          torch.zeros((), dtype=ol.dtype, device=ol.device))
        w = (gl.reshape(-1) * mine).to(ol.dtype)[:, None]
        return (got * w).reshape(-1, k, d).sum(1)
    y = sdt.local(
        gather, mesh,
        [Shard(0) if i in rows else Partial() if i in experts
         else Replicate() for i in range(n)],
        (whole, tok),
        ([Partial() if i in rows else Shard(0) if i in experts
          else Replicate() for i in range(n)],
         [Shard(0) if i in rows else Partial() if i in experts
          else Replicate() for i in range(n)]))(out, routed["gate"])
    return y.redistribute(mesh, tok)
