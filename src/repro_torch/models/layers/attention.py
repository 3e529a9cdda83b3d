"""Grouped-query attention: causal, sliding-window, cross, cached decode.

Layout: q (B, S, K, G, dh) where H = K * G (K kv heads, G queries per kv
head); k/v (B, T, K, dh). Softmax in fp32.

Train/prefill (no cache; queries and keys at positions 0..S-1) goes
through ``kernels.ops.attention``: the hand-written flash-attention
kernel for a tensor on the card (``impl="pallas"``), its plain version
on the CPU or with ``impl="xla"``. Cross-attention to a conditioning
sequence (musicgen) takes the same route with ``causal=False`` and
Sk = ``cfg.cond_len``. Decode (one query against a ``max_len`` cache
with a valid length, or against the cached conditioning k/v) stays
plain torch, as in the reference. Query chunking (``cfg.q_chunk``) and
the score softcap (``cfg.logit_softcap``) run on the plain route, as in
the reference; the kernel tiles the queries itself and has no softcap,
so ``impl="pallas"`` refuses a softcap. Positions are RoPE, M-RoPE
(``cfg.pos_kind == "mrope"``, (3, B, S) position ids) or none.

On a mesh q, k and v are pinned as the reference pins them: heads over
'model' where the model axis divides the head count (or at decode),
else the query sequence (context parallelism: the kernel's rows then
start at their shard's ``q_offset``, the keys whole); the output to the
batch. A decode step (weight-stationary, under ``Model.decode_step``'s
rule override) contracts the projections' shards in place
(``sdt.stationary``), writes its k/v (at one position, or at each row's
own) into a cache whose sequence may be sharded over 'model' on the
ranks that hold those positions, and attends there without gathering
the cache: each rank attends its own keys, and the softmax's partial
row max, sum and output are combined across the sequence shards by
log-sum-exp (``decode_partials``; ``merge_partials`` is the same
combine on one process).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.embeddings import apply_mrope, apply_rope
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import axis_size, constrain, current_mesh

NEG_INF = -2.0e38


class _GradDtypeFence(torch.autograd.Function):
    """Identity whose cotangent is cast back to x's dtype (the
    reference's ``_fence``): the fp32 score path must not hand fp32
    dq/dk/dv back to bf16 activations. Applied on the plain route; the
    backward kernel gives q's dtype by construction."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _grad_dtype_fence(x: torch.Tensor) -> torch.Tensor:
    return _GradDtypeFence.apply(x)


def init_attention(ini, pfx: str, cfg, stack: int = 0,
                   cross: bool = False) -> None:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("wq", (d, h, dh), ("embed", "heads", "head_dim"))
    mk("wk", (d, k, dh), ("embed", "kv_heads", "head_dim"))
    mk("wv", (d, k, dh), ("embed", "kv_heads", "head_dim"))
    mk("wo", (h, dh, d), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias and not cross:
        mk("bq", (h, dh), ("heads", "head_dim"), init="zeros")
        mk("bk", (k, dh), ("kv_heads", "head_dim"), init="zeros")
        mk("bv", (k, dh), ("kv_heads", "head_dim"), init="zeros")


def _mask(q_pos, k_pos, window: int, causal: bool, valid_len=None):
    """Boolean (..., Sq, T) mask from query/key positions."""
    qp = q_pos[..., :, None]
    kp = sdt.replicate_like(qp, k_pos)[..., None, :]
    m = sdt.replicate_like(qp, torch.ones(
        torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
        device=q_pos.device))
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    if valid_len is not None:
        m &= kp < valid_len
    return m


def dot_attention(q, k, v, mask, softcap: float = 0.0):
    """q (B,Sq,K,G,dh), k/v (B,T,K,dh), mask (B,Sq,T) or (Sq,T).
    Scores in fp32, capped to c·tanh(s/c) for a softcap c > 0; the
    probabilities are cast to v's dtype before the PV product, as in the
    reference."""
    dh = q.shape[-1]
    scores = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(float(dh)))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)


def gqa_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                  causal: bool = True, valid_len=None, q_chunk: int = 0,
                  softcap: float = 0.0):
    """Full masked attention, or with ``q_chunk`` a loop over query
    chunks (when it divides Sq and is shorter), each through
    ``dot_attention`` with its own mask and its q, k and v fenced, as the
    reference's scan over chunks: the (Sq, T) scores never exist
    whole."""
    sq = q.shape[1]
    if q_chunk <= 0 or sq <= q_chunk or sq % q_chunk:
        mask = _mask(q_pos, k_pos, window, causal, valid_len)
        return dot_attention(q, k, v, mask, softcap)
    outs = []
    for c in range(0, sq, q_chunk):
        qpb = q_pos[..., c:c + q_chunk]
        mask = _mask(qpb, k_pos, window, causal, valid_len)
        outs.append(dot_attention(
            *(_grad_dtype_fence(t) for t in (q[:, c:c + q_chunk], k, v)),
            mask, softcap))
    return torch.cat(outs, dim=1)


def _flat_w(w: torch.Tensor, dt, at: int) -> torch.Tensor:
    """A (d, heads, dh) weight as (d, heads * dh) (``at`` 1), or a
    (heads, dh, d) one as (heads * dh, d) (``at`` 0), in ``dt``. A DTensor
    weight's head_dim is gathered first and its gradient pinned to the
    flat layout (DTensor keeps a shard through the flatten only on the
    heads, and only where they divide the mesh dim)."""
    flat = sdt.whole(w, (at + 1,)).to(dt).flatten(at, at + 1)
    return sdt.pinned(flat)


def _heads_in(x, w, dt):
    """x (B, S, d) times a DTensor (d, heads, dh) weight -> (B, S, heads,
    dh) with the weight's shards kept in place (decode): no dim of it is
    gathered, the embed shards' partial sums are reduced."""
    return sdt.stationary(
        lambda xl, wl: (xl @ wl.flatten(1, 2)).unflatten(-1, wl.shape[1:]),
        "bsd,dhe->bshe", x, w.to(dt))


def _heads_out(o, w, dt):
    """o (B, S, heads, dh) times a DTensor (heads, dh, d) weight -> (B, S,
    d), the weight's shards kept in place (decode)."""
    return sdt.stationary(lambda ol, wl: ol.flatten(2, 3) @ wl.flatten(0, 1),
                          "bshe,hed->bsd", o, w.to(dt))


def _project(p, x, cfg, decode: bool = False, cp: bool = False):
    """q, k, v (B, S, heads, dh) of x. Under context parallelism (``cp``)
    each rank projects its own query rows, x cut by ``act_seq_cp`` and
    wq gathered whole, as the reference's sequence-sharded q (its
    gradient partial sums over those ranks); k and v, which every rank
    attends whole, are projected whole."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    if decode and sdt.is_dtensor(p["wq"]):
        # head_dim whole once (the rotation slices it; a sharded one
        # would be gathered for each slice)
        q, k, v = (sdt.whole(_heads_in(x, p[n], dt), (3,))
                   for n in ("wq", "wk", "wv"))
    else:
        def w(name):        # (d, heads, dh) -> (d, heads * dh)
            return _flat_w(p[name], dt, 1)
        if cp:
            q = sdt.over_rows(
                lambda xl, wl: (xl @ wl.flatten(1, 2)).unflatten(
                    -1, wl.shape[1:]),
                constrain(x, "act_batch", "act_seq_cp", None),
                p["wq"].to(dt))
        else:
            q = sdt.split_last(x @ w("wq"), (h, dh))
        k = sdt.split_last(x @ w("wk"), (kh, dh))
        v = sdt.split_last(x @ w("wv"), (kh, dh))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _position(x, cfg, positions, mrope_positions):
    if cfg.pos_kind == "mrope":
        if mrope_positions is None:
            raise ValueError("M-RoPE needs mrope_positions (3, B, S)")
        return apply_mrope(x, mrope_positions, cfg.mrope_sections,
                           cfg.rope_theta)
    if cfg.pos_kind == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    return x


def _refuse_softcap(cfg, impl: str) -> None:
    if cfg.logit_softcap > 0.0 and impl == "pallas":
        raise ValueError(
            f"logit_softcap {cfg.logit_softcap}: the attention kernel has no "
            "score softcap (nor has the TPU kernel it ports); run the plain "
            "route, impl='xla'")


def self_attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                   positions: torch.Tensor, window: int = 0,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   cur_len=None, impl: str = "pallas",
                   mrope_positions: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention with RoPE / M-RoPE and optional KV-cache decode.

    Train/prefill: cache is None, positions (B, S) = 0..S-1 (M-RoPE:
    ``mrope_positions`` (3, B, S)). Returns the output and the rotated
    k/v, which are the prefill cache (offset 0).
    Decode: cache holds (B, S_max, K, dh) k/v; x is (B, 1, d); cur_len
    is the int position of the new token, or a (B,) int tensor of each
    row's own position (continuous batching; positions (B, 1) = cur_len
    per row, each row masked to its own ``cur_len + 1`` keys). The new
    k/v are written into ``cache`` IN PLACE (the reference's
    dynamic_update_slice or, per row, its scatter, without the copy), and
    ``cache`` is returned. The qkv biases (``cfg.qkv_bias``)
    enter q, k and v before the rotation, so the prefill cache carries
    them. A softcap runs on the plain route only (``impl="xla"``).
    """
    _refuse_softcap(cfg, impl)
    b, s, _ = x.shape
    k_heads, g, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    dt = x.dtype
    cap = cfg.logit_softcap

    # the operands' own mesh: the ambient one is thread-local, and a remat
    # cycle's recompute runs on the autograd engine's device thread
    mesh = x.device_mesh if sdt.is_dtensor(x) else current_mesh()
    cp = not (mesh is None or cfg.n_heads % axis_size(mesh, "model") == 0
              or s == 1)
    q, k, v = _project(p, x, cfg, decode=cache is not None, cp=cp)
    q = _position(q, cfg, positions, mrope_positions)
    k = _position(k, cfg, positions, mrope_positions)
    if not cp:
        # tensor parallelism over heads (kv replicated over 'model' where
        # the kv heads do not divide it)
        q = constrain(q, "act_batch", "act_seq", "act_heads", None)
        k = constrain(k, "act_batch", "act_seq", "act_kv_heads", None)
        v = constrain(v, "act_batch", "act_seq", "act_kv_heads", None)
    else:
        # context parallelism: the heads do not divide the model axis, so
        # the query sequence is sharded over it (k/v pinned batch-only)
        q = constrain(q, "act_batch", "act_seq_cp", "act_heads", None)
        k = constrain(k, "act_batch", "act_seq_cp", "act_kv_heads", None)
        v = constrain(v, "act_batch", "act_seq_cp", "act_kv_heads", None)

    if cache is None:
        new_cache = {"k": k, "v": v}
        qc = cfg.q_chunk
        if ops.plain_route(q, impl) and (0 < qc < s and s % qc == 0
                                         or cap > 0.0):
            out = gqa_attention(q.reshape(b, s, k_heads, g, dh), k, v,
                                positions, positions[0], window=window,
                                causal=True, q_chunk=cfg.q_chunk,
                                softcap=cap)
        else:
            if ops.plain_route(q, impl):
                q, k, v = (_grad_dtype_fence(t) for t in (q, k, v))
            out = ops.attention(q, k, v, causal=True, window=window,
                                impl=impl)
    else:
        if isinstance(cur_len, torch.Tensor):
            # per-slot positions (continuous batching): each row's token
            # goes in at its own index
            sdt.write_rows_at_(cache["k"], cur_len, k.to(cache["k"].dtype))
            sdt.write_rows_at_(cache["v"], cur_len, v.to(cache["v"].dtype))
            valid = (cur_len + s)[:, None, None]
        else:
            sdt.write_at_(cache["k"], 1, cur_len, k.to(cache["k"].dtype))
            sdt.write_at_(cache["v"], 1, cur_len, v.to(cache["v"].dtype))
            valid = cur_len + s
        new_cache = cache
        ck, cv = cache["k"].to(dt), cache["v"].to(dt)
        if sdt.is_dtensor(q):
            out = _sharded_self_decode(q, ck, cv, positions, valid,
                                       window=window, softcap=cap)
            # the heads' output replicated over the data axes (act_batch
            # None), then through wo's shards in place
            out = constrain(out, "act_batch", "act_seq", "act_heads", None)
            y = _heads_out(out, p["wo"], dt)
            return constrain(y, "act_batch", "act_seq", "act_embed"), cache
        k_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=x.device)
        out = gqa_attention(q.reshape(b, s, k_heads, g, dh), ck, cv,
                            positions, k_pos, window=window, causal=True,
                            valid_len=valid, softcap=cap)

    out = sdt.pinned(out.reshape(b, s, k_heads * g * dh))
    wo = _flat_w(p["wo"], dt, 0)
    # under context parallelism each rank projects its query rows (a
    # DTensor product of a batch- and sequence-sharded operand would cut
    # it in strided pieces)
    y = sdt.over_rows(torch.matmul, out, wo) if cp else sdt.dense(out, wo)
    return constrain(y, "act_batch", "act_seq", "act_embed"), new_cache


def _decode_layout(ck, mesh):
    """Per mesh dim, the placements of a decode's q, of its cache k/v and
    of its per-row operands, and the mesh dims that shard the cache's
    sequence: the cache's batch shard and its kv-heads shard (where the
    dim divides the kv heads) are kept, q's heads and the rows following
    them; a sequence shard stays on the cache (q whole); anything else
    is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    q_pl, c_pl, r_pl, seq = [], [], [], []
    for i, cp in enumerate(ck.placements):
        if cp == Shard(0) or (cp == Shard(2) and ck.shape[2] % mesh.size(i)
                              == 0):
            q_pl.append(cp), c_pl.append(cp)
            r_pl.append(cp if cp == Shard(0) else Replicate())
        elif cp == Shard(1):
            q_pl.append(Replicate()), c_pl.append(cp)
            r_pl.append(Replicate()), seq.append(i)
        else:
            q_pl.append(Replicate()), c_pl.append(Replicate())
            r_pl.append(Replicate())
    return q_pl, c_pl, r_pl, seq


def _sharded_cross_decode(q, ck, cv):
    """A decode step's cross-attention of DTensors: q (B, 1, H, dh)
    against the conditioning k/v (B, T, K, dh), whose sequence is never
    sharded (the ``xk`` / ``xv`` cache axes), on each rank's batch and
    kv-heads shards (``_decode_layout``) through ``dot_attention`` with
    every key allowed."""
    mesh = q.device_mesh
    q_pl, c_pl, _, _ = _decode_layout(ck, mesh)
    g = q.shape[2] // ck.shape[2]

    def fn(ql, kl, vl):
        bl, s, hl, dh = ql.shape
        mask = torch.ones((s, kl.shape[1]), dtype=torch.bool,
                          device=kl.device)
        return dot_attention(ql.reshape(bl, s, hl // g, g, dh), kl, vl,
                             mask).reshape(ql.shape)
    return sdt.local(fn, mesh, q_pl, (q_pl, c_pl, c_pl))(q, ck, cv)


def decode_partials(q, k, v, q_pos, k_pos, *, window: int = 0,
                    valid_len=None, softcap: float = 0.0):
    """The softmax's partials of q (B, Sq, K, G, dh) against a window of
    keys k/v (B, T, K, dh) at global positions ``k_pos`` (T,), under the
    causal mask with ``window`` and ``valid_len`` (``_mask``), the scores
    capped before anything else: m (B, Sq, K, G), the largest allowed
    score (-inf where the window holds none); l, the sum of exp(score -
    m) (0 where none); o (B, Sq, K, G, dh), the sum of exp(score - m) v.
    In fp32 (fp64 for fp64 inputs). Windows combine by
    ``merge_partials``, or across ranks in ``_sharded_self_decode``."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqkgd,btkd->bqkgt", q.to(acc), k.to(acc))
    scores = scores * (1.0 / math.sqrt(float(q.shape[-1])))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    mask = _mask(q_pos, k_pos, window, True, valid_len)
    if mask.dim() == 2:
        mask = mask[None]
    scores = scores.masked_fill(~mask[:, :, None, None], -math.inf)
    m = scores.amax(-1)
    e = torch.exp(scores - _finite(m)[..., None])
    return m, e.sum(-1), torch.einsum("bqkgt,btkd->bqkgd", e, v.to(acc))


def _finite(m):
    """A row max with -inf (no allowed key) as 0, so exp(x - m) is 0,
    never NaN, for x = -inf."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def _weighted(m, top, l, o):
    """A window's (o, l) packed as (..., dh + 1), scaled by its weight in
    the softmax over every window, exp(m - top): 0 for a window with no
    allowed key for the row (m = -inf), and for a row with none at all."""
    w = torch.exp(m - _finite(top))
    return torch.cat([o, l[..., None]], -1) * w[..., None]


def _normalised(packed, dtype):
    """(o, l) packed by ``_weighted`` (summed over the windows) -> o / l
    in ``dtype``; 0 for a row with no allowed key (l = 0), the port's
    convention for such a row."""
    o, l = packed[..., :-1], packed[..., -1:]
    ok = l > 0
    return torch.where(ok, o / torch.where(ok, l, torch.ones_like(l)),
                       torch.zeros_like(o)).to(dtype)


def merge_partials(parts, dtype):
    """Attention over the union of windows from each window's
    ``decode_partials`` (m, l, o): every window rescaled to the row max
    over all of them, summed, normalised; (B, Sq, K, G, dh) in
    ``dtype``."""
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    return _normalised(sum(_weighted(m, top, l, o) for m, l, o in parts),
                       dtype)


def _sharded_self_decode(q, ck, cv, q_pos, valid, *, window: int,
                         softcap: float):
    """A decode step's self-attention of DTensors: q (B, 1, H, dh), the
    cache k/v (B, T, K, dh), ``q_pos`` (B, 1) and ``valid`` (an int, or
    (B, 1, 1) per row), on the cache's batch and kv-heads shards
    (``_decode_layout``: q and the per-row operands follow them). Where
    its sequence is sharded
    over mesh dims, nothing is gathered: each rank attends its own keys
    at their global positions (``decode_partials``), the row max is
    all-reduced (max) over those dims, each rank rescales its sum and
    output to it, and the two are all-reduced (sum) and normalised; the
    collectives are DTensor's (``Partial`` placements), so a trace counts
    them. Without a sequence shard each rank runs ``gqa_attention`` on
    its shards, as on one process. Returns (B, 1, H, dh) on q's batch and
    heads shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    _, s, h, dh = q.shape
    g = h // ck.shape[2]
    q_pl, c_pl, r_pl, seq = _decode_layout(ck, mesh)
    tensor_valid = isinstance(valid, torch.Tensor)
    ins = (q_pl, c_pl, c_pl, r_pl, r_pl if tensor_valid else None)
    args = (q, ck, cv, sdt.replicate_like(q, q_pos),
            sdt.replicate_like(q, valid) if tensor_valid else valid)
    width = ck.to_local().shape[1]
    lo = sdt.coord(mesh, seq) * width

    def operands(ql, kl, pl):
        bl, _, hl, _ = ql.shape
        k_pos = torch.arange(lo, lo + width, dtype=torch.int32,
                             device=kl.device)
        return ql.reshape(bl, s, hl // g, g, dh), k_pos, pl

    if not seq:
        def attend(ql, kl, vl, pl, vall):
            q5, k_pos, pl = operands(ql, kl, pl)
            return gqa_attention(q5, kl, vl, pl, k_pos, window=window,
                                 causal=True, valid_len=vall,
                                 softcap=softcap).reshape(ql.shape)
        return sdt.local(attend, mesh, q_pl, ins)(*args)

    def partials(ql, kl, vl, pl, vall):
        q5, k_pos, pl = operands(ql, kl, pl)
        return decode_partials(q5, kl, vl, pl, k_pos, window=window,
                               valid_len=vall, softcap=softcap)

    # (B, 1, K, G[, dh]) partials: batch shards on dim 0, kv heads on 2
    part = [p if isinstance(p, Shard) else Replicate() for p in q_pl]
    m_pl = [Partial("max") if i in seq else p for i, p in enumerate(part)]
    s_pl = [Partial() if i in seq else p for i, p in enumerate(part)]
    m, l, o = sdt.local(partials, mesh, (m_pl, s_pl, s_pl), ins)(*args)
    top = m.redistribute(mesh, part)
    packed = sdt.local(_weighted, mesh, s_pl, (m_pl, part, s_pl, s_pl))(
        m, top, l, o).redistribute(mesh, part)

    def finish(xl):
        out = _normalised(xl, cv.dtype)
        return out.reshape(out.shape[:2] + (-1, dh))
    return sdt.local(finish, mesh, q_pl, (part,))(packed)


def cross_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cond_k: torch.Tensor, cond_v: torch.Tensor, cfg, *,
                    decode: bool = False, impl: str = "pallas"
                    ) -> torch.Tensor:
    """Cross-attention to a precomputed conditioning sequence (musicgen):
    every query sees every conditioning key. cond_k/cond_v (B, S_cond, K,
    dh). Train/prefill through ``ops.attention`` (``causal=False``);
    decode (``decode=True``) plain, as self-attention's decode, its
    projections on a mesh weight-stationary as self-attention's."""
    b, s, _ = x.shape
    h, k_heads, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    dt = x.dtype
    ck, cv = cond_k.to(dt), cond_v.to(dt)
    if decode and sdt.is_dtensor(p["wq"]):
        out = _sharded_cross_decode(_heads_in(x, p["wq"], dt), ck, cv)
        out = constrain(out, "act_batch", "act_seq", "act_heads", None)
        return _heads_out(out, p["wo"], dt)
    q = sdt.split_last(x @ _flat_w(p["wq"], dt, 1), (h, dh))
    if decode:
        mask = torch.ones((s, ck.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = dot_attention(q.view(b, s, k_heads, g, dh), ck, cv, mask)
    else:
        if ops.plain_route(q, impl):
            q, ck, cv = (_grad_dtype_fence(t) for t in (q, ck, cv))
        out = ops.attention(q, ck, cv, causal=False, window=0, impl=impl)
    out = out.reshape(b, s, h * dh)
    return out @ _flat_w(p["wo"], dt, 0)


def cross_kv(p: Dict[str, torch.Tensor], cond: torch.Tensor, cfg):
    """Project the conditioning sequence (B, S_cond, d) to k/v (B, S_cond,
    K, dh) once; every decode step reuses them."""
    b, t, _ = cond.shape
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    dt = cond.dtype
    k = sdt.split_last(cond @ _flat_w(p["wk"], dt, 1), (kh, dh))
    v = sdt.split_last(cond @ _flat_w(p["wv"], dt, 1), (kh, dh))
    return k, v


def init_cache(cfg, batch: int, max_len: int, *, device, dtype=None
               ) -> Dict[str, torch.Tensor]:
    """Zero KV cache for one attention layer."""
    dtype = dtype or cfg.torch_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
