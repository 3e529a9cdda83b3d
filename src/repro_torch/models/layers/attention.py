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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.embeddings import apply_mrope, apply_rope

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
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
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


def _project(p, x, cfg):
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt).reshape(-1, h * dh)).view(b, s, h, dh)
    k = (x @ p["wk"].to(dt).reshape(-1, kh * dh)).view(b, s, kh, dh)
    v = (x @ p["wv"].to(dt).reshape(-1, kh * dh)).view(b, s, kh, dh)
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
                   cur_len: Optional[int] = None, impl: str = "pallas",
                   mrope_positions: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention with RoPE / M-RoPE and optional KV-cache decode.

    Train/prefill: cache is None, positions (B, S) = 0..S-1 (M-RoPE:
    ``mrope_positions`` (3, B, S)). Returns the output and the rotated
    k/v, which are the prefill cache (offset 0).
    Decode: cache holds (B, S_max, K, dh) k/v; x is (B, 1, d); cur_len
    is the int position of the new token. The new k/v are written into
    ``cache`` IN PLACE (the reference's dynamic_update_slice, without the
    copy), and ``cache`` is returned. The qkv biases (``cfg.qkv_bias``)
    enter q, k and v before the rotation, so the prefill cache carries
    them. A softcap runs on the plain route only (``impl="xla"``).
    """
    _refuse_softcap(cfg, impl)
    b, s, _ = x.shape
    k_heads, g, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    dt = x.dtype
    cap = cfg.logit_softcap

    q, k, v = _project(p, x, cfg)
    q = _position(q, cfg, positions, mrope_positions)
    k = _position(k, cfg, positions, mrope_positions)

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
        if not isinstance(cur_len, int):
            raise NotImplementedError(
                "per-slot decode positions wait for the serving scheduler")
        cache["k"][:, cur_len:cur_len + s] = k.to(cache["k"].dtype)
        cache["v"][:, cur_len:cur_len + s] = v.to(cache["v"].dtype)
        new_cache = cache
        ck, cv = cache["k"].to(dt), cache["v"].to(dt)
        k_pos = torch.arange(ck.shape[1], dtype=torch.int32, device=x.device)
        out = gqa_attention(q.reshape(b, s, k_heads, g, dh), ck, cv,
                            positions, k_pos, window=window, causal=True,
                            valid_len=cur_len + s, softcap=cap)

    out = out.reshape(b, s, k_heads * g * dh)
    y = out @ p["wo"].to(dt).reshape(k_heads * g * dh, -1)
    return y, new_cache


def cross_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cond_k: torch.Tensor, cond_v: torch.Tensor, cfg, *,
                    decode: bool = False, impl: str = "pallas"
                    ) -> torch.Tensor:
    """Cross-attention to a precomputed conditioning sequence (musicgen):
    every query sees every conditioning key. cond_k/cond_v (B, S_cond, K,
    dh). Train/prefill through ``ops.attention`` (``causal=False``);
    decode (``decode=True``) plain, as self-attention's decode."""
    b, s, _ = x.shape
    h, k_heads, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt).reshape(-1, h * dh)).view(b, s, h, dh)
    ck, cv = cond_k.to(dt), cond_v.to(dt)
    if decode:
        mask = torch.ones((s, ck.shape[1]), dtype=torch.bool, device=x.device)
        out = dot_attention(q.view(b, s, k_heads, g, dh), ck, cv, mask)
    else:
        if ops.plain_route(q, impl):
            q, ck, cv = (_grad_dtype_fence(t) for t in (q, ck, cv))
        out = ops.attention(q, ck, cv, causal=False, window=0, impl=impl)
    out = out.reshape(b, s, h * dh)
    return out @ p["wo"].to(dt).reshape(h * dh, -1)


def cross_kv(p: Dict[str, torch.Tensor], cond: torch.Tensor, cfg):
    """Project the conditioning sequence (B, S_cond, d) to k/v (B, S_cond,
    K, dh) once; every decode step reuses them."""
    b, t, _ = cond.shape
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    dt = cond.dtype
    k = (cond @ p["wk"].to(dt).reshape(-1, kh * dh)).view(b, t, kh, dh)
    v = (cond @ p["wv"].to(dt).reshape(-1, kh * dh)).view(b, t, kh, dh)
    return k, v


def init_cache(cfg, batch: int, max_len: int, *, device, dtype=None
               ) -> Dict[str, torch.Tensor]:
    """Zero KV cache for one attention layer."""
    dtype = dtype or cfg.torch_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
