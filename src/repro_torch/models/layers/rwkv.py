"""RWKV6 "Finch" block: data-dependent-decay linear attention (the port
of the reference's ``models/layers/rwkv.py``, its function and not
upstream RWKV6's: no tanh on the decay LoRA, streams in the order
w, k, v, r, g, the shift state taken from the ln1-normed input).

Time mix uses the ddlerp token-shift (low-rank data-dependent lerp into
five projection streams), per-channel data-dependent decay
w_t = exp(-exp(logit)), and the "bonus" u for the current token:

    out_t = r_t · (S_{t-1} + diag(u) k_t v_t^T),
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T            (per head)

Over a whole sequence the wkv goes through ``kernels.ops.gla_chunked``
(chunk cfg.gla_chunk, or 1 when it does not divide S): the hand-written
CUDA kernel for a tensor on the card (``impl="pallas"``), its plain
chunked version on the CPU or with ``impl="xla"``. One decode step is
the plain recurrence. The decay logits stay fp32 and w reaches the
kernel in fp32 (in bf16, 1 - 6e-6 rounds to 1); projections run in the
activation dtype; the wkv state is fp32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers.norms import groupnorm_heads
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain

N_STREAMS = 5  # w, k, v, r, g
LORA_TOKENSHIFT = 32
LORA_DECAY = 64


def init_rwkv_time_mix(ini, pfx: str, cfg, stack: int = 0) -> None:
    d = cfg.d_model
    h = cfg.n_heads
    dh = cfg.head_dim

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("mu_base", (d,), ("embed",), init="zeros")
    mk("mu", (N_STREAMS, d), (None, "embed"), init="zeros")
    mk("ts_lora_a", (d, N_STREAMS * LORA_TOKENSHIFT), ("embed", None))
    mk("ts_lora_b", (N_STREAMS, LORA_TOKENSHIFT, d), (None, None, "embed"),
       init="zeros")
    mk("w0", (d,), ("embed",), init="zeros")
    mk("w_lora_a", (d, LORA_DECAY), ("embed", None))
    mk("w_lora_b", (LORA_DECAY, d), (None, "embed"), init="zeros")
    mk("u", (h, dh), ("heads", "head_dim"), init="zeros")
    for nm in ("wr", "wk", "wv", "wg"):
        mk(nm, (d, d), ("embed", "mlp"))
    mk("wo", (d, d), ("mlp", "embed"))
    mk("ln_x_scale", (d,), ("embed",), init="ones")
    mk("ln_x_bias", (d,), ("embed",), init="zeros")


def init_rwkv_channel_mix(ini, pfx: str, cfg, stack: int = 0) -> None:
    d, f = cfg.d_model, cfg.d_ff

    def mk(name, shape, names, **kw):
        if stack:
            shape, names = (stack,) + shape, ("layers",) + names
        ini.make(f"{pfx}/{name}", shape, names, **kw)

    mk("mu_k", (d,), ("embed",), init="zeros")
    mk("mu_r", (d,), ("embed",), init="zeros")
    mk("wk", (d, f), ("embed", "mlp"))
    mk("wv", (f, d), ("mlp", "embed"))
    mk("wr", (d, d), ("embed", "mlp"))


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} stream; prev is the last token of the previous segment
    (zeros at sequence start), shape (B, 1, d) or (B, d)."""
    if prev.dim() == 2:
        prev = prev[:, None]
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def gla_decode_step(r, k, v, w, u, state):
    """Single-token recurrence. r, k, v, w: (B, H, dh); state
    (B, H, dh, dh) fp32. Returns (out in r's dtype, new state)."""
    r_, k_, v_, w_ = (a.float() for a in (r, k, v, w))
    kv = k_[..., :, None] * v_[..., None, :]          # (B,H,c,e)
    out = torch.einsum("bhc,bhce->bhe", r_,
                       state + u.float()[..., None] * kv)
    new_state = w_[..., None] * state + kv
    return out.to(r.dtype), new_state


def _decode_step(r, k, v, w, u, state):
    """``gla_decode_step``; DTensors on each rank's (batch, heads) shards
    (DTensor's own einsum rules would cut the state in strided pieces)."""
    if not sdt.is_dtensor(r):
        return gla_decode_step(r, k, v, w, u, state)
    from torch.distributed.tensor import Replicate, Shard
    x_pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
            for p in r.placements]
    u_pl = [Shard(0) if p == Shard(1) else Replicate() for p in x_pl]
    ins = (x_pl,) * 4 + (u_pl, x_pl)
    return sdt.local(gla_decode_step, r.device_mesh, (x_pl, x_pl), ins,
                     ins)(r, k, v, w, u, state)


def _stream_lora(lo, w):
    """(B, S, 5 * 32) LoRA codes times the five streams' (5, 32, d)
    outputs -> (B, S, 5, d)."""
    lo = lo.reshape(lo.shape[:-1] + (N_STREAMS, LORA_TOKENSHIFT))
    return torch.einsum("bsnr,nrd->bsnd", lo, w)


def _ddlerp(p, x, xx):
    """Data-dependent lerp producing the five projection streams."""
    dt = x.dtype
    delta = xx - x
    base = x + delta * p["mu_base"].to(dt)
    lo = torch.tanh(base @ p["ts_lora_a"].to(dt))
    # each rank's rows through the five streams' LoRA (DTensor would
    # shard the five streams unevenly)
    adj = sdt.over_rows(_stream_lora, lo, p["ts_lora_b"].to(dt))
    mix = p["mu"].to(dt) + adj                        # (B,S,5,d)
    return x[:, :, None, :] + delta[:, :, None, :] * mix


def rwkv_time_mix(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                  shift_state=None, wkv_state=None, impl: str = "pallas"
                  ) -> Tuple[torch.Tensor, Tuple]:
    """x: (B, S, d). Returns (out, (new_shift_state, new_wkv_state)).

    A single token with a ``wkv_state`` is a decode step; anything else
    starts the wkv from zero, as in the reference."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    dt = x.dtype

    prev = shift_state if shift_state is not None else sdt.replicate_like(
        x, torch.zeros((b, d), dtype=dt, device=x.device))
    xx = _token_shift(x, prev)
    # the five streams whole on every rank (DTensor cannot unbind a
    # sharded dim)
    x_w, x_k, x_v, x_r, x_g = sdt.whole(_ddlerp(p, x, xx), (2,)).unbind(2)

    # data-dependent decay (fp32 logits)
    w_logit = (p["w0"].float()
               + (x_w.float() @ p["w_lora_a"].float())
               @ p["w_lora_b"].float())
    w = torch.exp(-torch.exp(torch.clamp(w_logit, -12.0, 4.0)))  # in (0,1)

    r = sdt.split_last(sdt.dense(x_r, p["wr"].to(dt)), (h, dh))
    k = sdt.split_last(sdt.dense(x_k, p["wk"].to(dt)), (h, dh))
    v = sdt.split_last(sdt.dense(x_v, p["wv"].to(dt)), (h, dh))
    g = F.silu(sdt.dense(x_g, p["wg"].to(dt)))
    w = sdt.split_last(w, (h, dh))
    u = p["u"]

    if s == 1 and wkv_state is not None:
        out, new_state = _decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                      u, wkv_state)
        out = out[:, None]
    else:
        chunk = cfg.gla_chunk if s % cfg.gla_chunk == 0 else 1
        out, new_state = ops.gla_chunked(r, k, v, w, u, chunk=chunk,
                                         impl=impl)
    out = sdt.pinned(out.reshape(b, s, h * dh))
    out = groupnorm_heads(p["ln_x_scale"], p["ln_x_bias"], out, h)
    out = out * g
    y = constrain(sdt.dense(out, p["wo"].to(dt)), "act_batch", "act_seq",
                  "act_embed")
    # a copy, so the state does not hold the whole input alive
    new_shift = x[:, -1].clone()
    return y, (new_shift, new_state.float())


def rwkv_channel_mix(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                     shift_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    dt = x.dtype
    prev = shift_state if shift_state is not None else sdt.replicate_like(
        x, torch.zeros((b, d), dtype=dt, device=x.device))
    xx = _token_shift(x, prev)
    delta = xx - x
    x_k = x + delta * p["mu_k"].to(dt)
    x_r = x + delta * p["mu_r"].to(dt)
    kk = torch.square(F.relu(sdt.dense(x_k, p["wk"].to(dt))))
    kk = constrain(kk, "act_batch", "act_seq", "act_mlp")
    kv = sdt.dense(kk, p["wv"].to(dt))
    rr = torch.sigmoid(sdt.dense(x_r, p["wr"].to(dt)))
    return (constrain(rr * kv, "act_batch", "act_seq", "act_embed"),
            x[:, -1].clone())
