"""Block assembly and the full model stack.

The reference scans over "pattern cycles" (one cycle = one repetition of
cfg.block_pattern); here a Python loop walks the leading ``n_cycles``
axis of the stacked params ("stack/{pos}/{kind}/..."). Remainder layers
(n_layers % cycle_len, "rem/{i}/{kind}/...") follow unstacked. The
block kinds are the reference's: "attn", "local", "moe" (attention and
the MoE FFN, whose aux losses ``forward`` sums over every layer), "rec"
and "rwkv"; with ``cfg.cross_attn`` every attention block also attends
to the conditioning sequence (musicgen).

Modes:
  train   — full sequence, no caches; with ``cfg.remat`` each cycle is
            recomputed in the backward (only cycle boundaries stay
            live, the reference's ``nothing_saveable`` policy)
  prefill — full sequence, emits decode caches
  decode  — single token against caches (serve_step); the caches are
            updated in place

Sharded: with DTensor params and inputs under ``with mesh:`` every block
ends pinned to the batch layout (or, training with
``cfg.seq_parallel``, the sequence over 'model'), as in the reference,
and the positions go onto the mesh replicated. Each layer's weights are
gathered over the data axes before it runs (``sharding.dtensor
.unshard_data``: FSDP, the layout XLA picks for the reference's rules).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as pp
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rglru, rwkv
from repro_torch.models.layers.embeddings import (embed_tokens,
                                                   init_embeddings, unembed)
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain

ATTN_KINDS = ("attn", "local", "moe")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_block(ini, pfx: str, kind: str, cfg, stack: int = 0) -> None:
    init_rmsnorm(ini, f"{pfx}/ln1", cfg.d_model, stack)
    if kind in ATTN_KINDS:
        attn.init_attention(ini, f"{pfx}/attn", cfg, stack)
        if cfg.cross_attn:
            init_rmsnorm(ini, f"{pfx}/ln_x", cfg.d_model, stack)
            attn.init_attention(ini, f"{pfx}/xattn", cfg, stack, cross=True)
        init_rmsnorm(ini, f"{pfx}/ln2", cfg.d_model, stack)
        if kind == "moe":
            moe_lib.init_moe(ini, f"{pfx}/moe", cfg, stack)
        else:
            init_mlp(ini, f"{pfx}/mlp", cfg, stack)
    elif kind == "rwkv":
        rwkv.init_rwkv_time_mix(ini, f"{pfx}/tm", cfg, stack)
        init_rmsnorm(ini, f"{pfx}/ln2", cfg.d_model, stack)
        rwkv.init_rwkv_channel_mix(ini, f"{pfx}/cm", cfg, stack)
    elif kind == "rec":
        rglru.init_recurrent_block(ini, f"{pfx}/rec", cfg, stack)
        init_rmsnorm(ini, f"{pfx}/ln2", cfg.d_model, stack)
        init_mlp(ini, f"{pfx}/mlp", cfg, stack)
    else:
        raise ValueError(f"block kind {kind!r}")


def init_model(ini, cfg) -> None:
    init_embeddings(ini, cfg)
    for pos, kind in enumerate(cfg.block_pattern):
        if cfg.n_cycles > 0:
            init_block(ini, f"stack/{pos}/{kind}", kind, cfg,
                       stack=cfg.n_cycles)
    for i in range(cfg.n_rem):
        kind = cfg.block_pattern[i]
        init_block(ini, f"rem/{i}/{kind}", kind, cfg)
    init_rmsnorm(ini, "final_norm", cfg.d_model)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def block_cache(kind: str, cfg, batch: int, max_len: int, *, device
                ) -> Dict[str, torch.Tensor]:
    """Zero decode state for one block of the given kind."""
    if kind in ATTN_KINDS:
        c = attn.init_cache(cfg, batch, max_len, device=device)
        if cfg.cross_attn:
            shape = (batch, cfg.cond_len, cfg.n_kv_heads, cfg.head_dim)
            c["xk"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            c["xv"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
        return c
    if kind == "rec":
        return {
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                dtype=cfg.torch_dtype, device=device),
            "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                             device=device),
        }
    if kind == "rwkv":
        return {
            "shift_tm": torch.zeros((batch, cfg.d_model),
                                    dtype=cfg.torch_dtype, device=device),
            "shift_cm": torch.zeros((batch, cfg.d_model),
                                    dtype=cfg.torch_dtype, device=device),
            "wkv": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                                cfg.head_dim), dtype=torch.float32,
                               device=device),
        }
    raise ValueError(f"block kind {kind!r}")


def init_cache(cfg, batch: int, max_len: int, *, device
               ) -> Dict[str, torch.Tensor]:
    """Full-model cache: {"stack/{pos}/{key}": (n_cycles, ...) stacked,
    "rem/{i}/{key}": unstacked}."""
    cache: Dict[str, torch.Tensor] = {}
    for pos, kind in enumerate(cfg.block_pattern):
        if cfg.n_cycles == 0:
            continue
        c = block_cache(kind, cfg, batch, max_len, device=device)
        for k, v in c.items():
            cache[f"stack/{pos}/{k}"] = v[None].repeat(
                (cfg.n_cycles,) + (1,) * v.dim())
    for i in range(cfg.n_rem):
        kind = cfg.block_pattern[i]
        c = block_cache(kind, cfg, batch, max_len, device=device)
        for k, v in c.items():
            cache[f"rem/{i}/{k}"] = v
    return cache


# Logical axes of the decode cache's entries (the reference's): batch
# over ('pod','data'); kv_heads over 'model' when divisible, else the
# seq dim; head_dim only for the conditioning k/v.
CACHE_AXES = {
    "k": ("act_batch", "act_cache_seq", "act_kv_heads", None),
    "v": ("act_batch", "act_cache_seq", "act_kv_heads", None),
    "xk": ("act_batch", None, "act_kv_heads", "cache_head_dim"),
    "xv": ("act_batch", None, "act_kv_heads", "cache_head_dim"),
    "shift_tm": ("act_batch", None),
    "shift_cm": ("act_batch", None),
    "wkv": ("act_batch", "act_heads", None, None),
    "conv": ("act_batch", None, "act_rnn"),
    "h": ("act_batch", "act_rnn"),
}


def cache_axes(cfg) -> Dict[str, tuple]:
    """Logical axes of ``init_cache``'s entries, key for key."""
    meta = torch.device("meta")
    axes = {}
    for pos, kind in enumerate(cfg.block_pattern):
        if cfg.n_cycles == 0:
            continue
        for k in block_cache(kind, cfg, 1, 8, device=meta):
            axes[f"stack/{pos}/{k}"] = ("layers",) + CACHE_AXES[k]
    for i in range(cfg.n_rem):
        for k in block_cache(cfg.block_pattern[i], cfg, 1, 8, device=meta):
            axes[f"rem/{i}/{k}"] = CACHE_AXES[k]
    return axes


def extend_cache(cfg, cache: Dict[str, torch.Tensor], max_len: int
                 ) -> Dict[str, torch.Tensor]:
    """A prefill cache (k/v over the S prompt positions) copied into a
    zero ``max_len`` decode cache: k/v at offset 0, the recurrent states
    (conv, h; shift_tm, shift_cm, wkv) and the conditioning k/v (xk, xv)
    as they are."""
    out = {}
    for key, v in cache.items():
        if key.endswith("/k") or key.endswith("/v"):
            seq_axis = v.dim() - 3            # (..., B, S, K, dh)
            shape = list(v.shape)
            if shape[seq_axis] > max_len:
                raise ValueError(f"{key}: prompt of {shape[seq_axis]} "
                                 f"positions exceeds max_len {max_len}")
            shape[seq_axis] = max_len
            z = torch.zeros(shape, dtype=v.dtype, device=v.device)
            z.narrow(seq_axis, 0, v.shape[seq_axis]).copy_(v)
            out[key] = z
        else:
            out[key] = v.clone()
    return out


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------

def _norm(scale, x, cfg):
    """A sublayer's normed input, its sequence whole on every rank (the
    all-gather a sequence-parallel block makes on entering the sublayer;
    a no-op for an unsharded sequence)."""
    return sdt.whole(rmsnorm(scale, x, cfg.norm_eps), (1,))


def block_forward(kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg, *, mode: str, positions, cur_len=None, cache=None,
                  cond=None, mrope_positions=None, impl: str = "pallas"):
    """Returns (x, new_cache_or_None, aux_losses). In decode mode
    ``cache``'s tensors are updated in place."""
    window = cfg.window if kind == "local" else 0
    new_cache = {}
    aux = {}

    if kind in ATTN_KINDS:
        h = _norm(p["ln1"], x, cfg)
        a, kv = attn.self_attention(
            pp.subtree(p, "attn"), h, cfg, positions=positions,
            window=window, cur_len=cur_len, impl=impl,
            mrope_positions=mrope_positions,
            cache=({"k": cache["k"], "v": cache["v"]} if mode == "decode"
                   else None))
        if mode in ("prefill", "decode"):
            new_cache.update(kv)
        x = x + a

        if cfg.cross_attn:
            hx = _norm(p["ln_x"], x, cfg)
            px = pp.subtree(p, "xattn")
            if mode == "decode" and cond is None:
                # serving: the conditioning k/v were cached at prefill
                xk, xv = cache["xk"].to(x.dtype), cache["xv"].to(x.dtype)
            else:
                xk, xv = attn.cross_kv(px, cond, cfg)
                if mode == "decode":
                    cache["xk"].copy_(xk)
                    cache["xv"].copy_(xv)
            if mode == "prefill":
                new_cache.update({"xk": xk, "xv": xv})
            elif mode == "decode":
                new_cache.update({"xk": cache["xk"], "xv": cache["xv"]})
            x = x + attn.cross_attention(px, hx, xk, xv, cfg,
                                         decode=mode == "decode", impl=impl)

        h = _norm(p["ln2"], x, cfg)
        if kind == "moe":
            y, aux = moe_lib.moe_ffn(pp.subtree(p, "moe"), h, cfg)
        else:
            y = mlp(pp.subtree(p, "mlp"), h, cfg)
        x = x + y

    elif kind == "rec":
        h = _norm(p["ln1"], x, cfg)
        state = ((cache["conv"], cache["h"]) if mode == "decode" else None)
        y, (new_conv, new_h) = rglru.recurrent_block(
            pp.subtree(p, "rec"), h, cfg, state=state, impl=impl)
        x = x + y
        h = _norm(p["ln2"], x, cfg)
        x = x + mlp(pp.subtree(p, "mlp"), h, cfg)
        if mode == "decode":
            cache["conv"].copy_(new_conv)
            cache["h"].copy_(new_h)
            new_cache.update(cache)
        elif mode == "prefill":
            new_cache.update({"conv": new_conv, "h": new_h})

    elif kind == "rwkv":
        h = _norm(p["ln1"], x, cfg)
        dec = mode == "decode"
        y, (new_shift_tm, new_wkv) = rwkv.rwkv_time_mix(
            pp.subtree(p, "tm"), h, cfg,
            shift_state=cache["shift_tm"] if dec else None,
            wkv_state=cache["wkv"] if dec else None, impl=impl)
        x = x + y
        h = _norm(p["ln2"], x, cfg)
        y, new_shift_cm = rwkv.rwkv_channel_mix(
            pp.subtree(p, "cm"), h, cfg,
            shift_state=cache["shift_cm"] if dec else None)
        x = x + y
        state = {"shift_tm": new_shift_tm, "shift_cm": new_shift_cm,
                 "wkv": new_wkv}
        if dec:
            for key, val in state.items():
                cache[key].copy_(val)
            new_cache.update(cache)
        elif mode == "prefill":
            new_cache.update(state)

    else:
        raise ValueError(f"block kind {kind!r}")

    if cfg.seq_parallel and mode == "train":
        # Megatron-style sequence parallelism at the block boundaries
        x = constrain(x, "act_batch", "act_seq_sp", None)
    else:
        x = constrain(x, "act_batch", "act_seq", "act_embed")
    return x, (new_cache if new_cache else None), aux


# --------------------------------------------------------------------------
# full stack
# --------------------------------------------------------------------------

def _add_aux(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    for k, v in aux.items():
        acc[k] = acc[k] + v if k in acc else v
    return acc


def forward(params: Dict[str, torch.Tensor], cfg, *, mode: str,
            tokens: torch.Tensor = None, embeddings: torch.Tensor = None,
            cur_len=None, cache=None, cond=None, mrope_positions=None,
            impl: str = "pallas"):
    """Shared forward. Returns (hidden, new_cache, aux): aux sums each
    MoE layer's losses over the stack ({} without MoE layers). Decode
    updates ``cache`` in place and returns it.

    Inputs: ``tokens`` (B, S) int, or ``embeddings`` (B, S, d) for
    ``cfg.input_kind == "embeddings"``; ``cond`` (B, cond_len, d) for
    cross-attention (at decode None reads the cached conditioning k/v);
    ``mrope_positions`` (3, B, S) for M-RoPE, by default the token
    positions on all three streams (at decode ``cur_len``). At decode
    ``cur_len`` is an int, or a (B,) int tensor of each row's own
    position (``Model.decode_step``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if (mode == "decode") != (cache is not None):
        raise ValueError("decode, and only decode, takes a cache")
    if cfg.input_kind == "tokens":
        x = embed_tokens(params, tokens, cfg)
        b, s = tokens.shape
    else:
        x = embeddings.to(cfg.torch_dtype)
        b, s = embeddings.shape[:2]
    if cfg.cross_attn and cond is None and mode != "decode":
        raise ValueError("cross-attention needs cond (B, cond_len, d)")
    if mode == "decode" and isinstance(cur_len, torch.Tensor):
        if tuple(cur_len.shape) != (b,) or s != 1:
            raise ValueError(f"per-row cur_len {tuple(cur_len.shape)} for "
                             f"a ({b}, {s}) decode input: needs ({b},) and "
                             "one position a row")
        positions = cur_len.to(torch.int32)[:, None]
    elif mode == "decode":
        positions = torch.full((b, 1), cur_len, dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    positions = sdt.replicate_like(x, positions)
    if cfg.pos_kind == "mrope" and mrope_positions is None:
        mrope_positions = positions[None].expand(3, b, positions.shape[1])

    new_cache: Dict[str, torch.Tensor] = {}
    aux: Dict[str, torch.Tensor] = {}
    kw = dict(mode=mode, positions=positions, cur_len=cur_len, cond=cond,
              mrope_positions=mrope_positions, impl=impl)

    # ---- stacked cycles ----
    per_cycle: Dict[str, List[torch.Tensor]] = {}

    def cycle(x, c: int):
        cyc_aux: Dict[str, torch.Tensor] = {}
        for pos, kind in enumerate(cfg.block_pattern):
            pfx = f"stack/{pos}/{kind}/"
            p = {k[len(pfx):]: sdt.unshard_data(v[c])
                 for k, v in params.items()
                 if k.startswith(pfx)}
            cc = None
            if cache is not None:
                cc = {k: v[c] for k, v in
                      pp.subtree(cache, f"stack/{pos}").items()}
            x, nc, a = block_forward(kind, p, x, cfg, cache=cc, **kw)
            _add_aux(cyc_aux, a)
            if mode == "prefill":
                for kk, vv in nc.items():
                    per_cycle.setdefault(f"stack/{pos}/{kk}", []).append(vv)
        return x, cyc_aux

    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for c in range(cfg.n_cycles):
        x, a = (checkpoint(cycle, x, c, use_reentrant=False) if remat
                else cycle(x, c))
        _add_aux(aux, a)
    if mode == "prefill":
        new_cache.update({k: torch.stack(v) for k, v in per_cycle.items()})
    elif mode == "decode":
        new_cache.update({k: v for k, v in cache.items()
                          if k.startswith("stack/")})

    # ---- remainder layers ----
    for i in range(cfg.n_rem):
        kind = cfg.block_pattern[i]
        p = {k: sdt.unshard_data(v) for k, v in
             pp.subtree(params, f"rem/{i}/{kind}").items()}
        c = pp.subtree(cache, f"rem/{i}") if cache is not None else None
        x, nc, a = block_forward(kind, p, x, cfg, cache=c, **kw)
        _add_aux(aux, a)
        if nc:
            for kk, vv in nc.items():
                new_cache[f"rem/{i}/{kk}"] = vv

    x = _norm(params["final_norm"], x, cfg)
    return x, (new_cache if new_cache else None), aux


def logits_from_hidden(params, x, cfg):
    return unembed(params, x, cfg)
