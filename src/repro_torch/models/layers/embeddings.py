"""Token embeddings and rotary position encodings (RoPE + M-RoPE).

On a mesh the embedded tokens and the logits are pinned to the
reference's layouts (``constrain``), and the frequency tables go onto
the mesh replicated."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import constrain


def init_embeddings(ini, cfg) -> None:
    # std 1/sqrt(d): with embed_scale (gemma) the scaled embedding is
    # ~unit-std, and tied unembedding logits stay O(1).
    ini.make("embed/tokens", (cfg.vocab_size, cfg.d_model),
             ("vocab", "embed"), init="normal",
             scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        ini.make("embed/head", (cfg.d_model, cfg.vocab_size),
                 ("embed", "vocab"), init="normal")


def embed_tokens(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    table = sdt.unshard_data(params["embed/tokens"])
    if sdt.is_dtensor(table):
        tokens = sdt.replicate_like(table, tokens)
        x = _sharded_lookup(table, tokens.long()).to(cfg.torch_dtype)
    else:
        x = table[tokens.long()].to(cfg.torch_dtype)
    if cfg.embed_scale:
        # the factor is rounded to the activation dtype before the multiply
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return constrain(x, "act_batch", "act_seq", "act_embed")


def _sharded_lookup(table, tokens):
    """``table[tokens]`` of DTensors on each rank's shards: the tokens
    keep their batch shards; where the table's vocabulary is sharded,
    each rank takes the rows it holds (0 elsewhere) and the rows are a
    partial sum over those ranks (an index op on the table would gather
    it whole, and DTensor has no rule for tokens sharded over two mesh
    dims); where its embed dim is sharded (the decode's table, not
    gathered), each rank takes its columns of every row."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    t_pl, t_grad, i_pl, o_pl, vdims = [], [], [], [], []
    for d, (tp, ip) in enumerate(zip(table.placements, tokens.placements)):
        if tp == Shard(0):
            t_pl.append(tp), t_grad.append(tp), i_pl.append(Replicate())
            o_pl.append(Partial()), vdims.append(d)
        elif tp == Shard(1):
            t_pl.append(tp), t_grad.append(tp), i_pl.append(Replicate())
            o_pl.append(Shard(tokens.dim()))
        else:       # the table's gradient: a partial sum over a token shard
            keep = ip if isinstance(ip, Shard) else Replicate()
            t_pl.append(Replicate()), i_pl.append(keep), o_pl.append(keep)
            t_grad.append(Partial() if isinstance(ip, Shard) else keep)

    def fn(tl, il):
        if not vdims:
            return tl[il]
        lo = sdt.coord(mesh, vdims) * tl.shape[0]
        inside = (il >= lo) & (il < lo + tl.shape[0])
        rows = tl[torch.where(inside, il - lo, 0)]
        return torch.where(inside[..., None], rows, 0)
    return sdt.local(fn, mesh, o_pl, (t_pl, i_pl), (t_grad, i_pl))(table,
                                                                   tokens)


class _MatmulF32(torch.autograd.Function):
    """x (M, K) @ w (K, N) of low-precision operands on the card, fp32
    result (``torch.mm``'s ``out_dtype``, which has no derivative). The
    backward takes the fp32 cotangent as two halves in the operands'
    dtype (hi, and the rest lo: 16 significant bits in bf16) through the
    same products summed in fp32, and casts each gradient to its
    operand's dtype, as the transpose of the reference's
    ``preferred_element_type`` dot does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hi = g.to(x.dtype)
        lo = (g - hi.float()).to(x.dtype)
        f32 = torch.float32
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (torch.mm(hi, w.T, out_dtype=f32)
                  + torch.mm(lo, w.T, out_dtype=f32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (torch.mm(x.T, hi, out_dtype=f32)
                  + torch.mm(x.T, lo, out_dtype=f32)).to(w.dtype)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with an fp32 result: the products of the
    operands' dtype summed in fp32 (``preferred_element_type=float32``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if sdt.is_dtensor(x):
        # on each rank's shards (``torch.mm``'s ``out_dtype`` has no
        # DTensor rule); the decode's tied head keeps its table's rows
        return sdt.contract(matmul_f32, x, w)
    if not ops._on_cpu(x):          # the card (or a trace of it)
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(x.shape[:-1] + (w.shape[-1],))
    return x.float() @ w.float()


def unembed(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits in fp32."""
    if cfg.tie_embeddings:
        w = sdt.unshard_data(params["embed/tokens"]).to(x.dtype).T
    else:
        w = sdt.unshard_data(params["embed/head"]).to(x.dtype)
    logits = matmul_f32(x, w)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return constrain(logits, "act_batch", "act_seq", "act_vocab")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, ..., head_dim); positions: (B, S) int.

    NeoX-style half rotation: pairs are (x[..., :d/2], x[..., d/2:]).
    """
    dh = x.shape[-1]
    freqs = sdt.replicate_like(x, rope_freqs(dh, theta, x.device))
    angles = positions[..., None].float() * freqs           # (B,S,dh/2)
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x rotated by angles (B, S, dh/2), broadcast over the head axes."""
    dh = x.shape[-1]
    while angles.dim() < x.dim():
        angles = angles[..., None, :]                       # head axes
    # cos/sin are rounded to the activation dtype before the multiply,
    # as in the reference
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Tuple[int, int, int], theta: float
                ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions: (3, B, S), the temporal,
    height and width position ids; ``sections`` splits the dh/2
    frequencies among the three streams in that order (e.g. (16, 24, 24)
    for head_dim 128)."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {dh // 2}")
    freqs = sdt.replicate_like(x, rope_freqs(dh, theta, x.device))
    ang = positions[..., None].float() * freqs              # (3,B,S,dh/2)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (dh/2,)
    sec = sdt.replicate_like(x, sec_id.expand(ang.shape[1:])[None])
    angles = ang.gather(0, sec)[0]
    return _rotate(x, angles)
