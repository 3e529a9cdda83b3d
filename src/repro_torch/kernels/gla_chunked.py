"""CUDA wrappers: RWKV6 wkv as chunked gated linear attention (source
``csrc/gla_chunked.cu``) and its gradient (``csrc/gla_chunked_bwd.cu``).

r, k, v (B, S, H, dh), all fp32 or all bf16, w (B, S, H, dh) fp32 or
bf16 (its own dtype: the model keeps it fp32), u (H, dh) fp32, all on
the card, ``chunk`` dividing S -> out (B, S, H, dh) in r's dtype and the
final state (B, H, dh, dh) in fp32; fp32 arithmetic inside. dh is at
most 64. A chunk longer than 64 runs as sub-chunks of its largest
divisor up to 64: the function does not depend on the chunk, only the
rounding does. Launches on PyTorch's current stream without
synchronising; raises on a tensor off the card, a wrong dtype, shape or
layout, a lazy view, and on a launch CUDA refuses. ``ops.gla_chunked``
is the dispatch that sends CPU tensors to ``ref.gla_chunked_ref`` and,
on the card, differentiates through both kernels.

``gla_chunked_bwd`` takes the same operands, the cotangent ``dout`` of
out in r's dtype and optionally ``dstate`` of the final state
(B, H, dh, dh) fp32, and returns dr, dk, dv in r's dtype, dw in w's
dtype and du (H, dh) fp32: the plain version is
``ref.gla_chunked_bwd_ref``. The kernel cuts the sequence into stages of
16 tokens; the wrapper allocates its fp32 workspaces for the launch:
the state before each stage and its cotangent after each stage's last
token (B * H * stages * 64 * 64 floats each), and du's partial a
(b, h, stage). ``backward_copies_by_tma`` says how the kernel will copy
a set of operands' rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.zgemm import check_operand, launch

MAX_HEAD_DIM = 64
MAX_CHUNK = 64


def kernel_chunk(chunk: int) -> int:
    """The sub-chunk the kernel runs for a given chunk."""
    return max(c for c in range(1, min(chunk, MAX_CHUNK) + 1)
               if chunk % c == 0)


def _check(r, k, v, w, u, chunk, extra=()):
    """Raise unless the operands are what the kernels take (``extra``:
    further (name, tensor) pairs of r's shape and dtype)."""
    for name, x in (("r", r), ("w", w)):
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: expected float32 or bfloat16, got "
                             f"{x.dtype}")
    named = (("r", r), ("k", k), ("v", v)) + tuple(extra)
    for name, x in named:
        check_operand(x, name, 4, dtype=r.dtype)
    check_operand(w, "w", 4, dtype=w.dtype)
    check_operand(u, "u", 2, dtype=torch.float32)
    b, s, h, dh = r.shape
    dev = r.get_device()
    xs = [x for _, x in named[1:]] + [w]
    if (any(x.shape != r.shape for x in xs) or u.shape != (h, dh)
            or any(x.get_device() != dev for x in xs + [u])):
        raise ValueError("gla_chunked: " + ", ".join(
            f"{name} {tuple(x.shape)}"
            for name, x in named + (("w", w), ("u", u))))
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"gla_chunked: head_dim {dh} > {MAX_HEAD_DIM}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"gla_chunked: chunk {chunk} does not divide the "
                         f"sequence {s}")
    return b, s, h, dh, dev


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int):
    b, s, h, dh, dev = _check(r, k, v, w, u, chunk)
    out = torch.empty_like(r)
    state = r.new_empty((b, h, dh, dh), dtype=torch.float32)
    launch("gla_chunked", "qf_gla_chunked", dev, r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
           state.data_ptr(), b, s, h, dh, kernel_chunk(chunk),
           DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype])
    return out, state


def gla_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                    dstate: torch.Tensor | None = None, *, chunk: int):
    """(dr, dk, dv, dw, du) of ``gla_chunked`` for the cotangents ``dout``
    of out and ``dstate`` of the final state (None: zero)."""
    b, s, h, dh, dev = _check(r, k, v, w, u, chunk, (("dout", dout),))
    if dstate is not None:
        check_operand(dstate, "dstate", 4, dtype=torch.float32)
        if dstate.shape != (b, h, dh, dh) or dstate.get_device() != dev:
            raise ValueError(f"gla_chunked_bwd: dstate {tuple(dstate.shape)}"
                             f", expected {(b, h, dh, dh)}")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = u.new_empty((h, dh))
    size = build.load().qf_gla_chunked_bwd_workspace
    ck_f, ck_b, du_part = (
        r.new_empty((size(b, s, h, part),), dtype=torch.float32)
        for part in range(3))
    launch("gla_chunked_bwd", "qf_gla_chunked_bwd", dev, r.data_ptr(),
           k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
           dout.data_ptr(), None if dstate is None else dstate.data_ptr(),
           dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
           du.data_ptr(), ck_f.data_ptr(), ck_b.data_ptr(),
           du_part.data_ptr(), b, s, h, dh, DTYPE_CODES[r.dtype],
           DTYPE_CODES[w.dtype])
    return dr, dk, dv, dw, du


def backward_copies_by_tma(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                           dout: torch.Tensor) -> bool:
    """Whether ``gla_chunked_bwd`` copies these operands' rows by TMA
    (16-byte aligned pointers and rows), not element by element. The
    kernel decides from the operands alone, and a tensor map it cannot
    encode for them makes the launch fail."""
    return bool(build.load().qf_gla_chunked_bwd_tma(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dout.data_ptr(), r.shape[-1], DTYPE_CODES[r.dtype],
        DTYPE_CODES[w.dtype]))
