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
(b, h, stage), sized by ``bwd_workspace_floats`` (the formula of the C
entry ``qf_gla_chunked_bwd_workspace``). ``backward_copies_by_tma`` says
how the kernel will copy a set of operands' rows.

Both kernels are registered ops (``torch.ops.repro_torch.gla_chunked``,
``...gla_chunked_bwd``) with fakes: under ``FakeTensorMode`` they give
the outputs' shapes and dtypes (the backward's op returns its three
workspaces too) and launch nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.zgemm import check_operand, launch, refuse_lazy

MAX_HEAD_DIM = 64
MAX_CHUNK = 64
BWD_STAGE = 16       # tokens a stage of the backward kernel (kStage)


def kernel_chunk(chunk: int) -> int:
    """The sub-chunk the kernel runs for a given chunk."""
    return max(c for c in range(1, min(chunk, MAX_CHUNK) + 1)
               if chunk % c == 0)


def bwd_workspace_floats(b: int, s: int, h: int, part: int) -> int:
    """fp32 elements of the backward's workspace ``part``: 0 and 1 hold a
    (64, 64) state per (b, h, stage), 2 du's 64-row partial per (b, h,
    stage) (``qf_gla_chunked_bwd_workspace``)."""
    per = b * h * (-(-s // BWD_STAGE))
    return per * MAX_HEAD_DIM * (MAX_HEAD_DIM if part < 2 else 1)


def _dtypes(r, w):
    for name, x in (("r", r), ("w", w)):
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: expected float32 or bfloat16, got "
                             f"{x.dtype}")


def _shapes(r, k, v, w, u, chunk, extra=()):
    """(b, s, h, dh) of operands the kernels take, device apart; raises on
    a dtype or shape they refuse (``extra``: further (name, tensor) pairs
    of r's shape and dtype)."""
    _dtypes(r, w)
    named = (("r", r), ("k", k), ("v", v)) + tuple(extra)
    b, s, h, dh = r.shape
    if (any(x.shape != r.shape or x.dtype != r.dtype for _, x in named)
            or w.shape != r.shape or u.shape != (h, dh)
            or u.dtype != torch.float32):
        raise ValueError("gla_chunked: " + ", ".join(
            f"{name} {tuple(x.shape)} {x.dtype}"
            for name, x in named + (("w", w), ("u", u))))
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"gla_chunked: head_dim {dh} > {MAX_HEAD_DIM}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"gla_chunked: chunk {chunk} does not divide the "
                         f"sequence {s}")
    return b, s, h, dh


def _check(r, k, v, w, u, chunk, extra=()):
    """Raise unless the operands are what the kernels take: each a
    contiguous tensor on the card (``check_operand``), all on r's, and
    ``_shapes``'s checks. Returns (b, s, h, dh, device index)."""
    _dtypes(r, w)
    named = (("r", r), ("k", k), ("v", v)) + tuple(extra)
    for name, x in named:
        check_operand(x, name, 4, dtype=r.dtype)
    check_operand(w, "w", 4, dtype=w.dtype)
    check_operand(u, "u", 2, dtype=torch.float32)
    dev = r.get_device()
    named += (("w", w), ("u", u))
    if any(x.get_device() != dev for _, x in named):
        raise ValueError("gla_chunked: operands on more than one card: "
                         + ", ".join(f"{n} {x.device}" for n, x in named))
    return _shapes(r, k, v, w, u, chunk, extra) + (dev,)


@torch.library.custom_op("repro_torch::gla_chunked", mutates_args=())
def _fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, dh, dev = _check(r, k, v, w, u, chunk)
    out = torch.empty_like(r)
    state = r.new_empty((b, h, dh, dh), dtype=torch.float32)
    launch("gla_chunked", "qf_gla_chunked", dev, r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
           state.data_ptr(), b, s, h, dh, kernel_chunk(chunk),
           DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype])
    return out, state


@_fwd_op.register_fake
def _fwd_fake(r, k, v, w, u, chunk):
    b, _, h, dh = _shapes(r, k, v, w, u, chunk)
    return torch.empty_like(r), r.new_empty((b, h, dh, dh),
                                            dtype=torch.float32)


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int):
    refuse_lazy(("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    return torch.ops.repro_torch.gla_chunked(r, k, v, w, u, chunk)


def _bwd_outputs(r, w, u, b, s, h):
    """dr, dk, dv, dw, du and the three fp32 workspaces, allocated."""
    return ((*(torch.empty_like(r) for _ in range(3)), torch.empty_like(w),
             u.new_empty(u.shape))
            + tuple(r.new_empty((bwd_workspace_floats(b, s, h, part),),
                                dtype=torch.float32) for part in range(3)))


@torch.library.custom_op("repro_torch::gla_chunked_bwd", mutates_args=())
def _bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
            dstate: torch.Tensor | None, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, h, dh, dev = _check(r, k, v, w, u, chunk, (("dout", dout),))
    if dstate is not None:
        check_operand(dstate, "dstate", 4, dtype=torch.float32)
        if dstate.shape != (b, h, dh, dh) or dstate.get_device() != dev:
            raise ValueError(f"gla_chunked_bwd: dstate {tuple(dstate.shape)}"
                             f", expected {(b, h, dh, dh)}")
    outs = _bwd_outputs(r, w, u, b, s, h)
    launch("gla_chunked_bwd", "qf_gla_chunked_bwd", dev, r.data_ptr(),
           k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
           dout.data_ptr(), None if dstate is None else dstate.data_ptr(),
           *(x.data_ptr() for x in outs), b, s, h, dh, DTYPE_CODES[r.dtype],
           DTYPE_CODES[w.dtype])
    return outs


@_bwd_op.register_fake
def _bwd_fake(r, k, v, w, u, dout, dstate, chunk):
    b, s, h, _ = _shapes(r, k, v, w, u, chunk, (("dout", dout),))
    return _bwd_outputs(r, w, u, b, s, h)


def gla_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                    dstate: torch.Tensor | None = None, *, chunk: int):
    """(dr, dk, dv, dw, du) of ``gla_chunked`` for the cotangents ``dout``
    of out and ``dstate`` of the final state (None: zero)."""
    refuse_lazy(("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                ("dout", dout), ("dstate", dstate))
    return torch.ops.repro_torch.gla_chunked_bwd(r, k, v, w, u, dout, dstate,
                                                 chunk)[:5]


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
