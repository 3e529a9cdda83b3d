"""CUDA wrapper: RWKV6 wkv as chunked gated linear attention (source
``csrc/gla_chunked.cu``).

r, k, v (B, S, H, dh), all fp32 or all bf16, w (B, S, H, dh) fp32 or
bf16 (its own dtype: the model keeps it fp32), u (H, dh) fp32, all on
the card, ``chunk`` dividing S -> out (B, S, H, dh) in r's dtype and the
final state (B, H, dh, dh) in fp32; fp32 arithmetic inside. dh is at
most 64. A chunk longer than 64 runs as sub-chunks of its largest
divisor up to 64: the function does not depend on the chunk, only the
rounding does. Launches on PyTorch's current stream without
synchronising; raises on a tensor off the card, a wrong dtype, shape or
layout, a lazy view, and on a launch CUDA refuses. ``ops.gla_chunked``
is the dispatch that sends CPU tensors to ``ref.gla_chunked_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.zgemm import check_operand, launch

MAX_HEAD_DIM = 64
MAX_CHUNK = 64


def kernel_chunk(chunk: int) -> int:
    """The sub-chunk the kernel runs for a given chunk."""
    return max(c for c in range(1, min(chunk, MAX_CHUNK) + 1)
               if chunk % c == 0)


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int):
    for name, x in (("r", r), ("w", w)):
        if x.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: expected float32 or bfloat16, got "
                             f"{x.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        check_operand(x, name, 4, dtype=r.dtype)
    check_operand(w, "w", 4, dtype=w.dtype)
    check_operand(u, "u", 2, dtype=torch.float32)
    b, s, h, dh = r.shape
    dev = r.get_device()
    if (any(x.shape != r.shape for x in (k, v, w)) or u.shape != (h, dh)
            or any(x.get_device() != dev for x in (k, v, w, u))):
        raise ValueError(f"gla_chunked: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"gla_chunked: head_dim {dh} > {MAX_HEAD_DIM}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"gla_chunked: chunk {chunk} does not divide the "
                         f"sequence {s}")
    out = torch.empty_like(r)
    state = r.new_empty((b, h, dh, dh), dtype=torch.float32)
    launch("gla_chunked", "qf_gla_chunked", dev, r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
           state.data_ptr(), b, s, h, dh, kernel_chunk(chunk),
           DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype])
    return out, state
