"""CUDA wrapper: the RG-LRU diagonal recurrence h_t = a_t h_{t-1} + b_t,
h_0 = 0 (source ``csrc/rglru_scan.cu``).

a, b (B, S, D), both fp32 or both bf16, on the card -> h (B, S, D) in
a's dtype, fp32 carry. Launches on PyTorch's current stream without
synchronising; raises on a tensor off the card, a wrong dtype, shape or
layout, a lazy view, and on a launch CUDA refuses. ``ops.lru_scan`` is
the dispatch that sends CPU tensors to ``ref.rglru_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.zgemm import check_operand, stream_of


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype not in DTYPE_CODES:
        raise ValueError(f"a: expected float32 or bfloat16, got {a.dtype}")
    check_operand(a, "a", 3, dtype=a.dtype)
    check_operand(b, "b", 3, dtype=a.dtype)
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    bsz, s, d = a.shape
    lib = build.load()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.qf_rglru_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                bsz, s, d, DTYPE_CODES[a.dtype], stream_of(a))
    build.LAUNCHES["rglru_scan"] += 1
    build.check(err, "rglru_scan launch")
    return out
