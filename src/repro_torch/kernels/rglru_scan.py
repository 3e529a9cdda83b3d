"""CUDA wrapper: the RG-LRU diagonal recurrence h_t = a_t h_{t-1} + b_t,
h_0 = 0 (source ``csrc/rglru_scan.cu``).

a, b (B, S, D), both fp32 or both bf16, on the card -> h (B, S, D) in
a's dtype, fp32 carry. Launches on PyTorch's current stream without
synchronising; raises on a tensor off the card, a wrong dtype, shape or
layout, a lazy view, and on a launch CUDA refuses. ``ops.lru_scan`` is
the dispatch that sends CPU tensors to ``ref.rglru_scan_ref``. The kernel
is a registered op (``torch.ops.repro_torch.rglru_scan``) whose fake gives
h's shape and dtype under ``FakeTensorMode`` and launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.zgemm import check_operand, launch, refuse_lazy


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in DTYPE_CODES:
        raise ValueError(f"a: expected float32 or bfloat16, got {a.dtype}")
    if a.dim() != 3 or b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}")


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    check_operand(a, "a", 3, dtype=a.dtype)
    check_operand(b, "b", 3, dtype=a.dtype)
    dev = a.get_device()
    if b.get_device() != dev:
        raise ValueError(f"rglru_scan: a on {a.device}, b on {b.device}")
    bsz, s, d = a.shape
    out = torch.empty_like(a)
    launch("rglru_scan", "qf_rglru_scan", dev, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), bsz, s, d, DTYPE_CODES[a.dtype])
    return out


@_scan_op.register_fake
def _scan_fake(a, b):
    _check(a, b)
    return torch.empty_like(a)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    refuse_lazy(("a", a), ("b", b))
    return torch.ops.repro_torch.rglru_scan(a, b)
