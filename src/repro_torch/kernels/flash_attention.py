"""CUDA wrapper: causal / sliding-window flash attention with GQA heads
(sources ``csrc/flash_attention.cu``, fp32 on the CUDA cores, and
``csrc/flash_attention_wgmma.cu``, bf16 on the tensor cores).

q (BH, Sq, dh) and k/v (BH / G, Sk, dh), all fp32 or all bf16, on the
card -> (BH, Sq, dh) in q's dtype, the fp32 function inside (bf16: exact
bf16 products summed in fp32, and P split into two bf16 halves for P V);
query row i reads kv row i // G. dh is 64, 128 or 256. Launches on
PyTorch's current stream without synchronising; raises on a tensor off
the card, a wrong dtype, shape or layout, a lazy view, a bf16 operand
not 16-byte aligned (TMA), and on a launch CUDA refuses.
``ops.attention`` is the dispatch that sends CPU tensors to
``ref.attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.zgemm import check_operand, launch

# dtype codes of the sequence kernels' C entry points (qf::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(x, name, 3, dtype=q.dtype)
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    dev = q.get_device()
    if (v.shape != k.shape or k.shape[2] != dh or bh % bk
            or k.get_device() != dev or v.get_device() != dev):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("flash_attention: bf16 operands must start on a "
                         "16-byte boundary (the kernel loads them with TMA)")
    out = torch.empty_like(q)
    launch("flash_attention", "qf_flash_attention", dev, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), DTYPE_CODES[q.dtype])
    return out


def bf16_design() -> str:
    """The tensor-core instruction the built bf16 kernels issue, read from
    their machine code: "wgmma" (HGMMA), "mma.sync" (HMMA), else "none"."""
    code = [t for name, t in build.sass().items()
            if "flash_wgmma_kernel" in name]
    if code and all("HGMMA" in t for t in code):
        return "wgmma"
    if code and all("HMMA" in t for t in code):
        return "mma.sync"
    return "none"
