"""CUDA wrappers: causal / sliding-window flash attention with GQA heads
(sources ``csrc/flash_attention.cu``, fp32 on the CUDA cores, and
``csrc/flash_attention_wgmma.cu``, bf16 on the tensor cores) and its
backward (``flash_attention_bwd``: ``csrc/flash_attention_bwd_wgmma.cu``,
bf16 on the tensor cores, and ``csrc/flash_attention_bwd.cu``, fp32 on
the CUDA cores).

q (BH, Sq, dh) and k/v (BH / G, Sk, dh), all fp32 or all bf16, on the
card -> (BH, Sq, dh) in q's dtype, the fp32 function inside (bf16: exact
bf16 products summed in fp32, and P, and in the backward dS, split into
two bf16 halves where they are a product's operand); query row i reads
kv row i // G. dh is 64, 128 or 256. The forward can also return each
row's log-sum-exp (fp32 (BH, Sq), natural-log units, -inf for a row with
no allowed key), which the backward takes. Launches on PyTorch's current
stream without synchronising; raises on a tensor off the card, a wrong
dtype, shape or layout, a lazy view, a bf16 operand not 16-byte aligned
(TMA), and on a launch CUDA refuses. ``ops.attention`` is the dispatch
that sends CPU tensors to ``ref.attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.zgemm import check_operand, launch

# dtype codes of the sequence kernels' C entry points (qf::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """out, or (out, lse) with ``return_lse``."""
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
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    launch("flash_attention", "qf_flash_attention", dev, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), DTYPE_CODES[q.dtype])
    return (out, lse) if return_lse else out


def bwd_splits(bh: int, bk: int, sk: int, sms: int) -> int:
    """How many blocks share a kv head's G query heads in the bf16
    backward's dK/dV pass: enough (64-key, kv head, split) blocks for two
    waves over the card's ``sms`` SMs, at most G. The blocks' work is
    uneven under causal masks, and the second wave evens it out."""
    blocks = -(-sk // 64) * bk
    return min(bh // bk, max(1, -(-2 * sms // blocks)))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: torch.Tensor, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` for the cotangent
    ``dout`` of its output ``out`` and its log-sum-exp ``lse``, each in
    q's dtype and shaped as its input. One launch count for the kernels
    of the C entry point: the dQ pass (which also writes each row's D_i
    to an fp32 workspace), then the dK/dV pass; in bf16 the dK/dV pass
    writes fp32 partial sums over ``bwd_splits`` groups of query heads,
    which a third kernel adds in order."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        check_operand(x, name, 3, dtype=q.dtype)
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    dev = q.get_device()
    if (v.shape != k.shape or k.shape[2] != dh or bh % bk
            or out.shape != q.shape or dout.shape != q.shape
            or any(x.get_device() != dev for x in (k, v, out, dout))):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {dh} not in "
                         f"{HEAD_DIMS}")
    check_operand(lse, "lse", 2, dtype=torch.float32)
    if lse.shape != (bh, sq) or lse.get_device() != dev:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"expected ({bh}, {sq}) on the card of q")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: bf16 operands must start on "
                         "a 16-byte boundary (the kernels load them with "
                         "TMA)")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dd = torch.empty_like(lse)
    splits = (bwd_splits(bh, bk, sk, torch.cuda.get_device_properties(
        q.device).multi_processor_count) if bf16 else 1)
    part = (torch.empty((splits, 2, bk, sk, dh), dtype=torch.float32,
                        device=q.device) if bf16 else None)
    launch("flash_attention_bwd", "qf_flash_attention_bwd", dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), dd.data_ptr(),
           None if part is None else part.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), splits, DTYPE_CODES[q.dtype])
    return dq, dk, dv


# the bf16 kernels' names in the machine code: the forward, and the
# backward's dQ and dK/dV passes
BF16_KERNELS = ("flash_wgmma_kernel", "attn_bwd_dq_wgmma_kernel",
                "attn_bwd_dkdv_wgmma_kernel")


def bf16_design() -> str:
    """The tensor-core instruction the built bf16 kernels (the forward and
    the backward's two passes) issue, read from their machine code:
    "wgmma" (HGMMA), "mma.sync" (HMMA), else "none"."""
    code = [t for name, t in build.sass().items()
            if any(k in name for k in BF16_KERNELS)]
    if code and all("HGMMA" in t for t in code):
        return "wgmma"
    if code and all("HMMA" in t for t in code):
        return "mma.sync"
    return "none"
