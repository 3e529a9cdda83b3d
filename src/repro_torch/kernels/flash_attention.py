"""CUDA wrappers: causal / sliding-window flash attention with GQA heads
(sources ``csrc/flash_attention.cu``, fp32 on the tensor cores in 3xTF32
``mma.sync``, and ``csrc/flash_attention_wgmma.cu``, bf16 on the tensor
cores' wgmma) and its backward (``flash_attention_bwd``:
``csrc/flash_attention_bwd.cu``, fp32 in 3xTF32 ``mma.sync``, and
``csrc/flash_attention_bwd_wgmma.cu``, bf16 on wgmma).

q (BH, Sq, dh) and k/v (BH / G, Sk, dh), all fp32 or all bf16, on the
card -> (BH, Sq, dh) in q's dtype, the fp32 function inside (bf16: exact
bf16 products summed in fp32, and P, and in the backward dS, split into
two bf16 halves where they are a product's operand; fp32: every operand
split into TF32 hi + lo and each product run as three TF32 products;
a scan of the call's inputs for a NaN comes first, and only where it
finds one do the kernels run the split that keeps it, one instruction
more a value); query row i reads kv row i // G. dh is 64, 128 or 256. The forward can
also return each row's log-sum-exp (fp32 (BH, Sq), natural-log units,
-inf for a row with no allowed key), which the backward takes. Launches
on PyTorch's current stream without synchronising; raises on a tensor
off the card, a wrong dtype, shape or layout, a lazy view, an operand not
16-byte aligned (the kernels copy with TMA or cp.async), and on a launch
CUDA refuses. ``ops.attention`` is the dispatch that sends CPU tensors to
``ref.attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.zgemm import check_operand, launch

# dtype codes of the sequence kernels' C entry points (qf::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def _nan_flag(q: torch.Tensor):
    """The fp32 kernels' int of device memory, where their C entry scans
    the call's inputs for a NaN (the split that keeps one runs only then);
    None for bf16."""
    if q.dtype != torch.float32:
        return None
    return torch.empty(1, dtype=torch.int32, device=q.device)


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
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: operands must start on a 16-byte "
                         "boundary (the kernels load them with TMA or "
                         "cp.async)")
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    flag = _nan_flag(q)
    launch("flash_attention", "qf_flash_attention", dev, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if lse is None else lse.data_ptr(),
           None if flag is None else flag.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), DTYPE_CODES[q.dtype])
    return (out, lse) if return_lse else out


def bwd_splits(bh: int, bk: int, sk: int, sms: int) -> int:
    """How many blocks share a kv head's G query heads in the backward's
    dK/dV pass (both dtypes: their blocks hold 64 keys): enough (64-key,
    kv head, split) blocks for two waves over the card's ``sms`` SMs, at
    most G. The blocks' work is uneven under causal masks, and the second
    wave evens it out."""
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
    to an fp32 workspace), then the dK/dV pass, which writes fp32 partial
    sums over ``bwd_splits`` groups of query heads, then a third kernel
    that adds them in order."""
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
    if any(x.data_ptr() % 16 for x in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: operands must start on a "
                         "16-byte boundary (the kernels load them with TMA "
                         "or cp.async)")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dd = torch.empty_like(lse)
    splits = bwd_splits(bh, bk, sk, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    part = torch.empty((splits, 2, bk, sk, dh), dtype=torch.float32,
                       device=q.device)
    flag = _nan_flag(q)
    launch("flash_attention_bwd", "qf_flash_attention_bwd", dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), dd.data_ptr(), part.data_ptr(),
           None if flag is None else flag.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), splits, DTYPE_CODES[q.dtype])
    return dq, dk, dv


# the kernels' names in the machine code: the forward, and the backward's
# dQ and dK/dV passes (each built at dh 64, 128 and 256)
BF16_KERNELS = ("flash_wgmma_kernel", "attn_bwd_dq_wgmma_kernel",
                "attn_bwd_dkdv_wgmma_kernel")
FP32_KERNELS = ("flash_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")


def design(kernels, keep: str = "") -> str:
    """The tensor-core instruction the built ``kernels`` issue, read from
    the lines of their machine code that hold ``keep``: "wgmma" (HGMMA) or
    "mma.sync" (HMMA) where every build of every one of them has it, else
    "none" (also where one of them is not built)."""
    sass = build.sass()
    code = [[ln for ln in text.splitlines() if keep in ln]
            for name, text in sass.items() if any(k in name for k in kernels)]
    built = all(any(k in name for name in sass) for k in kernels)
    for instr, name in (("HGMMA", "wgmma"), ("HMMA", "mma.sync")):
        if built and all(any(instr in ln for ln in lines) for lines in code):
            return name
    return "none"


def bf16_design() -> str:
    """``design`` of the bf16 kernels."""
    return design(BF16_KERNELS)


def fp32_design() -> str:
    """``design`` of the fp32 kernels from their TF32 instructions: "none"
    for kernels on the CUDA cores."""
    return design(FP32_KERNELS, "TF32")
