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

Query row i sits at position i + ``q_offset`` (a shard of the query
sequence under context parallelism: its rows start there); keys at 0..
Both dtypes take any offset >= 0; the masks and the tiles each block
skips move with it, nothing else does.

Each kernel is a registered op (``torch.ops.repro_torch.flash_attention``,
``...flash_attention_bwd``) with a fake: under ``FakeTensorMode`` (and so
under a traced DTensor step) the fake gives the kernel's outputs and the
workspaces its wrapper allocates, shape and dtype, and launches nothing.
The backward's op returns its workspaces too (D_i and the dK/dV
partials), so a trace sees what a launch holds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.zgemm import check_operand, launch, refuse_lazy

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


# SMs of the card the fakes size the backward's split for when the
# process has none (the H100 SXM's)
H100_SMS = 132


def _checked_dtype(q: torch.Tensor) -> torch.dtype:
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    return q.dtype


def _shapes(q, k, v, q_offset, name="flash_attention"):
    """(bh, sq, dh, bk, sk) of operands the kernels take, device apart;
    raises on a dtype, a shape or an offset they refuse."""
    _checked_dtype(q)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype}")
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    if v.shape != k.shape or k.shape[2] != dh or bh % bk:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset}: the kernels take "
                         "queries from any position >= 0")
    return bh, sq, dh, bk, sk


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, q_offset: int, return_lse: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    dtype = _checked_dtype(q)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(x, name, 3, dtype=dtype)
    bh, sq, dh, bk, sk = _shapes(q, k, v, q_offset)
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_attention: q, k, v on different cards")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: operands must start on a 16-byte "
                         "boundary (the kernels load them with TMA or "
                         "cp.async)")
    out = torch.empty_like(q)
    lse = q.new_empty((bh, sq) if return_lse else (0,), dtype=torch.float32)
    flag = _nan_flag(q)
    launch("flash_attention", "qf_flash_attention", dev, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr() if return_lse else None,
           None if flag is None else flag.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), int(q_offset), DTYPE_CODES[q.dtype])
    return out, lse


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, window, q_offset, return_lse):
    bh, sq, _, _, _ = _shapes(q, k, v, q_offset)
    return (torch.empty_like(q),
            q.new_empty((bh, sq) if return_lse else (0,),
                        dtype=torch.float32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False, q_offset: int = 0):
    """out, or (out, lse) with ``return_lse``."""
    refuse_lazy(("q", q), ("k", k), ("v", v))
    out, lse = torch.ops.repro_torch.flash_attention(
        q, k, v, causal, window, q_offset, return_lse)
    return (out, lse) if return_lse else out


def bwd_splits(bh: int, bk: int, sk: int, sms: int) -> int:
    """How many blocks share a kv head's G query heads in the backward's
    dK/dV pass (both dtypes: their blocks hold 64 keys): enough (64-key,
    kv head, split) blocks for two waves over the card's ``sms`` SMs, at
    most G. The blocks' work is uneven under causal masks, and the second
    wave evens it out."""
    blocks = -(-sk // 64) * bk
    return min(bh // bk, max(1, -(-2 * sms // blocks)))


def _sms(device: torch.device) -> int:
    """SMs of ``device``'s card; the H100's where the process has no card
    (a trace on fake tensors)."""
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _bwd_workspaces(q, lse, bh, bk, sk, dh):
    """The backward's fp32 workspaces: D_i (as lse) and the dK/dV pass's
    partial sums (splits, 2, bk, sk, dh)."""
    splits = bwd_splits(bh, bk, sk, _sms(q.device))
    return (torch.empty_like(lse),
            q.new_empty((splits, 2, bk, sk, dh), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
            causal: bool, window: int, q_offset: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    dtype = _checked_dtype(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        check_operand(x, name, 3, dtype=dtype)
    bh, sq, dh, bk, sk = _shapes(q, k, v, q_offset, "flash_attention_bwd")
    dev = q.get_device()
    if (out.shape != q.shape or dout.shape != q.shape
            or any(x.get_device() != dev for x in (k, v, out, dout))):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    check_operand(lse, "lse", 2, dtype=torch.float32)
    if lse.shape != (bh, sq) or lse.get_device() != dev:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"expected ({bh}, {sq}) on the card of q")
    if any(x.data_ptr() % 16 for x in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: operands must start on a "
                         "16-byte boundary (the kernels load them with TMA "
                         "or cp.async)")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dd, part = _bwd_workspaces(q, lse, bh, bk, sk, dh)
    flag = _nan_flag(q)
    launch("flash_attention_bwd", "qf_flash_attention_bwd", dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), dd.data_ptr(), part.data_ptr(),
           None if flag is None else flag.data_ptr(), bh, bk, sq, sk, dh,
           int(causal), int(window), int(q_offset), part.shape[0],
           DTYPE_CODES[q.dtype])
    return dq, dk, dv, dd, part


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, dout, lse, causal, window, q_offset):
    bh, _, dh, bk, sk = _shapes(q, k, v, q_offset, "flash_attention_bwd")
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            *_bwd_workspaces(q, lse, bh, bk, sk, dh))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: torch.Tensor, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` for the cotangent
    ``dout`` of its output ``out`` and its log-sum-exp ``lse``, each in
    q's dtype and shaped as its input. One launch count for the kernels
    of the C entry point: the dQ pass (which also writes each row's D_i
    to an fp32 workspace), then the dK/dV pass, which writes fp32 partial
    sums over ``bwd_splits`` groups of query heads, then a third kernel
    that adds them in order."""
    refuse_lazy(("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
                ("lse", lse))
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, dout, lse, causal, window, q_offset)[:3]


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
