"""CUDA wrappers: batched complex GEMM and the fused ensemble
commutator trace (sources ``csrc/zgemm.cu`` and ``csrc/ect.cu``), and the
launch path that all the port's wrappers share (``check_operand``,
``launch``).

Both take complex128 tensors on the card, hand their interleaved storage
to the kernels (fp32 arithmetic inside) and return complex128. They
launch on PyTorch's current stream, do not synchronise, and raise on a
tensor that is not on the card, on the wrong dtype, shape or layout,
and on a launch CUDA refuses. ``ops`` is the device dispatch that
sends CPU tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def check_operand(x: torch.Tensor, name: str, ndim: int,
                  dtype=torch.complex128) -> None:
    """Raise unless ``x`` is a non-empty, contiguous ``dtype`` tensor of
    ``ndim`` dims on the card with no lazy conjugate or negative bit (the
    kernels read raw storage). Each property is queried once on the way
    through; a refusal then says which one failed."""
    if (x.is_cuda and x.dtype == dtype and x.dim() == ndim
            and x.is_contiguous() and not x.is_conj() and not x.is_neg()
            and x.numel()):
        return
    if not x.is_cuda:
        raise ValueError(f"{name}: CUDA kernel given a tensor on {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)}")
    raise ValueError(f"{name}: kernel needs a contiguous tensor with no lazy "
                     "conjugate or negative view")


def launch(kernel: str, entry: str, dev: int, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and PyTorch's current
    stream on card ``dev`` (made the current device only if it is not),
    count one launch of ``kernel`` and raise on a CUDA error."""
    fn = getattr(build.load(), entry)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    build.LAUNCHES[kernel] += 1
    if err:
        build.check(err, kernel + " launch")


def zgemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, M, K) @ b (B, K, N) -> (B, M, N), complex128 on the card."""
    check_operand(a, "a", 3)
    check_operand(b, "b", 3)
    bsz, m, k = a.shape
    bb, kb, n = b.shape
    dev = a.get_device()
    if bb != bsz or kb != k or b.get_device() != dev:
        raise ValueError(f"zgemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    out = a.new_empty((bsz, m, n))
    launch("zgemm", "qf_zgemm", dev, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), bsz, m, n, k)
    return out


# (J, N, Ea, Eb, dk, dr, device) -> partial traces per j of the kernel's
# plan (``qf_ect_parts``; 0: one launch writes T, no workspace)
_TRACE_PARTS: dict = {}


def ensemble_commutator_trace(a: torch.Tensor, b: torch.Tensor
                              ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) for keep-major ensembles
    a (J, N, Ea, dk, dr), b (J, N, Eb, dk, dr) -> (J, dk, dk), folding
    through b (the caller puts the smaller ensemble second). Under the
    kernel's plan each block writes one partial trace into a complex64
    workspace and a second kernel sums them in order, or, for small
    shapes, one launch sums over n itself. The plan's workspace size is
    asked once per shape and device."""
    check_operand(a, "a", 5)
    check_operand(b, "b", 5)
    j, n, ea, dk, dr = a.shape
    dev = a.get_device()
    if (b.shape[:2] != (j, n) or b.shape[3:] != (dk, dr)
            or b.get_device() != dev):
        raise ValueError(f"ensemble_commutator_trace: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    eb = b.shape[2]
    key = (j, n, ea, eb, dk, dr, dev)
    parts = _TRACE_PARTS.get(key)
    if parts is None:
        parts = build.load().qf_ect_parts(j, n, ea, eb, dk, dr, dev)
        if parts < 0:
            build.check(-parts, "ensemble_commutator_trace plan")
        _TRACE_PARTS[key] = parts
    # held until the launch is queued: the allocator may then reuse it
    work = (a.new_empty((j, parts, dk, dk), dtype=torch.complex64)
            if parts else None)
    out = a.new_empty((j, dk, dk))
    launch("ensemble_commutator_trace", "qf_ect", dev, a.data_ptr(),
           b.data_ptr(), None if work is None else work.data_ptr(),
           out.data_ptr(), j, n, ea, eb, dk, dr, parts, dev)
    return out
