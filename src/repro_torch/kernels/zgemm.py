"""CUDA wrappers: batched complex GEMM and the fused ensemble
commutator trace (sources ``csrc/zgemm.cu`` and ``csrc/ect.cu``).

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
    if x.device.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel given a tensor on {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.is_conj() or x.is_neg():
        raise ValueError(f"{name}: kernel needs a contiguous tensor with "
                         "no lazy conjugate or negative view")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)}")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def zgemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, M, K) @ b (B, K, N) -> (B, M, N), complex128 on the card."""
    check_operand(a, "a", 3)
    check_operand(b, "b", 3)
    bsz, m, k = a.shape
    if b.shape[0] != bsz or b.shape[1] != k or b.device != a.device:
        raise ValueError(f"zgemm: {tuple(a.shape)} @ {tuple(b.shape)}")
    n = b.shape[2]
    lib = build.load()
    out = torch.empty((bsz, m, n), dtype=torch.complex128, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.qf_zgemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz,
                           m, n, k, stream_of(a))
    build.LAUNCHES["zgemm"] += 1
    build.check(err, "zgemm launch")
    return out


def ensemble_commutator_trace(a: torch.Tensor, b: torch.Tensor
                              ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) for keep-major ensembles
    a (J, N, Ea, dk, dr), b (J, N, Eb, dk, dr) -> (J, dk, dk), folding
    through b (the caller puts the smaller ensemble second)."""
    check_operand(a, "a", 5)
    check_operand(b, "b", 5)
    j, n, ea, dk, dr = a.shape
    if (b.shape[:2] != (j, n) or b.shape[3:] != (dk, dr)
            or b.device != a.device):
        raise ValueError(f"ensemble_commutator_trace: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    eb = b.shape[2]
    lib = build.load()
    out = torch.empty((j, dk, dk), dtype=torch.complex128, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.qf_ect(a.data_ptr(), b.data_ptr(), out.data_ptr(), j, n,
                         ea, eb, dk, dr, stream_of(a))
    build.LAUNCHES["ensemble_commutator_trace"] += 1
    build.check(err, "ensemble_commutator_trace launch")
    return out
