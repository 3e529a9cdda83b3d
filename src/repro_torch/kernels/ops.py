"""Device dispatch for the port's kernels (the ``impl="pallas"``
backend of the quantum path).

A tensor on the card launches the hand-written CUDA kernel, or the
kernel's wrapper raises; a tensor on the CPU takes the kernel's plain
version in ``ref``. There is no other route and no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fidelity as _fid
from repro_torch.kernels import ref
from repro_torch.kernels import zgemm as _zgemm


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _dense(x: torch.Tensor) -> torch.Tensor:
    """The kernels read raw storage: materialise lazy conjugate/negative
    views (``x.conj()`` only sets a bit) and make the layout contiguous."""
    return x.resolve_conj().resolve_neg().contiguous()


def complex_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matmul (B, M, K) @ (B, K, N) -> complex128."""
    if _on_cpu(a):
        return ref.zgemm_ref(a, b)
    return _zgemm.zgemm(_dense(a), _dense(b))


def fidelity(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Re<phi|rho|phi> per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.fidelity_ref(phi, rho)
    return _fid.fidelity_batch(_dense(phi), _dense(rho))


def mse(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """||rho - |phi><phi|||_F^2 per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.mse_ref(phi, rho)
    return _fid.mse_batch(_dense(phi), _dense(rho))


def ensemble_commutator_trace(a: torch.Tensor, b: torch.Tensor
                              ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) for keep-major ensembles
    a (J, N, Ea, dk, dr), b (J, N, Eb, dk, dr) -> (J, dk, dk) complex128."""
    if _on_cpu(a):
        return ref.ensemble_commutator_trace_ref(a, b)
    return _zgemm.ensemble_commutator_trace(_dense(a), _dense(b))
