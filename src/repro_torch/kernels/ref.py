"""Plain PyTorch versions of the port's four CUDA kernels.

Each computes the same function as its kernel with the kernel's
precision contract: complex128 in, fp32 arithmetic, complex128 (or
float64) out. The ``ops`` wrappers take these for tensors on the CPU,
and ``chip_smoke.py`` holds each kernel against its plain version on
the card, like for like. The JAX package's ``repro.kernels.ref`` is the
oracle they are tested against.
"""
from __future__ import annotations

import torch


def _parts32(x: torch.Tensor):
    return x.real.float(), x.imag.float()


def zgemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matmul (B, M, K) @ (B, K, N) on split fp32 parts."""
    ar, ai = _parts32(a)
    br, bi = _parts32(b)
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return torch.complex(cr, ci).to(torch.complex128)


def fidelity_ref(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Re<phi|rho|phi> per pair: phi (N, d), rho (N, d, d) -> (N,)."""
    pr, pi = _parts32(phi)
    rr, ri = _parts32(rho)
    yr = torch.einsum("nde,ne->nd", rr, pr) - torch.einsum("nde,ne->nd", ri, pi)
    yi = torch.einsum("nde,ne->nd", rr, pi) + torch.einsum("nde,ne->nd", ri, pr)
    return (torch.sum(pr * yr, -1) + torch.sum(pi * yi, -1)).double()


def mse_ref(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """||rho - |phi><phi|||_F^2 per pair: phi (N, d), rho (N, d, d)."""
    pr, pi = _parts32(phi)
    rr, ri = _parts32(rho)
    proj_r = pr[:, :, None] * pr[:, None, :] + pi[:, :, None] * pi[:, None, :]
    proj_i = pi[:, :, None] * pr[:, None, :] - pr[:, :, None] * pi[:, None, :]
    dr, di = rr - proj_r, ri - proj_i
    return torch.sum(dr * dr + di * di, dim=(-2, -1)).double()


def ensemble_commutator_trace_ref(a: torch.Tensor, b: torch.Tensor
                                  ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) on keep-major ensembles
    a: (J, N, Ea, dk, dr), b: (J, N, Eb, dk, dr) -> (J, dk, dk): the cross
    Gram, re-expanded against a and traced against b, in complex64."""
    a, b = a.to(torch.complex64), b.to(torch.complex64)
    g = torch.einsum("jnekr,jnfkr->jnef", a.conj(), b)
    w = torch.einsum("jnef,jnekr->jnfkr", g, a)
    t = torch.einsum("jnfar,jnfbr->jab", w, b.conj())
    return t.to(torch.complex128)
