"""Plain PyTorch versions of the port's CUDA kernels.

Each computes the same function as its kernel with the kernel's
precision contract. The quantum kernels: complex128 in, fp32
arithmetic, complex128 (or float64) out. The sequence kernels
(attention, the RG-LRU scan): fp32 or bf16 in, fp32 arithmetic, out in
the input's dtype. The ``ops`` wrappers take these for tensors on the
CPU, and ``chip_smoke.py`` holds each kernel against its plain version
on the card, like for like. The JAX package's ``repro.kernels.ref`` is
the oracle they are tested against.
"""
from __future__ import annotations

import math

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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, dh); k/v (BK, Sk, dh) with BH = BK * G: query row i
    reads kv row i // G (G = 1 is the reference's same-head layout).
    Query position i and key position j (both from 0) pair when
    j <= i (causal) and j > i - window (window > 0). fp32 softmax; out
    in q's dtype.

    A query row with no allowed key gives 0, as the TPU kernel and the
    CUDA kernel do (the JAX oracle's -1e30 fill gives the mean of v
    there instead; no model path has such a row).
    """
    g = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = (q.float() @ kf.transpose(1, 2)) / math.sqrt(float(q.shape[-1]))
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s.masked_fill_(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = s.sub_(m).exp_()                   # in place: s is (BH, Sq, Sk)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return ((p @ vf) / denom).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential diagonal recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0,
    over axis 1 of (B, S, D); fp32 carry, out in a's dtype."""
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((a.shape[0],) + a.shape[2:], dtype=torch.float32,
                    device=a.device)
    a32, b32 = a.float(), b.float()
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)
