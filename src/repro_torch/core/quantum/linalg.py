"""Density-matrix linear algebra for the QuantumFed simulator (PyTorch).

The port of ``repro.core.quantum.linalg``. States are pure vectors
(2**n,) or density matrices (2**n, 2**n), complex128 by default (the
reference runs under x64). Qubit 0 is the MOST significant axis of the
(2,)*n tensor form of a state.

Operators may carry leading batch axes that prefix the batch axes of the
states they act on: a node axis in the port stands where the reference
had ``vmap``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import resolve_device

DTYPE = torch.complex128


def dim(n_qubits: int) -> int:
    return 2 ** n_qubits


def dagger(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose on the last two axes."""
    return a.transpose(-1, -2).conj()


def zero_state(n_qubits: int, dtype=DTYPE, device="cuda") -> torch.Tensor:
    """|0...0> on n qubits (pure state vector)."""
    v = torch.zeros((dim(n_qubits),), dtype=dtype,
                    device=resolve_device(device))
    v[0] = 1.0
    return v


def pure_density(psi: torch.Tensor) -> torch.Tensor:
    """|psi><psi| from a state vector (batched over leading axes)."""
    return psi[..., :, None] * psi[..., None, :].conj()


def apply_unitary_vec(psi: torch.Tensor, u: torch.Tensor,
                      acting_on: Sequence[int], n_qubits: int
                      ) -> torch.Tensor:
    """U |psi> where u acts only on the qubit subset ``acting_on``.

    psi: (*B, *X, 2**n); u: (*B, 2**k, 2**k) with k == len(acting_on),
    where u's batch axes *B (possibly none) prefix psi's and each batch
    entry applies its own u. The acting qubits are moved last and
    contracted as one batched matmul.
    """
    k = len(acting_on)
    dk = dim(k)
    if u.shape[-1] != dk:
        raise ValueError(f"u {tuple(u.shape)} does not act on {acting_on}")
    nbu = u.dim() - 2
    batch = psi.shape[:-1]
    nb = len(batch)
    t = psi.reshape(batch + (2,) * n_qubits)
    axes = [nb + q for q in acting_on]
    ends = list(range(nb + n_qubits - k, nb + n_qubits))
    t = t.movedim(axes, ends)
    moved = t.shape
    t = t.reshape(batch[:nbu] + (-1, dk))
    t = t @ u.transpose(-1, -2)
    t = t.reshape(moved).movedim(ends, axes)
    return t.reshape(psi.shape)


def partial_trace(rho: torch.Tensor, keep: Sequence[int], n_qubits: int
                  ) -> torch.Tensor:
    """Trace out all qubits except ``keep`` (in the given order);
    leading batch axes are kept."""
    keep = list(keep)
    traced = [q for q in range(n_qubits) if q not in keep]
    batch = rho.shape[:-2]
    nb = len(batch)
    t = rho.reshape(batch + (2,) * (2 * n_qubits))
    for q in sorted(traced, reverse=True):
        half = (t.dim() - nb) // 2
        t = torch.diagonal(t, dim1=nb + q, dim2=nb + q + half).sum(-1)
    d = dim(len(keep))
    out = t.reshape(batch + (d, d))
    if keep != sorted(keep):
        srt = sorted(keep)
        perm = [srt.index(q) for q in keep]
        k = len(keep)
        tt = out.reshape(batch + (2,) * (2 * k))
        tt = tt.permute(list(range(nb)) + [nb + p for p in perm]
                        + [nb + k + p for p in perm])
        out = tt.reshape(batch + (d, d))
    return out


def ensemble_compress(v: torch.Tensor) -> torch.Tensor:
    """An equivalent ensemble for rho = sum_e v_e v_e^H with at most
    min(E, d) vectors: the R factor of V = QR (exact to machine eps; the
    rows of R are an ensemble for the same density). v: (..., E, d)."""
    return torch.linalg.qr(v, mode="r")[1]


def ensemble_keep_major(v: torch.Tensor, keep: Sequence[int],
                        n_qubits: int) -> torch.Tensor:
    """Reshape ensemble vectors (..., 2**n) to (..., d_keep, d_rest) with
    the ``keep`` qubits (in order) as the row-major leading factor."""
    keep = list(keep)
    rest = [q for q in range(n_qubits) if q not in keep]
    batch = v.shape[:-1]
    nb = len(batch)
    t = v.reshape(batch + (2,) * n_qubits)
    t = t.permute(list(range(nb)) + [nb + q for q in keep]
                  + [nb + q for q in rest])
    return t.reshape(batch + (dim(len(keep)), dim(len(rest))))


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """float64 standard normals drawn on the generator's device."""
    x = torch.randn(shape, generator=gen, dtype=torch.float64,
                    device=gen.device)
    return x.to(device)


def haar_state(gen: torch.Generator, n_qubits: int, batch: tuple = (),
               dtype=DTYPE, device="cuda") -> torch.Tensor:
    """Haar-random pure state vector(s) of shape batch + (2**n,)."""
    dev = resolve_device(device)
    shape = tuple(batch) + (dim(n_qubits),)
    re = _normal(gen, shape, dev)
    im = _normal(gen, shape, dev)
    psi = torch.complex(re, im).to(dtype)
    return psi / torch.linalg.vector_norm(psi, dim=-1, keepdim=True)


def haar_unitary(gen: torch.Generator, d: int, batch: tuple = (),
                 dtype=DTYPE, device="cuda") -> torch.Tensor:
    """Haar-random unitary via QR of a Ginibre matrix, phase-fixed, in
    the row-major layout the kernels read (QR's Q is column-major, which
    the first Eq. 6 product of each layer would otherwise copy)."""
    dev = resolve_device(device)
    shape = tuple(batch) + (d, d)
    re = _normal(gen, shape, dev)
    im = _normal(gen, shape, dev)
    z = torch.complex(re, im).to(dtype) / (2.0 ** 0.5)
    q, r = torch.linalg.qr(z)
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    return (q * (diag / diag.abs())[..., None, :]).contiguous()


def eigh_herm(k: torch.Tensor):
    """Eigendecomposition (lam, v) of Hermitian K: the factorisation one
    round reuses for every exponential of the same K."""
    return torch.linalg.eigh(k)


def expm_eigh(lam: torch.Tensor, v: torch.Tensor, scale) -> torch.Tensor:
    """e^{i * scale * K} from a cached (lam, v) = eigh(K)."""
    phase = torch.exp(1j * scale * lam.to(v.dtype))
    return (v * phase[..., None, :]) @ dagger(v)


def expm_herm(k: torch.Tensor, scale) -> torch.Tensor:
    """e^{i * scale * K} for Hermitian K via eigendecomposition."""
    lam, v = eigh_herm(k)
    return expm_eigh(lam, v, scale)


def fidelity_pure(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """<phi| rho |phi> for pure label phi (batched over leading axes)."""
    return torch.einsum("...a,...ab,...b->...", phi.conj(), rho, phi).real


def mse_state(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """|| rho - |phi><phi| ||_F^2 (Eq. 10)."""
    diff = rho - pure_density(phi)
    return torch.sum(diff.abs() ** 2, dim=(-2, -1))
