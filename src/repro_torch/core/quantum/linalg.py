"""Density-matrix linear algebra for the QuantumFed simulator (PyTorch).

The port of ``repro.core.quantum.linalg``. States are pure vectors
(2**n,) or density matrices (2**n, 2**n), complex128 by default (the
reference runs under x64). Qubit 0 is the MOST significant axis of the
(2,)*n tensor form of a state.

Operators may carry leading batch axes that prefix the batch axes of the
states they act on: a node axis in the port stands where the reference
had ``vmap``.

``apply_unitary_local`` contracts a k-qubit operator on its acting axes
of a density matrix without embedding it; ``embed_unitary`` +
``apply_unitary`` are the dense form the oracle (``dense_ref``) uses.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.device import resolve_device

DTYPE = torch.complex128


def dim(n_qubits: int) -> int:
    return 2 ** n_qubits


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype under a complex (or real) dtype: float64 for
    complex128, float32 for complex64."""
    return dtype.to_real()


def dagger(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose on the last two axes."""
    return a.transpose(-1, -2).conj()


def kron(*ops: torch.Tensor) -> torch.Tensor:
    """Kronecker product of a sequence of square operators."""
    out = ops[0]
    for op in ops[1:]:
        out = torch.kron(out, op)
    return out


def zero_state(n_qubits: int, dtype=DTYPE, device="cuda") -> torch.Tensor:
    """|0...0> on n qubits (pure state vector)."""
    v = torch.zeros((dim(n_qubits),), dtype=dtype,
                    device=resolve_device(device))
    v[0] = 1.0
    return v


def zero_projector(n_qubits: int, dtype=DTYPE, device="cuda") -> torch.Tensor:
    """|0...0><0...0| on n qubits."""
    v = zero_state(n_qubits, dtype, device)
    return torch.outer(v, v.conj())


def pure_density(psi: torch.Tensor) -> torch.Tensor:
    """|psi><psi| from a state vector (batched over leading axes)."""
    return psi[..., :, None] * psi[..., None, :].conj()


def embed_unitary(u: torch.Tensor, acting_on: Sequence[int], n_qubits: int
                  ) -> torch.Tensor:
    """Embed a unitary acting on the qubits ``acting_on`` (in the order of
    u's tensor factors) into the full n-qubit space, identity on the rest.
    u: (*B, 2**k, 2**k) -> (*B, 2**n, 2**n)."""
    k = len(acting_on)
    if u.shape[-1] != dim(k):
        raise ValueError(f"u {tuple(u.shape)} does not act on {acting_on}")
    batch = u.shape[:-2]
    nb = len(batch)
    rest = [q for q in range(n_qubits) if q not in acting_on]
    eye = torch.eye(dim(len(rest)), dtype=u.dtype, device=u.device)
    # u ⊗ I_rest, its row/column tensor axes in the order acting_on + rest
    full = torch.einsum("...ab,rs->...arbs", u, eye)
    order = list(acting_on) + rest
    perm = [order.index(q) for q in range(n_qubits)]
    t = full.reshape(batch + (2,) * (2 * n_qubits))
    t = t.permute(list(range(nb)) + [nb + p for p in perm]
                  + [nb + n_qubits + p for p in perm])
    return t.reshape(batch + (dim(n_qubits), dim(n_qubits)))


def _prefix(u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """u (*B, D, D) shaped to broadcast against rho (*B, *X, D, D)."""
    nx = rho.dim() - u.dim()
    return u.reshape(u.shape[:-2] + (1,) * nx + u.shape[-2:])


def apply_unitary(rho: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """U rho U^H; u (*B, D, D) with batch axes prefixing rho's."""
    u = _prefix(u, rho)
    return u @ rho @ dagger(u)


def apply_unitary_local(rho: torch.Tensor, u: torch.Tensor,
                        acting_on: Sequence[int], n_qubits: int
                        ) -> torch.Tensor:
    """U rho U^H where u acts only on the qubits ``acting_on``, never
    embedded: u on the row axes of rho's (2,)*2n form, conj(u) on its
    column axes. rho: (*B, *X, 2**n, 2**n); u: (*B, 2**k, 2**k), its
    batch axes prefixing rho's. Each side is one ``apply_unitary_vec``:
    the rows through rho's transpose, the columns directly."""
    rows = apply_unitary_vec(rho.transpose(-1, -2), u, acting_on,
                             n_qubits).transpose(-1, -2)       # U rho
    return apply_unitary_vec(rows, u.conj(), acting_on, n_qubits)


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


class ApproxCfg(NamedTuple):
    """Approximate-rank policy for ensemble compression.

    rank_tol: relative singular-value threshold; rows with
        s_i <= rank_tol * s_max are dropped (their trace-norm mass
        sum s_i^2 is charged to the certificate). 0.0 = exact.
    rank_cap: absolute per-compression rank cap (min(E, d, rank_cap)
        rows); None = rank-bound only.
    dtype: ensemble storage dtype between compressions: None (complex128),
        "f32" (complex64) or "bf16" (real and imaginary parts rounded
        through bfloat16 in a complex64 container). The certificate covers
        rank truncation only, not this rounding.
    """
    rank_tol: float = 0.0
    rank_cap: Optional[int] = None
    dtype: Optional[str] = None

    @property
    def exact(self) -> bool:
        return (self.rank_tol == 0.0 and self.rank_cap is None
                and self.dtype is None)


ENSEMBLE_DTYPES = (None, "f32", "bf16")


def resolve_approx(rank_tol: float = 0.0, rank_cap: Optional[int] = None,
                   ensemble_dtype: Optional[str] = None
                   ) -> Optional[ApproxCfg]:
    """Validate the knobs into an ``ApproxCfg``, or None when every knob
    is at its exact default: callers' ``approx is None`` path is then the
    exact code path, bit for bit."""
    if not 0.0 <= float(rank_tol) < 1.0:
        raise ValueError(f"rank_tol must be in [0, 1), got {rank_tol}")
    if rank_cap is not None and int(rank_cap) < 1:
        raise ValueError(f"rank_cap must be >= 1, got {rank_cap}")
    if ensemble_dtype not in ENSEMBLE_DTYPES:
        raise ValueError(f"unknown ensemble_dtype {ensemble_dtype!r}; "
                         f"use one of {ENSEMBLE_DTYPES}")
    cfg = ApproxCfg(float(rank_tol),
                    None if rank_cap is None else int(rank_cap),
                    ensemble_dtype)
    return None if cfg.exact else cfg


def ensemble_store(v: torch.Tensor, approx: Optional[ApproxCfg]
                   ) -> torch.Tensor:
    """Cast an ensemble to the policy's storage dtype: "f32" is
    complex64; "bf16" rounds the real and imaginary parts through
    bfloat16 into a complex64 container (torch has no complex bf16)."""
    if approx is None or approx.dtype is None:
        return v
    if approx.dtype == "f32":
        return v.to(torch.complex64)
    re = v.real.to(torch.bfloat16).float()
    im = v.imag.to(torch.bfloat16).float()
    return torch.complex(re, im)


def ensemble_compress(v: torch.Tensor, approx: Optional[ApproxCfg] = None,
                      with_err: bool = False):
    """An equivalent (or certified approximate) ensemble for
    rho = sum_e v_e v_e^H, v: (..., E, d).

    Exact (approx None): the R factor of V = QR, min(E, d) rows, exact to
    machine eps (the rows of R are an ensemble for the same density).

    Approximate: SVD V = U S Wh; the rows s_i Wh[i] are an exact ensemble.
    The top min(E, d, rank_cap) rows are kept and those with
    s_i <= rank_tol * s_max zeroed; what is dropped is a PSD term of rho
    whose trace norm is exactly the dropped sum s_i^2. with_err=True
    returns (compressed, err), err of batch shape (...,) in v's real
    dtype (zeros on the exact path)."""
    if approx is None:
        r = torch.linalg.qr(v, mode="r")[1]
        if not with_err:
            return r
        return r, torch.zeros(v.shape[:-2], dtype=real_dtype(v.dtype),
                              device=v.device)
    e, d = v.shape[-2], v.shape[-1]
    keep = min(e, d)
    if approx.rank_cap is not None:
        keep = min(keep, approx.rank_cap)
    _, s, wh = torch.linalg.svd(v, full_matrices=False)  # descending s
    r = s.shape[-1]
    mask = s > approx.rank_tol * s[..., :1]
    mask = mask & (torch.arange(r, device=v.device) < keep)
    err = torch.sum(torch.where(mask, torch.zeros_like(s), s * s), dim=-1)
    out = ((s[..., :keep] * mask[..., :keep]).to(v.dtype)[..., None]
           * wh[..., :keep, :])
    if not with_err:
        return out
    return out, err.to(real_dtype(v.dtype))


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


def ensemble_trace_product(v: torch.Tensor, w: torch.Tensor,
                           keep: Sequence[int], n_qubits: int,
                           batch_dims: int = 0) -> torch.Tensor:
    """Partially traced rank-1 sum T = tr_rest(sum_e |v_e><conj(w_e)|):

        T[a, b] = sum_e sum_r v_e[(a, r)] w_e[(b, r)]

    with row/column factors in ``keep`` order. v, w: (*K, ..., 2**n) with
    identical axes; the first ``batch_dims`` axes *K (a node axis) are
    kept, every other leading axis is summed. Returns (*K, dk, dk).
    With w_e = v_e^H B this is tr_rest((sum_e v_e v_e^H) B) without the
    2**n x 2**n product (the Prop.-1 commutator trick)."""
    vk = ensemble_keep_major(v, keep, n_qubits)
    wk = ensemble_keep_major(w, keep, n_qubits)
    kept = vk.shape[:batch_dims]
    vk = vk.reshape(kept + (-1,) + vk.shape[-2:])
    wk = wk.reshape(kept + (-1,) + wk.shape[-2:])
    return torch.einsum("...ear,...ebr->...ab", vk, wk)


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
    round reuses for every exponential of the same K.

    A matrix holding a NaN or inf gets all-NaN factors and the others
    their own, as ``jnp.linalg.eigh`` gives them (``torch.linalg.eigh``
    raises on such a batch instead): the batch is factored with the
    non-finite matrices zeroed, then their factors are set to NaN. No
    branch on finiteness, so no host sync. An entry is finite where
    x * 0 == 0 (inf * 0 and NaN * 0 are NaN): two elementwise passes,
    where ``torch.isfinite`` of a complex tensor takes nine."""
    finite = (k * 0 == 0).flatten(-2).all(-1)
    lam, v = torch.linalg.eigh(torch.where(finite[..., None, None], k, 0.0))
    nan = float("nan")
    return (torch.where(finite[..., None], lam, nan),
            torch.where(finite[..., None, None], v, complex(nan, nan)))


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


def is_unitary(u: torch.Tensor, atol: float = 1e-8) -> torch.Tensor:
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return torch.max(torch.abs(u @ dagger(u) - eye)) < atol


def is_hermitian(k: torch.Tensor, atol: float = 1e-8) -> torch.Tensor:
    return torch.max(torch.abs(k - dagger(k))) < atol


def trace_norm_check(rho: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Re tr(rho) over the last two axes (the trace a CPTP chain keeps)."""
    del n_qubits
    return torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
