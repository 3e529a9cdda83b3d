"""Parity of the PyTorch port's linalg with the JAX reference (x64).

The same numpy inputs go through ``repro.core.quantum.linalg`` and
``repro_torch.core.quantum.linalg``; outputs agree to <= 1e-10. QR and
eigh factors are unique only up to phases, so ``ensemble_compress`` is
compared through the density it represents and ``eigh`` through the
exponentials it builds."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantum import linalg as jql  # noqa: E402
from repro_torch.core.quantum import linalg as tql  # noqa: E402

TOL = 1e-10


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def rand_unitary(rng, d, batch=()):
    q, r = np.linalg.qr(rand_c(rng, *batch, d, d))
    return q


def rand_herm(rng, d, batch=()):
    a = rand_c(rng, *batch, d, d)
    return (a + np.conj(np.swapaxes(a, -1, -2))) / 2


def t(x):
    return torch.as_tensor(np.asarray(x))


def err(port, ref):
    return float(np.max(np.abs(port.resolve_conj().numpy() - np.asarray(ref))))


def test_small_helpers(x64):
    rng = np.random.default_rng(0)
    a = rand_c(rng, 2, 4, 4)
    assert tql.dim(5) == jql.dim(5) == 32
    assert err(tql.dagger(t(a)), jql.dagger(jnp.asarray(a))) == 0.0
    assert err(tql.zero_state(3, device="cpu"), jql.zero_state(3)) == 0.0
    psi = rand_c(rng, 3, 8)
    assert err(tql.pure_density(t(psi)), jql.pure_density(psi)) <= TOL


@pytest.mark.parametrize("n,acting", [(3, [0, 2]), (4, [3, 1]), (5, [0, 1, 4]),
                                      (2, [1])])
def test_apply_unitary_vec(x64, n, acting):
    rng = np.random.default_rng(n)
    u = rand_unitary(rng, 2 ** len(acting))
    psi = rand_c(rng, 2, 3, 2 ** n)
    got = tql.apply_unitary_vec(t(psi), t(u), acting, n)
    want = jql.apply_unitary_vec(jnp.asarray(psi), jnp.asarray(u), acting, n)
    assert err(got, want) <= TOL


def test_apply_unitary_vec_node_batched(x64):
    """A (P, dk, dk) stack applies node p's unitary to node p's states
    only: the port's explicit node axis in place of vmap."""
    rng = np.random.default_rng(7)
    n, acting = 4, [0, 1, 3]
    u = rand_unitary(rng, 8, batch=(3,))
    psi = rand_c(rng, 3, 5, 2, 2 ** n)
    got = tql.apply_unitary_vec(t(psi), t(u), acting, n)
    for p in range(3):
        want = jql.apply_unitary_vec(jnp.asarray(psi[p]), jnp.asarray(u[p]),
                                     acting, n)
        assert err(got[p], want) <= TOL


@pytest.mark.parametrize("n,keep", [(3, [1, 2]), (4, [2, 0]), (5, [4, 1, 2]),
                                    (3, [0, 1, 2])])
def test_partial_trace(x64, n, keep):
    rng = np.random.default_rng(n + len(keep))
    v = rand_c(rng, 2, 3, 2 ** n)
    rho = np.einsum("bed,bec->bdc", v, np.conj(v))
    got = tql.partial_trace(t(rho), keep, n)
    want = jql.partial_trace(jnp.asarray(rho), keep, n)
    assert err(got, want) <= TOL


@pytest.mark.parametrize("e,d", [(12, 4), (8, 8), (3, 8), (40, 16)])
def test_ensemble_compress_density(x64, e, d):
    rng = np.random.default_rng(e * d)
    v = rand_c(rng, 2, e, d)
    got = tql.ensemble_compress(t(v))
    want = jql.ensemble_compress(jnp.asarray(v))
    assert tuple(got.shape) == tuple(want.shape) == (2, min(e, d), d)
    dens = lambda x: np.einsum("...ed,...ec->...dc", x, np.conj(x))  # noqa: E731
    assert np.max(np.abs(dens(got.numpy()) - dens(np.asarray(want)))) <= TOL
    assert np.max(np.abs(dens(got.numpy()) - dens(v))) <= TOL


@pytest.mark.parametrize("n,keep", [(5, [0, 1, 3]), (4, [3, 0]), (3, [0, 1, 2])])
def test_ensemble_keep_major(x64, n, keep):
    rng = np.random.default_rng(11)
    v = rand_c(rng, 2, 3, 2 ** n)
    got = tql.ensemble_keep_major(t(v), keep, n)
    want = jql.ensemble_keep_major(jnp.asarray(v), keep, n)
    assert got.shape == want.shape
    assert err(got, want) == 0.0


@pytest.mark.parametrize("d", [4, 8, 16])
def test_eigh_expm(x64, d):
    rng = np.random.default_rng(d)
    k = rand_herm(rng, d, batch=(3,))
    for scale in (0.1, -0.37):
        got = tql.expm_herm(t(k), scale)
        want = jql.expm_herm(jnp.asarray(k), scale)
        assert err(got, want) <= TOL
    lam, v = tql.eigh_herm(t(k))
    jlam, jv = jql.eigh_herm(jnp.asarray(k))
    assert err(lam, jlam) <= TOL
    # factors differ by phase: compare what they build
    assert err(tql.expm_eigh(lam, v, 0.2), jql.expm_eigh(jlam, jv, 0.2)) <= TOL
    rebuilt = (v * lam.to(v.dtype)[..., None, :]) @ tql.dagger(v)
    assert err(rebuilt, k) <= TOL


def test_fidelity_and_mse(x64):
    rng = np.random.default_rng(3)
    phi = rand_c(rng, 4, 6, 8)
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    v = rand_c(rng, 4, 6, 3, 8)
    rho = np.einsum("...ed,...ec->...dc", v, np.conj(v))
    assert err(tql.fidelity_pure(t(phi), t(rho)),
               jql.fidelity_pure(jnp.asarray(phi), jnp.asarray(rho))) <= TOL
    assert err(tql.mse_state(t(phi), t(rho)),
               jql.mse_state(jnp.asarray(phi), jnp.asarray(rho))) <= TOL


def test_haar_sampling_is_seeded_and_valid():
    """The port's RNG is its own: check the distribution's invariants
    and that a seed reproduces the draw."""
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    u1 = tql.haar_unitary(g(), 8, batch=(3,), device="cpu")
    u2 = tql.haar_unitary(g(), 8, batch=(3,), device="cpu")
    assert torch.equal(u1, u2) and u1.dtype == torch.complex128
    eye = torch.eye(8, dtype=u1.dtype)
    assert float((u1 @ tql.dagger(u1) - eye).abs().max()) <= 1e-12
    psi = tql.haar_state(g(), 3, batch=(4, 2), device="cpu")
    assert psi.shape == (4, 2, 8)
    norms = torch.linalg.vector_norm(psi, dim=-1)
    assert float((norms - 1).abs().max()) <= 1e-12


@pytest.mark.parametrize("d,batch", [(4, ()), (8, (3,)), (16, (2, 5))])
def test_haar_unitary_is_row_major(d, batch):
    """Haar unitaries (the initial params) come out in the dense row-major
    layout the kernels read, with the phase-fixed QR factor's values."""
    u = tql.haar_unitary(torch.Generator().manual_seed(d), d, batch=batch,
                         device="cpu")
    assert u.shape == batch + (d, d) and u.is_contiguous()
    g = torch.Generator().manual_seed(d)
    re = torch.randn(batch + (d, d), generator=g, dtype=torch.float64)
    im = torch.randn(batch + (d, d), generator=g, dtype=torch.float64)
    q, r = torch.linalg.qr(torch.complex(re, im) / 2.0 ** 0.5)
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    assert torch.equal(u, q * (diag / diag.abs())[..., None, :])
