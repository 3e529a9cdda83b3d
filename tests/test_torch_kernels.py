"""The port's four kernels, through their plain PyTorch versions (CPU).

Each plain version (``repro_torch.kernels.ref``, fp32 arithmetic like
the CUDA kernel it stands beside) is held against the JAX reference's
oracle (``repro.kernels.ref``) and against the Pallas TPU kernel run in
interpret mode, to the kernels' fp32 budget (1e-5 relative to the
operands' scale). Ragged shapes are included: the CUDA kernels mask
edges instead of padding. The ``ops`` wrappers send CPU tensors to the
plain versions; ``tests/test_torch_cuda.py`` covers the launches on a
card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fidelity import fidelity_batch, mse_batch  # noqa: E402
from repro.kernels.zgemm import ensemble_commutator_trace as ject  # noqa: E402
from repro.kernels.zgemm import zgemm as jzgemm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

TOL = 1e-5


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def rel_err(port, want):
    want = np.asarray(want)
    return float(np.max(np.abs(port.numpy() - want)) / np.max(np.abs(want)))


def split(x):
    return jnp.real(jnp.asarray(x)), jnp.imag(jnp.asarray(x))


@pytest.mark.parametrize("b,m,k,n", [(3, 7, 9, 5), (4, 8, 8, 8),
                                     (2, 16, 16, 16), (1, 33, 17, 20)])
def test_zgemm_plain(x64, b, m, k, n):
    rng = np.random.default_rng(m * k + n)
    a, bm = rand_c(rng, b, m, k), rand_c(rng, b, k, n)
    got = ref.zgemm_ref(torch.as_tensor(a), torch.as_tensor(bm))
    assert got.dtype == torch.complex128 and got.shape == (b, m, n)
    cr, ci = jref.zgemm_ref(*split(a), *split(bm))
    assert rel_err(got, cr + 1j * ci) <= TOL
    pr, pi = jzgemm(*split(a), *split(bm), block_m=8, block_n=8, block_k=8,
                    interpret=True)
    assert rel_err(got, pr + 1j * pi) <= TOL
    assert rel_err(got, a @ bm) <= TOL


def _states(rng, n, d):
    phi = rand_c(rng, n, d)
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    v = rand_c(rng, n, 3, d)
    rho = np.einsum("ned,nec->ndc", v, np.conj(v))
    return phi, rho / np.trace(rho, axis1=-2, axis2=-1)[:, None, None]


@pytest.mark.parametrize("n,d", [(13, 4), (32, 4), (8, 16), (5, 3)])
def test_fidelity_and_mse_plain(x64, n, d):
    rng = np.random.default_rng(n * d)
    phi, rho = _states(rng, n, d)
    tp, tr = torch.as_tensor(phi), torch.as_tensor(rho)
    for plain, oracle, pallas in ((ref.fidelity_ref, jref.fidelity_ref,
                                   fidelity_batch),
                                  (ref.mse_ref, jref.mse_ref, mse_batch)):
        got = plain(tp, tr)
        assert got.dtype == torch.float64 and got.shape == (n,)
        assert rel_err(got, oracle(jnp.asarray(phi), jnp.asarray(rho))) <= TOL
        want = pallas(jnp.asarray(phi), jnp.asarray(rho), block=4,
                      interpret=True)
        assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("j,n,ea,eb,dk,dr", [
    (3, 2, 32, 1, 8, 4),     # widths (2,3,2) layer 1, after the swap
    (2, 2, 8, 4, 16, 2),     # widths (2,3,2) layer 2, after the swap
    (2, 3, 5, 3, 4, 3),      # ragged
    (1, 2, 2, 6, 8, 4),      # Ea < Eb: the orientation the caller swaps
])
def test_ensemble_commutator_trace_plain(x64, j, n, ea, eb, dk, dr):
    rng = np.random.default_rng(ea * 10 + eb)
    a = rand_c(rng, j, n, ea, dk, dr)
    b = rand_c(rng, j, n, eb, dk, dr)
    got = ref.ensemble_commutator_trace_ref(torch.as_tensor(a),
                                            torch.as_tensor(b))
    assert got.shape == (j, dk, dk) and got.dtype == torch.complex128
    want = jref.ensemble_commutator_trace_ref(jnp.asarray(a), jnp.asarray(b))
    assert rel_err(got, want) <= TOL
    k = dk * dr
    tr, ti = ject(*split(a.reshape(j, n, ea, k)),
                  *split(b.reshape(j, n, eb, k)), d_keep=dk, interpret=True)
    assert rel_err(got, tr + 1j * ti) <= TOL


def ect_emulated(a, b, te, fc, split):
    """The CUDA trace kernel's order of arithmetic (``csrc/ect.cu``), in
    fp32 torch. Under the plan (te, fc, split) one block takes one (j, n),
    one range of a's rows (ranges of whole tiles of te rows, ``split`` of
    them at most, the grid arithmetic of ect.cu) and one chunk of fc of
    b's rows; it stages a tile at a time, forms the tile's Gram
    G = conj(a_tile) b^T and adds G^T a_tile into its W, then folds W
    against b into its partial trace. The partials of each j are summed
    in order (n, range, chunk); the one-launch plan of small shapes (one
    range, one chunk, a block over all n) sums in that order too."""
    j, n, ea, dk, dr = a.shape
    eb = b.shape[2]
    a32 = a.to(torch.complex64).reshape(j, n, ea, dk * dr)
    b32 = b.to(torch.complex64).reshape(j, n, eb, dk * dr)
    tiles = -(-ea // te)
    per = -(-tiles // split)
    rows = per * te
    out = torch.empty((j, dk, dk), dtype=torch.complex128)
    for jj in range(j):
        total = torch.zeros((dk, dk), dtype=torch.complex64)
        for nn in range(n):
            for e_begin in range(0, ea, rows):
                e_end = min(ea, e_begin + rows)
                for f0 in range(0, eb, fc):
                    bs = b32[jj, nn, f0:f0 + fc]
                    w = torch.zeros_like(bs)
                    for e0 in range(e_begin, e_end, te):
                        tile = a32[jj, nn, e0:min(e0 + te, e_end)]
                        w += (tile.conj() @ bs.T).T @ tile
                    total += torch.einsum(
                        "far,fbr->ab", w.reshape(-1, dk, dr),
                        bs.reshape(-1, dk, dr).conj())
        out[jj] = total
    return out


@pytest.mark.parametrize("j,n,ea,eb,dk,dr", [
    (3, 2, 32, 1, 8, 4),
    (2, 2, 8, 4, 16, 2),
    (2, 3, 5, 3, 4, 3),
    (1, 2, 2, 6, 8, 4),
    (2, 4, 32, 16, 64, 8),   # widths (4,5,4) layer 1, J cut from 40
    (2, 4, 512, 1, 32, 16),  # widths (4,5,4) layer 2, J cut from 50
])
def test_ensemble_commutator_trace_emulation(x64, j, n, ea, eb, dk, dr):
    """Every plan of the CUDA trace kernel computes the same function:
    one block per (j, n) with a single tile, the finest split (tiles of
    one row, b one row a chunk, as many ranges as tiles), and one between
    (ragged tiles and chunks), each against the JAX oracle and the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(ea * 7 + eb * 3 + dk)
    a = rand_c(rng, j, n, ea, dk, dr)
    b = rand_c(rng, j, n, eb, dk, dr)
    want = jref.ensemble_commutator_trace_ref(jnp.asarray(a), jnp.asarray(b))
    k = dk * dr
    tr, ti = ject(*split(a.reshape(j, n, ea, k)),
                  *split(b.reshape(j, n, eb, k)), d_keep=dk, interpret=True)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for te, fc, nsplit in ((ea, eb, 1), (1, 1, ea),
                           (max(1, ea // 3), max(1, (eb + 1) // 2), 2)):
        got = ect_emulated(ta, tb, te, fc, nsplit)
        assert got.shape == (j, dk, dk) and got.dtype == torch.complex128
        assert rel_err(got, want) <= TOL, (te, fc, nsplit)
        assert rel_err(got, tr + 1j * ti) <= TOL, (te, fc, nsplit)


def test_ops_on_cpu_take_the_plain_versions(x64):
    rng = np.random.default_rng(1)
    a, b = torch.as_tensor(rand_c(rng, 2, 5, 3)), torch.as_tensor(
        rand_c(rng, 2, 3, 4))
    phi, rho = (torch.as_tensor(x) for x in _states(rng, 6, 4))
    ea = torch.as_tensor(rand_c(rng, 2, 2, 4, 4, 2))
    eb = torch.as_tensor(rand_c(rng, 2, 2, 3, 4, 2))
    before = dict(build.LAUNCHES)
    assert torch.equal(ops.complex_matmul(a, b), ref.zgemm_ref(a, b))
    assert torch.equal(ops.fidelity(phi, rho), ref.fidelity_ref(phi, rho))
    assert torch.equal(ops.mse(phi, rho), ref.mse_ref(phi, rho))
    assert torch.equal(ops.ensemble_commutator_trace(ea, eb),
                       ref.ensemble_commutator_trace_ref(ea, eb))
    assert dict(build.LAUNCHES) == before  # no kernel ran


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import fidelity as kfid
    from repro_torch.kernels import zgemm as kz
    x = torch.zeros((1, 2, 2), dtype=torch.complex128)
    with pytest.raises(ValueError):
        kz.zgemm(x, x)
    with pytest.raises(ValueError):
        kfid.fidelity_batch(x[0], x)



def test_dense_materialises_lazy_views():
    """The kernels read raw storage, so ``ops`` resolves the conjugate
    and negative bits of lazy views before any launch; a tensor that is
    already dense is handed on as it is, with no copy."""
    x = torch.complex(torch.randn(2, 3, 4, dtype=torch.float64),
                      torch.randn(2, 3, 4, dtype=torch.float64))
    for view in (x.conj(), x.transpose(-1, -2).conj(), x.conj().imag,
                 torch._neg_view(x), torch._neg_view(x.real),
                 x.transpose(-1, -2)):
        dense = ops._dense(view)
        assert not dense.is_conj() and not dense.is_neg()
        assert dense.is_contiguous() and torch.equal(dense, view)
        assert dense.data_ptr() != x.data_ptr()
    for dense in (x, x.real.contiguous(), x[0]):
        assert ops._dense(dense) is dense
