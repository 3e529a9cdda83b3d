"""The port's quantum engine family against the JAX reference (x64): the
operator-space layer channels, the dense oracle (``dense_ref``), the
``local_opb`` baseline, ``backward_ensemble``, the certified
approximate-rank engine, ``pollute`` and a full round per engine.

The same numpy inputs go through both packages and agree to <= 1e-10
(complex128); paths through the kernels' plain fp32 versions agree to
<= 1e-5. QR and SVD factors are unique only up to phases, so ensembles
are compared through the densities they represent. Within the port the
reference's own engine gates hold (tests/test_engine_equivalence.py):
the three engines agree, rank_tol=0 is bit-exact, the certificate
dominates the deviation from the dense oracle, and the truncation error
grows with rank_tol."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import dense_ref as jdense  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro.core.quantum import linalg as jql  # noqa: E402
from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.quantum import data as qdata  # noqa: E402
from repro_torch.core.quantum import dense_ref  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402
from repro_torch.core.quantum import linalg as ql  # noqa: E402
from repro_torch.core.quantum import qnn  # noqa: E402

TOL = 1e-10
KERNEL_TOL = 1e-5
WIDTH_CASES = [(2, 3, 2), (1, 2, 1), (3, 2, 3), (2, 2, 2, 2), (2, 4, 2)]
APPROX_KNOBS = [dict(rank_cap=2), dict(rank_tol=0.2),
                dict(rank_tol=0.05, rank_cap=3)]

# the reference's Prop.-1 entry under jit: one compile per static set
ref_update_matrices = jax.jit(
    jqnn.update_matrices,
    static_argnames=("widths", "engine", "impl", "rank_tol", "rank_cap",
                     "ensemble_dtype", "with_bound"))
ref_dense = jax.jit(jdense.update_matrices, static_argnames=("widths",))
ref_layer = {f: jax.jit(f, static_argnames=("m_in", "m_out"))
             for f in (jqnn.layer_forward, jqnn.layer_adjoint)}
ref_chains = {f: jax.jit(f, static_argnames=("widths",))
              for f in (jqnn.feedforward, jqnn.backward,
                        jqnn.backward_ensemble)}
ref_local = jax.jit(jql.apply_unitary_local,
                    static_argnames=("acting_on", "n_qubits"))
ref_embed = jax.jit(jql.embed_unitary,
                    static_argnames=("acting_on", "n_qubits"))
ref_opb = jax.jit(jqnn._update_matrices_opb,
                  static_argnames=("widths", "impl"))


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def rand_states(rng, m, *batch):
    x = rand_c(rng, *batch, 2 ** m)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rand_unitaries(rng, *batch_d):
    return np.linalg.qr(rand_c(rng, *batch_d, batch_d[-1]))[0]


@functools.lru_cache(maxsize=None)
def problem(seed, widths, n=5):
    """Random unitaries and pure states from seeded numpy, as numpy."""
    rng = np.random.default_rng(seed)
    params = tuple(rand_unitaries(rng, m_out, 2 ** (m_in + 1))
                   for m_in, m_out in zip(widths[:-1], widths[1:]))
    return params, rand_states(rng, widths[0], n), rand_states(
        rng, widths[-1], n)


def jx(params, *states):
    return [jnp.asarray(p) for p in params], *map(jnp.asarray, states)


def tc(params, *states):
    return ([torch.as_tensor(p) for p in params],
            *(torch.as_tensor(s) for s in states))


def err(ours, theirs):
    return max(float(np.max(np.abs(x.resolve_conj().numpy()
                                   - np.asarray(y))))
               for x, y in zip(ours, theirs))


def weights_with_padding(seed, n):
    w = np.random.default_rng(seed).uniform(size=n)
    w[0] = 0.0                       # a padding slot drops out entirely
    return w


# ------------------------------------------------------------ linalg
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_embed_and_apply_unitary_local_at_every_acting_set(x64, widths):
    """Every perceptron's acting set of the width cases: embed_unitary
    matches the reference (qubit order), apply_unitary_local matches the
    reference and embed_unitary + apply_unitary, with a per-node u batch
    prefixing the operand's batch."""
    rng = np.random.default_rng(len(widths) + sum(widths))
    for m_in, m_out in zip(widths[:-1], widths[1:]):
        n = m_in + m_out
        for j in range(m_out):
            acting = list(range(m_in)) + [m_in + j]
            u = rand_unitaries(rng, 2, 2 ** (m_in + 1))     # two nodes
            rho = rand_c(rng, 2, 3, 2 ** n, 2 ** n)
            emb = ql.embed_unitary(torch.as_tensor(u), acting, n)
            assert err([emb[0], emb[1]],
                       [ref_embed(jnp.asarray(x), tuple(acting), n)
                        for x in u]) <= TOL
            got = ql.apply_unitary_local(torch.as_tensor(rho),
                                         torch.as_tensor(u), acting, n)
            want = [ref_local(jnp.asarray(rho[p]), jnp.asarray(u[p]),
                              tuple(acting), n) for p in range(2)]
            assert err([got[0], got[1]], want) <= TOL
            dense = ql.apply_unitary(torch.as_tensor(rho), emb)
            assert float((got - dense).abs().max()) <= TOL


@pytest.mark.parametrize("n,keep,batch", [(3, [0, 2], (4, 2)),
                                          (4, [3, 1], (5,)),
                                          (5, [0, 1, 4], (2, 3, 2))])
def test_ensemble_trace_product_and_small_helpers(x64, n, keep, batch):
    rng = np.random.default_rng(n)
    v, w = rand_c(rng, *batch, 2 ** n), rand_c(rng, *batch, 2 ** n)
    got = ql.ensemble_trace_product(torch.as_tensor(v), torch.as_tensor(w),
                                    keep, n)
    want = jql.ensemble_trace_product(jnp.asarray(v), jnp.asarray(w), keep, n)
    assert err([got], [want]) <= 1e-12
    # a kept leading axis is the reference per entry
    per = ql.ensemble_trace_product(torch.as_tensor(v), torch.as_tensor(w),
                                    keep, n, batch_dims=1)
    assert err(list(per), [jql.ensemble_trace_product(
        jnp.asarray(v[i]), jnp.asarray(w[i]), keep, n)
        for i in range(batch[0])]) <= 1e-12
    a, b = rand_c(rng, 2, 2), rand_c(rng, 4, 4)
    assert err([ql.kron(torch.as_tensor(a), torch.as_tensor(b))],
               [jql.kron(jnp.asarray(a), jnp.asarray(b))]) <= 1e-15
    assert err([ql.zero_projector(2, device="cpu")],
               [jql.zero_projector(2)]) == 0.0
    assert ql.real_dtype(torch.complex128) == torch.float64
    assert ql.real_dtype(torch.complex64) == torch.float32
    u = torch.as_tensor(rand_unitaries(rng, 8))
    assert bool(ql.is_unitary(u)) and not bool(ql.is_unitary(2 * u))
    h = torch.as_tensor(rand_c(rng, 4, 4))
    assert bool(ql.is_hermitian(h + ql.dagger(h)))
    assert not bool(ql.is_hermitian(h))
    rho = ql.pure_density(torch.as_tensor(rand_states(rng, 2, 3)))
    assert float((ql.trace_norm_check(rho, 2) - 1).abs().max()) <= TOL


# ------------------------------------------------------------ channels
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_layer_channels_and_chains_match_reference(x64, widths):
    """layer_forward / layer_adjoint (local and dense), feedforward,
    backward and backward_ensemble (through its densities) against the
    reference."""
    params, phi_in, phi_out = problem(0, widths)
    jp, ji, jo = jx(params, phi_in, phi_out)
    tp, ti, to = tc(params, phi_in, phi_out)
    layers = list(zip(widths[:-1], widths[1:]))
    rho = jql.pure_density(ji)
    for l, (m_in, m_out) in enumerate(layers):
        want = ref_layer[jqnn.layer_forward](jp[l], rho, m_in=m_in,
                                             m_out=m_out)
        t_rho = torch.as_tensor(np.array(rho))
        for ours in (qnn.layer_forward, dense_ref.layer_forward):
            assert err([ours(tp[l], t_rho, m_in, m_out)], [want]) <= TOL
        rho = want
    sig = jql.pure_density(jo)
    for l in range(len(layers) - 1, -1, -1):
        m_in, m_out = layers[l]
        want = ref_layer[jqnn.layer_adjoint](jp[l], sig, m_in=m_in,
                                             m_out=m_out)
        t_sig = torch.as_tensor(np.array(sig))
        for ours in (qnn.layer_adjoint, dense_ref.layer_adjoint):
            assert err([ours(tp[l], t_sig, m_in, m_out)], [want]) <= TOL
        sig = want
    rhos = ref_chains[jqnn.feedforward](jp, jql.pure_density(ji), widths)
    sigmas = ref_chains[jqnn.backward](jp, jql.pure_density(jo), widths)
    assert err(qnn.feedforward(tp, ql.pure_density(ti), widths), rhos) <= TOL
    assert err(dense_ref.feedforward(tp, ql.pure_density(ti), widths),
               rhos) <= TOL
    assert err(qnn.backward(tp, ql.pure_density(to), widths), sigmas) <= TOL
    assert err(dense_ref.backward(tp, ql.pure_density(to), widths),
               sigmas) <= TOL
    svs = qnn.backward_ensemble(tp, to, widths)
    want_svs = ref_chains[jqnn.backward_ensemble](jp, jo, widths)
    assert len(svs) == len(want_svs) == len(widths)
    for sv, wsv, sg in zip(svs, want_svs, sigmas):
        assert sv.shape == wsv.shape and sv.shape[-2] <= sv.shape[-1]
        assert err([qnn.density_from_ensemble(sv)], [sg]) <= TOL


# ------------------------------------------------------------ engines
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_dense_and_opb_match_reference(x64, widths, weighted):
    """dense_ref.update_matrices and _update_matrices_opb against the
    reference's, unweighted and weighted with a zero-weight padding slot
    (weights in float64: K stays complex128)."""
    params, phi_in, phi_out = problem(3, widths, n=6)
    jp, ji, jo = jx(params, phi_in, phi_out)
    tp, ti, to = tc(params, phi_in, phi_out)
    w = weights_with_padding(4, 6) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.as_tensor(w)
    dense = dense_ref.update_matrices(tp, ti, to, widths, 1.0, weights=tw)
    assert err(dense, ref_dense(jp, ji, jo, widths, 1.0, weights=jw)) <= TOL
    opb = qnn._update_matrices_opb(tp, ti, to, widths, 1.0, weights=tw)
    assert err(opb, ref_opb(jp, ji, jo, widths, 1.0, weights=jw)) <= TOL
    assert all(k.dtype == torch.complex128 for k in dense + opb)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_three_engines_agree(x64, widths, weighted):
    """local == local_opb == dense at <= 1e-10, as the reference's gate;
    local_opb through the kernels' plain versions at their fp32 budget."""
    params, phi_in, phi_out = problem(5, widths, n=6)
    tp, ti, to = tc(params, phi_in, phi_out)
    tw = torch.as_tensor(weights_with_padding(6, 6)) if weighted else None
    ks = {engine: qnn.update_matrices(tp, ti, to, widths, 1.0,
                                      engine=engine, weights=tw)
          for engine in qnn.ENGINES}
    want = [k.numpy() for k in ks["dense"]]
    assert err(ks["local"], want) <= TOL
    assert err(ks["local_opb"], want) <= TOL
    kernels = qnn.update_matrices(tp, ti, to, widths, 1.0,
                                  engine="local_opb", impl="pallas",
                                  weights=tw)
    assert err(kernels, want) <= KERNEL_TOL


@pytest.mark.parametrize("engine", ["local_opb", "dense"])
def test_new_engines_keep_nodes_apart(x64, engine):
    """P nodes with their own unitaries and data in one call give each
    node exactly its own K's (the Prop.-1 sums run per node)."""
    widths = (2, 3, 2)
    nodes = [problem(20 + p, widths, n=4) for p in range(3)]
    tp = [torch.stack([torch.as_tensor(nd[0][l]) for nd in nodes])
          for l in range(2)]
    ti = torch.stack([torch.as_tensor(nd[1]) for nd in nodes])
    to = torch.stack([torch.as_tensor(nd[2]) for nd in nodes])
    tw = torch.as_tensor(np.stack([weights_with_padding(p, 4)
                                   for p in range(3)]))
    got = qnn.update_matrices(tp, ti, to, widths, 0.7, engine=engine,
                              weights=tw)
    for p, nd in enumerate(nodes):
        want = ref_update_matrices(*jx(*nd), widths, 0.7, engine=engine,
                                   weights=jnp.asarray(tw[p].numpy()))
        assert err([k[p] for k in got], want) <= TOL


@pytest.mark.parametrize("engine", qnn.ENGINES)
def test_local_step_per_engine(x64, engine):
    widths = (2, 2, 2, 2)   # equal-width layers: the grouped paths
    params, phi_in, phi_out = problem(14, widths)
    p_want, ks_want = jqnn.local_step(*jx(params, phi_in, phi_out), widths,
                                      1.0, 0.07, engine=engine)
    p_got, ks_got = qnn.local_step(*tc(params, phi_in, phi_out), widths,
                                   1.0, 0.07, engine=engine)
    assert err(ks_got, ks_want) <= TOL
    assert err(p_got, p_want) <= TOL


def test_update_unitaries_and_apply_unitary_updates(x64):
    widths = (2, 2, 2, 2)
    params, phi_in, phi_out = problem(15, widths)
    jp, ji, jo = jx(params, phi_in, phi_out)
    ks_ref = ref_update_matrices(jp, ji, jo, widths, 1.0)
    ks = [torch.as_tensor(np.array(k)) for k in ks_ref]
    ups = qnn.update_unitaries(ks, 0.03)
    assert err(ups, jqnn.update_unitaries(ks_ref, 0.03)) <= TOL
    for impl, tol in (("xla", TOL), ("pallas", KERNEL_TOL)):
        got = qnn.apply_unitary_updates(tc(params)[0], ups, impl=impl)
        want = jqnn.apply_unitary_updates(
            jp, [jnp.asarray(u.numpy()) for u in ups])
        assert err(got, want) <= tol


def test_unknown_engine_is_refused():
    params, phi_in, phi_out = problem(1, (1, 2, 1))
    with pytest.raises(ValueError):
        qnn.update_matrices(*tc(params, phi_in, phi_out), (1, 2, 1), 1.0,
                            engine="sparse")


# ---------------------------------------------- certified approximate rank
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_rank_tol_zero_is_bit_exact(x64, widths):
    params, phi_in, phi_out = problem(19, widths)
    tp, ti, to = tc(params, phi_in, phi_out)
    for impl in qnn.IMPLS:
        base = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl)
        ks, bound = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl,
                                        rank_tol=0.0, rank_cap=None,
                                        ensemble_dtype=None, with_bound=True)
        assert bound.shape == () and float(bound) == 0.0
        assert all(torch.equal(a, b) for a, b in zip(base, ks))


@pytest.mark.parametrize("knobs", APPROX_KNOBS)
@pytest.mark.parametrize("widths", WIDTH_CASES)
def test_certificate_dominates_the_dense_oracle(x64, widths, knobs):
    """The certificate bounds the measured max-abs deviation from the
    dense oracle; K's and certificate match the reference's (truncation
    is basis-free: densities and sums of dropped s_i^2)."""
    params, phi_in, phi_out = problem(29, widths)
    tp, ti, to = tc(params, phi_in, phi_out)
    ks, bound = qnn.update_matrices(tp, ti, to, widths, 1.0,
                                    with_bound=True, **knobs)
    dev = float(dense_ref.oracle_deviation(ks, tp, ti, to, widths, 1.0))
    assert float(bound) > 0.0
    assert dev <= float(bound) + 1e-12, (dev, float(bound))
    want, want_bound = ref_update_matrices(*jx(params, phi_in, phi_out),
                                           widths, 1.0, with_bound=True,
                                           **knobs)
    assert err(ks, want) <= TOL
    assert abs(float(bound) - float(want_bound)) <= TOL * float(want_bound)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_certificate_dominates_weighted_and_per_node(x64, impl):
    """Through the weighted average (zero-weight padding included), and
    per node with the node axis: each node's certificate is its own
    single-node one and dominates its own deviation."""
    widths = (2, 3, 2)
    nodes = [problem(37 + p, widths, n=6) for p in range(2)]
    knobs = dict(rank_tol=0.05, rank_cap=3, with_bound=True)
    tp = [torch.stack([torch.as_tensor(nd[0][l]) for nd in nodes])
          for l in range(2)]
    ti = torch.stack([torch.as_tensor(nd[1]) for nd in nodes])
    to = torch.stack([torch.as_tensor(nd[2]) for nd in nodes])
    tw = torch.as_tensor(np.stack([weights_with_padding(38 + p, 6)
                                   for p in range(2)]))
    ks, bound = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl,
                                    weights=tw, **knobs)
    assert bound.shape == (2,)
    dev = dense_ref.oracle_deviation(ks, tp, ti, to, widths, 1.0, weights=tw)
    assert dev.shape == (2,)
    for p in range(2):
        one_ks, one_bound = qnn.update_matrices(
            [x[p] for x in tp], ti[p], to[p], widths, 1.0, impl=impl,
            weights=tw[p], **knobs)
        assert float(one_bound) > 0.0
        assert float(bound[p]) == float(one_bound)
        assert err([k[p] for k in ks], [k.numpy() for k in one_ks]) <= TOL
        assert float(dev[p]) <= float(bound[p]) + 1e-12


def test_approx_engine_guard_raises(x64):
    params, phi_in, phi_out = problem(43, (2, 3, 2))
    for engine in ("dense", "local_opb"):
        with pytest.raises(ValueError):
            qnn.update_matrices(*tc(params, phi_in, phi_out), (2, 3, 2), 1.0,
                                engine=engine, rank_cap=2)
    with pytest.raises(ValueError):
        ql.resolve_approx(0.0, None, "f16")  # unknown storage dtype
    with pytest.raises(ValueError):
        ql.resolve_approx(-0.1, None, None)
    with pytest.raises(ValueError):
        ql.resolve_approx(0.0, 0, None)
    assert ql.resolve_approx() is None


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 5e-2)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ensemble_storage_dtypes(x64, dtype, tol, impl):
    """Reduced ensemble storage: K stays complex128 (widened at the trace,
    the kernel's boundary under impl="pallas") and deviates from the dense
    oracle at storage precision; no rank dropped, so the bound is 0."""
    widths = (2, 3, 2)
    params, phi_in, phi_out = problem(53, widths)
    tp, ti, to = tc(params, phi_in, phi_out)
    ks, bound = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl,
                                    ensemble_dtype=dtype, with_bound=True)
    assert float(bound) == 0.0
    assert all(k.dtype == torch.complex128 for k in ks)
    dev = float(dense_ref.oracle_deviation(ks, tp, ti, to, widths, 1.0))
    assert dev <= tol, dev
    stored = ql.ensemble_store(torch.as_tensor(phi_in),
                               ql.resolve_approx(ensemble_dtype=dtype))
    want = jql.ensemble_store(jnp.asarray(phi_in),
                              jql.resolve_approx(ensemble_dtype=dtype))
    assert stored.dtype == torch.complex64
    assert np.array_equal(stored.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,rank,tols", [(1, 4, (0.01, 0.3, 0.9)),
                                         (2, 6, (0.001, 0.2, 0.5, 0.8)),
                                         (3, 11, (0.05, 0.1, 0.6))])
def test_compress_error_exact_and_monotone_in_rank_tol(x64, n, rank, tols):
    """The truncation error is the trace norm of the dropped PSD mass and
    does not decrease as rank_tol grows; the reference gives the same."""
    v = torch.as_tensor(rand_states(np.random.default_rng(n), n, rank))
    rho = qnn.density_from_ensemble(v)
    errs = []
    for tol in tols:
        approx = ql.resolve_approx(tol, None, None)
        vc, e = ql.ensemble_compress(v, approx=approx, with_err=True)
        errs.append(float(e))
        drop = rho - qnn.density_from_ensemble(vc)
        assert float(torch.linalg.eigvalsh(drop).abs().sum()) <= float(e) + TOL
        _, want = jql.ensemble_compress(jnp.asarray(v.numpy()),
                                        jql.resolve_approx(tol, None, None),
                                        with_err=True)
        assert abs(float(e) - float(want)) <= TOL
    assert all(lo <= hi + 1e-12 for lo, hi in zip(errs, errs[1:])), errs
    _, e0 = ql.ensemble_compress(v, with_err=True)
    assert float(e0) == 0.0


def test_bound_ladder_monotone_end_to_end(x64):
    widths = (2, 3, 2)
    tp, ti, to = tc(*problem(47, widths))
    bounds = [float(qnn.update_matrices(tp, ti, to, widths, 1.0,
                                        rank_tol=tol, with_bound=True)[1])
              for tol in (0.0, 1e-8, 1e-3, 0.1, 0.5)]
    assert bounds[0] == 0.0
    assert all(lo <= hi + 1e-12 for lo, hi in zip(bounds, bounds[1:]))


# ------------------------------------------------------------ data
@pytest.mark.parametrize("ratio,counts", [(0.3, None), (0.3, (10, 7, 3, 5)),
                                          (0.5, (10, 7, 3, 5)), (1.0, None)])
def test_pollute_keeps_rows_and_counts_as_reference(x64, ratio, counts):
    """The rows pollute keeps are the input's, bit for bit, and the count
    it replaces per node is the reference's, ceil(ratio N_n) in float64
    (0.3 of 10 is 3)."""
    rng = np.random.default_rng(9)
    phi_in, phi_out = rand_states(rng, 2, 4, 10), rand_states(rng, 3, 4, 10)
    jc = None if counts is None else jnp.asarray(counts, jnp.int32)
    tcnt = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    j_in, j_out = jdata.pollute(jax.random.PRNGKey(0), jnp.asarray(phi_in),
                                jnp.asarray(phi_out), ratio, 2, counts=jc)
    t_in, t_out = qdata.pollute(torch.Generator().manual_seed(0),
                                torch.as_tensor(phi_in),
                                torch.as_tensor(phi_out), ratio, 2,
                                counts=tcnt)
    for ours, theirs, clean in ((t_in, j_in, phi_in), (t_out, j_out, phi_out)):
        kept = np.all(ours.numpy() == clean, axis=-1)
        assert np.array_equal(kept, np.all(np.asarray(theirs) == clean, -1))
        want_noisy = np.ceil(ratio * np.asarray(counts or [10] * 4) - 1e-9)
        assert np.array_equal((~kept).sum(-1), want_noisy)
        assert np.allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0)
    if ratio == 0.3 and counts is None:
        assert int((~kept).sum(-1)[0]) == 3


@pytest.mark.parametrize("node_sizes", [None, (10, 7, 3, 5)])
def test_make_federated_dataset_noise_ratio(node_sizes):
    """noise_ratio pollutes ceil(0.3 N_n) leading pairs of each node and
    leaves the rest, and the clean test pairs, as the clean dataset's."""
    def make(ratio):
        return qdata.make_federated_dataset(
            torch.Generator().manual_seed(4), 2, 4, 10, noise_ratio=ratio,
            n_test=6, node_sizes=node_sizes, device="cpu")
    _, clean, _ = make(0.0)
    _, noisy, test = make(0.3)
    kept = torch.all(noisy.phi_in == clean.phi_in, dim=-1)
    sizes = np.asarray(node_sizes or [10] * 4)
    n_max = clean.phi_in.shape[1]
    for node, size in enumerate(sizes):
        n_noisy = int(np.ceil(0.3 * size - 1e-9))
        assert not bool(kept[node, :n_noisy].any())
        assert bool(kept[node, n_noisy:].all())
        # padding stays zero where the true count ends
        assert bool((noisy.phi_in[node, size:n_max] == 0).all())
    assert test[0].shape == (6, 4)


# ------------------------------------------------------------ rounds
ROUND_KEY = jax.random.PRNGKey(13)


@functools.lru_cache(maxsize=None)
def round_setup():
    rng = np.random.default_rng(11)
    u = rand_unitaries(rng, 4)
    phi_in = rand_states(rng, 2, 16)
    ds = jdata.partition_non_iid(jnp.asarray(phi_in),
                                 jnp.asarray(phi_in @ u.T), 4)
    params = [rand_unitaries(rng, 3, 8), rand_unitaries(rng, 2, 16)]
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), None, "cpu")
    return ([jnp.asarray(p) for p in params], ds), (tc(params)[0], tds)


def configs(**kw):
    base = dict(widths=(2, 3, 2), num_nodes=4, nodes_per_round=4,
                interval_length=2, eps=0.05)
    base.update(kw)
    return jfed.QuantumFedConfig(**base), fed.QuantumFedConfig(**base)


@pytest.mark.parametrize("aggregation", ["product", "average"])
@pytest.mark.parametrize("engine,impl", [("local", "xla"),
                                         ("local_opb", "xla"),
                                         ("local_opb", "pallas"),
                                         ("dense", "xla")])
def test_server_round_per_engine_matches_reference(x64, engine, impl,
                                                   aggregation):
    """A full round through the port's phases, fed the reference's
    selection, against the reference's fused round per engine and
    aggregation; and against the port's own dense round."""
    jcfg, tcfg = configs(engine=engine, impl=impl, aggregation=aggregation)
    (params, ds), (tparams, tds) = round_setup()
    k_sel = jax.random.split(ROUND_KEY, 3)[0]
    sel, _, weights = jfed.select_phase(ds, k_sel, jcfg)
    tsel, tweights = (torch.tensor(np.asarray(x)) for x in (sel, weights))
    want = jfed.server_round(params, ds, ROUND_KEY, jcfg)
    reuse = fed._factors_survive_wire(tcfg)
    out = fed.local_phase(tparams, tds, tsel, torch.Generator(), tcfg,
                          with_factors=reuse)
    ks, factors = out if reuse else (out, None)
    got, _ = fed.aggregate_phase(tparams, fed.transmit_phase(
        ks, torch.Generator(), tcfg), tweights, tcfg, factors=factors)
    tol = TOL if impl == "xla" else KERNEL_TOL
    assert err(got, want) <= tol
    dense, _ = fed.aggregate_phase(tparams, fed.local_phase(
        tparams, tds, tsel, torch.Generator(),
        tcfg._replace(engine="dense", impl="xla")), tweights,
        tcfg._replace(engine="dense", impl="xla"))
    assert err(got, [p.numpy() for p in dense]) <= tol


def test_server_round_certified(x64):
    """Exact cfg: bound 0 and the params of server_round bit for bit;
    approx cfg: err_bound = sum_n w_n bound_n of the selected nodes'
    own certificates (not the sum over nodes before the weights), and
    finite unitary params; server momentum on the average combine
    returns its state, and unknown server optimisers are refused."""
    _, tcfg = configs(num_nodes=4, nodes_per_round=3)
    _, (tparams, tds) = round_setup()
    plain = fed.server_round(tparams, tds, torch.Generator().manual_seed(3),
                             tcfg)
    got, smom, bound = fed.server_round_certified(
        tparams, tds, torch.Generator().manual_seed(3), tcfg)
    assert smom is None and bound.dtype == torch.float64
    assert float(bound) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(plain, got))

    acfg = tcfg._replace(rank_tol=1e-3, rank_cap=2)
    p_apx, _, bound_a = fed.server_round_certified(
        tparams, tds, torch.Generator().manual_seed(3), acfg)
    g = torch.Generator().manual_seed(3)
    sel, _, weights = fed.select_phase(tds, g, acfg)
    _, _, bounds = fed.local_phase(tparams, tds, sel, g, acfg,
                                   with_factors=True, with_bound=True)
    assert bounds.shape == (3,) and float(bounds.min()) > 0.0
    assert float(bound_a) == float(torch.sum(weights.double() * bounds))
    assert float(bound_a) < float(bounds.sum())
    for p in p_apx:
        assert bool(ql.is_unitary(p, 1e-10))
    # server momentum needs the Eq. 8 average; it refuses the product
    with pytest.raises(ValueError):
        fed.server_round_certified(tparams, tds, torch.Generator(), acfg,
                                   server_opt="momentum")
    mcfg = acfg._replace(aggregation="average")
    _, smom, bound_m = fed.server_round_certified(
        tparams, tds, torch.Generator().manual_seed(3), mcfg,
        server_opt="momentum")
    assert [tuple(m.shape) for m in smom] == [(2,) + tuple(p.shape)
                                             for p in tparams]
    assert float(bound_m) > 0.0
    with pytest.raises(ValueError):
        fed.server_round_certified(tparams, tds, torch.Generator(), acfg,
                                   server_opt="adam")
