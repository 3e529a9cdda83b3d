"""Parity of the port's QNN (``repro_torch.core.quantum.qnn``) with the
JAX reference on the exact ``engine="local"`` path, x64.

impl="xla" (plain complex128 PyTorch) matches the reference's xla path
to <= 1e-10; impl="pallas" (the kernels' plain fp32 versions on the CPU)
matches the reference's Pallas path, run in interpret mode, to <= 1e-5
(the kernels' fp32 budget, as in tests/test_engine_equivalence.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.quantum import qnn  # noqa: E402

TOLS = {"xla": 1e-10, "pallas": 1e-5}
WIDTHS = [(2, 3, 2), (2, 2, 2, 2)]

# the reference under jit: one compile per shape instead of one per op
ref_update_matrices = jax.jit(jqnn.update_matrices,
                              static_argnames=("widths", "impl"))
ref_outputs = jax.jit(jqnn.outputs, static_argnames=("widths", "impl"))
ref_cost_fidelity = jax.jit(jqnn.cost_fidelity,
                            static_argnames=("widths", "impl"))
ref_cost_mse = jax.jit(jqnn.cost_mse, static_argnames=("widths", "impl"))
ref_traces = jax.jit(jqnn.ensemble_commutator_traces,
                     static_argnames=("m_in", "m_out", "impl"))


def problem(seed, widths, n=5):
    """Random unitaries and pure states from seeded numpy, as jax arrays."""
    rng = np.random.default_rng(seed)

    def states(m, *batch):
        x = rng.standard_normal(batch + (2 ** m,)) + 1j * rng.standard_normal(
            batch + (2 ** m,))
        return jnp.asarray(x / np.linalg.norm(x, axis=-1, keepdims=True))

    params = []
    for m_in, m_out in zip(widths[:-1], widths[1:]):
        d = 2 ** (m_in + 1)
        z = rng.standard_normal((m_out, d, d)) + 1j * rng.standard_normal(
            (m_out, d, d))
        params.append(jnp.asarray(np.linalg.qr(z)[0]))
    return params, states(widths[0], n), states(widths[-1], n)


def port(params, *states):
    return (convert.params_to_torch([np.asarray(p) for p in params], "cpu"),
            *(convert.states_to_torch(np.asarray(s), "cpu") for s in states))


def max_err(xs, ys):
    return max(float(np.max(np.abs(x.resolve_conj().numpy() - np.asarray(y))))
               for x, y in zip(xs, ys))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("widths", WIDTHS)
def test_update_matrices(x64, widths, impl):
    params, phi_in, phi_out = problem(3, widths)
    want = ref_update_matrices(params, phi_in, phi_out, widths, 1.0,
                                impl=impl)
    tp, ti, to = port(params, phi_in, phi_out)
    got = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max_err(got, want) <= TOLS[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("widths", WIDTHS)
def test_update_matrices_weighted_with_padding(x64, widths, impl):
    """Per-example weights with a zero-weight padding slot, as the
    reference's engine-equivalence gate uses; K stays complex128."""
    params, phi_in, phi_out = problem(7, widths, n=6)
    w = jax.random.uniform(jax.random.PRNGKey(8), (6,), dtype=jnp.float64)
    w = w.at[0].set(0.0)
    want = ref_update_matrices(params, phi_in, phi_out, widths, 1.0,
                                impl=impl, weights=w)
    tp, ti, to = port(params, phi_in, phi_out)
    got = qnn.update_matrices(tp, ti, to, widths, 1.0, impl=impl,
                              weights=torch.tensor(np.asarray(w)))
    assert all(k.dtype == torch.complex128 for k in got)
    assert max_err(got, want) <= TOLS[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_update_matrices_node_axis_keeps_nodes_apart(x64, impl):
    """P nodes with their own unitaries and data in one call give each
    node exactly its own reference K's: no node leaks into another's
    example sum (the kernel folds nodes into its J axis)."""
    widths = (2, 3, 2)
    nodes = [problem(20 + p, widths, n=4) for p in range(3)]
    tp = [torch.stack([convert.params_to_torch(
        [np.asarray(x) for x in node[0]], "cpu")[l] for node in nodes])
        for l in range(2)]
    ti = torch.stack([convert.states_to_torch(np.asarray(nd[1]), "cpu")
                      for nd in nodes])
    to = torch.stack([convert.states_to_torch(np.asarray(nd[2]), "cpu")
                      for nd in nodes])
    got = qnn.update_matrices(tp, ti, to, widths, 0.7, impl=impl)
    for p, (params, phi_in, phi_out) in enumerate(nodes):
        want = ref_update_matrices(params, phi_in, phi_out, widths, 0.7,
                                    impl=impl)
        assert max_err([k[p] for k in got], want) <= TOLS[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("widths", WIDTHS)
def test_outputs_and_costs(x64, widths, impl):
    params, phi_in, phi_out = problem(12, widths, n=7)
    tp, ti, to = port(params, phi_in, phi_out)
    tol = TOLS[impl]
    assert max_err([qnn.outputs(tp, ti, widths, impl=impl)],
                   [ref_outputs(params, phi_in, widths, impl=impl)]) <= tol
    for ours, theirs in ((qnn.cost_fidelity, ref_cost_fidelity),
                         (qnn.cost_mse, ref_cost_mse)):
        got = float(ours(tp, ti, to, widths, impl=impl))
        want = float(theirs(params, phi_in, phi_out, widths, impl=impl))
        assert abs(got - want) <= tol


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("ea,eb", [(2, 6), (6, 2)])
def test_ensemble_commutator_traces_both_orientations(x64, impl, ea, eb):
    """The port's trace (the kernel path, its plain fp32 version on the
    CPU) against the reference's complex128 einsum ("xla") and its
    Pallas kernel in interpret mode ("pallas"), at the kernels' fp32
    budget, with the smaller ensemble on either side."""
    m_in, m_out = 2, 3
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((m_out, 4, e, 32))
            + 1j * rng.standard_normal((m_out, 4, e, 32)) for e in (ea, eb))
    a, b = (jnp.asarray(x / np.linalg.norm(x, axis=-1, keepdims=True))
            for x in (a, b))
    want = ref_traces(a, b, m_in=m_in, m_out=m_out, impl=impl)
    got = qnn.ensemble_commutator_traces(
        convert.states_to_torch(np.asarray(a), "cpu")[None],
        convert.states_to_torch(np.asarray(b), "cpu")[None], m_in, m_out)
    assert got.shape == (1, m_out, 8, 8)
    assert max_err([got[0]], [want]) <= TOLS["pallas"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_local_step_and_apply_updates(x64, impl):
    widths = (2, 2, 2, 2)   # equal-width layers: the grouped paths
    params, phi_in, phi_out = problem(14, widths)
    p_want, ks_want = jqnn.local_step(params, phi_in, phi_out, widths, 1.0,
                                      0.07, impl=impl)
    tp, ti, to = port(params, phi_in, phi_out)
    p_got, ks_got = qnn.local_step(tp, ti, to, widths, 1.0, 0.07, impl=impl)
    assert max_err(ks_got, ks_want) <= TOLS[impl]
    assert max_err(p_got, p_want) <= TOLS[impl]
    factors = qnn.eigh_updates(ks_got)
    via_eigh = qnn.apply_updates_eigh(tp, factors, 0.07, impl=impl)
    assert max_err(via_eigh, [p.numpy() for p in p_got]) <= TOLS[impl]


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError):
        qnn.bmm(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), impl="cuda")
