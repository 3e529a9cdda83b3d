"""Parity of the port's federated round (``repro_torch.core.quantum.
federated``) with the JAX reference, x64, at the reference's own
round-equivalence setting: widths (2,3,2), N=4, N_p=4, I_l=2, eps=0.05.

The port draws its own randomness, so the reference's selection (the
``k_sel`` split of its round key) is injected into the port's phases;
GD (minibatch=None) makes the node keys irrelevant. impl="xla" agrees
to <= 1e-10, impl="pallas" (the kernels' fp32 plain versions here) to
<= 1e-5, the budget the reference's own round gate uses."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402
from repro_torch.core.quantum import linalg as ql  # noqa: E402

TOLS = {"xla": 1e-10, "pallas": 1e-5}
WIDTHS = (2, 3, 2)
ROUND_KEY = jax.random.PRNGKey(13)

ref_aggregate_product = jax.jit(jfed.aggregate_product,
                                static_argnames=("impl",))
ref_aggregate_average = jax.jit(jfed.aggregate_average,
                                static_argnames=("impl",))
ref_node_batch = jax.jit(jfed._node_batch,
                         static_argnames=("cfg", "with_factors",
                                          "with_bound"))


def config(impl, aggregation="product", **kw):
    base = dict(widths=WIDTHS, num_nodes=4, nodes_per_round=4,
                interval_length=2, eps=0.05, aggregation=aggregation,
                impl=impl)
    base.update(kw)
    return jfed.QuantumFedConfig(**base), fed.QuantumFedConfig(**base)


def rand_states(rng, n, d):
    x = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rand_unitaries(rng, m, d):
    z = rng.standard_normal((m, d, d)) + 1j * rng.standard_normal((m, d, d))
    return np.linalg.qr(z)[0]


@functools.lru_cache(maxsize=None)
def setup(node_sizes=None):
    """Reference dataset and params from seeded numpy arrays (built once;
    every caller runs x64): pairs (phi, U phi) for a random target U,
    split by the reference's own non-iid partition."""
    rng = np.random.default_rng(11)
    u = rand_unitaries(rng, 1, 4)[0]
    n_total = 16 if node_sizes is None else sum(node_sizes)
    phi_in = rand_states(rng, n_total, 4)
    ds = jdata.partition_non_iid(jnp.asarray(phi_in),
                                 jnp.asarray(phi_in @ u.T), 4, node_sizes)
    t_in = rand_states(rng, 8, 4)
    test = (jnp.asarray(t_in), jnp.asarray(t_in @ u.T))
    params = [jnp.asarray(rand_unitaries(rng, 3, 8)),
              jnp.asarray(rand_unitaries(rng, 2, 16))]
    n_per = None if ds.n_per is None else np.asarray(ds.n_per)
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), n_per, "cpu")
    tparams = convert.params_to_torch([np.asarray(p) for p in params], "cpu")
    ttest = tuple(convert.states_to_torch(np.asarray(x), "cpu")
                  for x in test)
    return (params, ds, test), (tparams, tds, ttest)


def reference_selection(ds, jcfg):
    k_sel = jax.random.split(ROUND_KEY, 3)[0]
    sel, _, weights = jfed.select_phase(ds, k_sel, jcfg)
    return sel, weights, torch.tensor(np.asarray(sel)), torch.tensor(
        np.asarray(weights))


def max_err(xs, ys):
    return max(float(np.max(np.abs(x.resolve_conj().numpy() - np.asarray(y))))
               for x, y in zip(xs, ys))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_node_update(x64, impl):
    jcfg, tcfg = config(impl)
    (params, ds, _), (tparams, tds, _) = setup()
    sel, _, tsel, _ = reference_selection(ds, jcfg)
    keys = jax.random.split(ROUND_KEY, 4)
    ks_ref, fac_ref = ref_node_batch(params, ds.phi_in[sel], ds.phi_out[sel],
                                     keys, None, jcfg.eta, jcfg.eps, jcfg,
                                     with_factors=True)
    ks, factors = fed.node_update(tparams, tds.phi_in[tsel],
                                  tds.phi_out[tsel], gen(), tcfg.eta,
                                  tcfg.eps, tcfg, return_factors=True)
    assert [k.shape for k in ks] == [k.shape for k in ks_ref]
    assert max_err(ks, ks_ref) <= TOLS[impl]
    # eigh factors are unique up to phases: compare the exponentials
    for (lam, v), (jlam, jv) in zip(factors, fac_ref):
        assert max_err([ql.expm_eigh(lam, v, 0.3)],
                       [jnp.einsum("...ab,...b,...cb->...ac", jv,
                                   jnp.exp(0.3j * jlam), jnp.conj(jv))]
                       ) <= TOLS[impl]


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_aggregate_product(x64, impl, reuse):
    jcfg, tcfg = config(impl)
    (params, ds, _), (tparams, tds, _) = setup()
    sel, weights, tsel, tweights = reference_selection(ds, jcfg)
    keys = jax.random.split(ROUND_KEY, 4)
    ks_ref, fac_ref = ref_node_batch(params, ds.phi_in[sel], ds.phi_out[sel],
                                     keys, None, jcfg.eta, jcfg.eps, jcfg,
                                     with_factors=True)
    ks, factors = fed.node_update(tparams, tds.phi_in[tsel],
                                  tds.phi_out[tsel], gen(), tcfg.eta,
                                  tcfg.eps, tcfg, return_factors=True)
    want = ref_aggregate_product(params, ks_ref, weights, jcfg.eps,
                                 impl=impl, factors=fac_ref if reuse else None)
    got = fed.aggregate_product(tparams, ks, tweights, tcfg.eps, impl=impl,
                                factors=factors if reuse else None)
    assert max_err(got, want) <= TOLS[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_aggregate_average(x64, impl):
    """Same uploads (the reference's K's) into both Eq. 8 combines."""
    jcfg, tcfg = config(impl, "average")
    (params, ds, _), (tparams, _, _) = setup()
    sel, weights, _, tweights = reference_selection(ds, jcfg)
    ks_ref = jfed.local_phase(params, ds, sel, ROUND_KEY, jcfg)
    ks = [torch.tensor(np.asarray(k)) for k in ks_ref]
    want = ref_aggregate_average(params, ks_ref, weights, jcfg.eps, impl=impl)
    got = fed.aggregate_average(tparams, ks, tweights, tcfg.eps, impl=impl)
    assert max_err(got, want) <= TOLS[impl]


@pytest.mark.parametrize("aggregation", ["product", "average", "served"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_round_with_reference_selection(x64, impl, aggregation):
    """One full round composed from the port's phases, fed the
    reference's selection, against the reference's fused round."""
    jcfg, tcfg = config(impl, aggregation)
    (params, ds, _), (tparams, tds, _) = setup()
    _, _, tsel, tweights = reference_selection(ds, jcfg)
    want = jfed.server_round(params, ds, ROUND_KEY, jcfg)
    reuse = fed._factors_survive_wire(tcfg)
    assert reuse == (aggregation == "product")
    out = fed.local_phase(tparams, tds, tsel, gen(), tcfg, with_factors=reuse)
    ks, factors = out if reuse else (out, None)
    ks = fed.transmit_phase(ks, gen(), tcfg)
    got, _ = fed.aggregate_phase(tparams, ks, tweights, tcfg, factors=factors)
    assert max_err(got, want) <= TOLS[impl]


def test_round_unequal_nodes_with_reference_selection(x64):
    """Padded nodes: the validity masks reach the node pass and the true
    counts set the Alg. 2 weights."""
    jcfg, tcfg = config("xla")
    (params, ds, _), (tparams, tds, _) = setup(node_sizes=(3, 4, 2, 4))
    assert np.array_equal(tds.valid_mask().numpy(),
                          np.asarray(ds.valid_mask()))
    _, weights, tsel, tweights = reference_selection(ds, jcfg)
    sel_w = fed.participation.round_weights(
        "uniform", tds.node_counts()[tsel], torch.ones(4))
    assert torch.equal(sel_w, tweights) and sel_w.dtype == torch.float32
    want = jfed.server_round(params, ds, ROUND_KEY, jcfg)
    ks, factors = fed.local_phase(tparams, tds, tsel, gen(), tcfg,
                                  with_factors=True)
    got, _ = fed.aggregate_phase(tparams, ks, tweights, tcfg, factors=factors)
    assert max_err(got, want) <= TOLS["xla"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_evaluate(x64, impl):
    (params, _, test), (tparams, _, ttest) = setup()
    want = jfed.evaluate(params, *test, WIDTHS, impl=impl)
    got = fed.evaluate(tparams, *ttest, WIDTHS, impl=impl)
    w = jnp.asarray([1.0, 0.0, 1.0, 1.0, 0.5, 1.0, 0.0, 1.0])
    want_w = jfed.evaluate(params, *test, WIDTHS, impl=impl, weights=w)
    got_w = fed.evaluate(tparams, *ttest, WIDTHS, impl=impl,
                         weights=torch.tensor(np.asarray(w)))
    for k in ("fidelity", "mse"):
        assert abs(float(got[k]) - float(want[k])) <= TOLS[impl]
        assert abs(float(got_w[k]) - float(want_w[k])) <= TOLS[impl]


def test_server_round_is_its_phases_under_one_generator(x64):
    _, tcfg = config("xla")
    _, (tparams, tds, _) = setup()
    got = fed.server_round(tparams, tds, gen(3), tcfg)
    g = gen(3)
    sel, _, weights = fed.select_phase(tds, g, tcfg)
    assert sorted(sel.tolist()) == [0, 1, 2, 3]
    ks, factors = fed.local_phase(tparams, tds, sel, g, tcfg,
                                  with_factors=True)
    ks = fed.transmit_phase(ks, g, tcfg)
    want, _ = fed.aggregate_phase(tparams, ks, weights, tcfg, factors=factors)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
        eye = torch.eye(a.shape[-1], dtype=a.dtype)
        assert float((a @ ql.dagger(a) - eye).abs().max()) <= 1e-10


def test_minibatch_draws_valid_pairs_per_node(x64):
    _, tcfg = config("xla", minibatch=2, num_nodes=4)
    _, (tparams, tds, _) = setup(node_sizes=(3, 4, 2, 4))
    ks = fed.local_phase(tparams, tds, torch.arange(4), gen(1), tcfg)
    assert [tuple(k.shape) for k in ks] == [(4, 2, 3, 8, 8), (4, 2, 2, 16, 16)]
    assert all(bool(torch.isfinite(k.abs()).all()) for k in ks)
    herm = max(float((k - ql.dagger(k)).abs().max()) for k in ks)
    assert herm <= 1e-12


# ------------------------------------------------- the mesh fan-out
# Full participation and GD: the round draws nothing, so the port's
# round meets the reference's vmap round. (The reference's own shard_map
# round does not run on this JAX; its tests of it are standing failures.)
FANOUT_CASES = [("product", "flat"), ("average", "flat"),
                ("product", "two_level"), ("average", "two_level")]


def fanout_kw(aggregation, topology, **kw):
    return dict(aggregation=aggregation, participation="full",
                topology=topology,
                pods=2 if topology == "two_level" else None, **kw)


@pytest.fixture
def pod_mesh():
    """A one-rank gloo mesh with a 'pod' axis, destroyed at teardown."""
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_host_mesh((1,), ("pod",), device="cpu")
    yield mesh
    mesh_lib.close()


@pytest.mark.parametrize("aggregation,topology", FANOUT_CASES)
def test_shard_map_on_one_rank_is_the_vmap_round(x64, pod_mesh, aggregation,
                                                 topology):
    jcfg, tcfg = config("xla", **fanout_kw(aggregation, topology))
    (params, ds, _), (tparams, tds, _) = setup()
    want = jfed.server_round(params, ds, ROUND_KEY,
                             jcfg._replace(fanout="vmap"))
    batched = fed.server_round(tparams, tds, gen(),
                               tcfg._replace(fanout="vmap"))
    with pod_mesh:
        got = fed.server_round(tparams, tds, gen(),
                               tcfg._replace(fanout="shard_map"))
    assert all(torch.equal(a, b) for a, b in zip(got, batched))
    assert max_err(got, want) <= TOLS["xla"]


def test_shard_map_draws_every_minibatch_before_the_split(x64, pod_mesh):
    _, tcfg = config("xla", minibatch=2, num_nodes=4)
    _, (tparams, tds, _) = setup(node_sizes=(3, 4, 2, 4))
    batched = fed.server_round(tparams, tds, gen(3),
                               tcfg._replace(fanout="vmap"))
    with pod_mesh:
        got = fed.server_round(tparams, tds, gen(3),
                               tcfg._replace(fanout="shard_map"))
    assert all(torch.equal(a, b) for a, b in zip(got, batched))


RANKS = """
from repro_torch.core.quantum import federated as fed
from repro_torch.core.quantum.data import QuantumDataset
case = torch.load(OUT + "/in.pt", weights_only=False)
ds = QuantumDataset(*case["dataset"])
mesh = host_mesh((WORLD,), ("pod",))
with mesh:
    out = [fed.server_round(case["params"], ds,
                            torch.Generator().manual_seed(case["seed"]),
                            fed.QuantumFedConfig(**kw)) for kw in case["cfgs"]]
torch.save(out, f"{OUT}/rank{RANK}.pt")
mesh_lib.close()
"""
TWO_RANK_CASES = {"product": fanout_kw("product", "flat"),
                  "average": fanout_kw("average", "flat"),
                  "minibatch": dict(aggregation="product", minibatch=2)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each TWO_RANK_CASES round with fanout="shard_map" on two gloo
    ranks, each rank running half the nodes; {case: (rank 0's params,
    rank 1's)}."""
    from torch_ranks import run_ranks
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        _, (tparams, tds, _) = setup()
    finally:
        jax.config.update("jax_enable_x64", prev)
    tmp = tmp_path_factory.mktemp("ranks")
    cfgs = [config("xla", fanout="shard_map", **kw)[1]._asdict()
            for kw in TWO_RANK_CASES.values()]
    torch.save({"params": tparams, "dataset": tuple(tds), "seed": 4,
                "cfgs": cfgs}, tmp / "in.pt")
    run_ranks(RANKS, 2, tmp)
    outs = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return dict(zip(TWO_RANK_CASES, zip(*outs)))


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_shard_map_on_two_ranks_matches_the_reference(x64, two_ranks,
                                                      aggregation):
    jcfg, _ = config("xla", **fanout_kw(aggregation, "flat"))
    (params, ds, _), _ = setup()
    want = jfed.server_round(params, ds, ROUND_KEY, jcfg)
    rank0, rank1 = two_ranks[aggregation]
    assert all(torch.equal(a, b) for a, b in zip(rank0, rank1))
    assert max_err(rank0, want) <= TOLS["xla"]


def test_shard_map_on_two_ranks_draws_as_one_batch(x64, two_ranks):
    """Every minibatch draw is made before the split, so the two ranks'
    round is the one-process round (to rounding: each rank batches half
    the nodes)."""
    _, tcfg = config("xla", **TWO_RANK_CASES["minibatch"])
    _, (tparams, tds, _) = setup()
    want = fed.server_round(tparams, tds, gen(4), tcfg)
    rank0, rank1 = two_ranks["minibatch"]
    assert all(torch.equal(a, b) for a, b in zip(rank0, rank1))
    assert max(float((a - b).abs().max()) for a, b in zip(rank0, want)) \
        <= TOLS["xla"]


class FakeMesh:
    """The reference tests' stand-in mesh: axis names and sizes only."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _error(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the error is the result
        return type(e), str(e)
    return None


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 1}, {"pod": 3}],
                         ids=["no_pod_axis", "pod_axis_not_dividing"])
def test_fanout_errors_match_the_reference(monkeypatch, mesh):
    """fanout="shard_map" without a 'pod' axis, or with one that does not
    divide nodes_per_round: the reference's ValueErrors, text for text,
    from the round's fan-out check and from the fan-out itself."""
    from repro.sharding import rules as jrules
    from repro_torch.sharding import rules
    jcfg, tcfg = config("xla", fanout="shard_map")
    monkeypatch.setattr(jrules, "current_mesh", lambda: FakeMesh(mesh))
    monkeypatch.setattr(rules, "current_mesh", lambda: mesh)
    want = _error(lambda: jfed._resolve_fanout(jcfg))
    assert want is not None and want[0] is ValueError
    assert _error(lambda: fed._resolve_fanout(tcfg)) == want
    want = _error(lambda: jfed._fan_out(None, None, None, None, None, 1.0,
                                        0.1, jcfg, FakeMesh(mesh)))
    assert want is not None and want[0] is ValueError
    assert _error(lambda: fed._fan_out(None, None, None, None, [], 1.0, 0.1,
                                       tcfg, mesh, False, False)) == want


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_two_level_round_runs_and_equals_flat(x64, aggregation):
    """topology="two_level" has a path: the round through the pod tree
    (pods = 2) equals the flat round from the same generator."""
    _, tcfg = config("xla", aggregation=aggregation)
    _, (tparams, tds, _) = setup()
    flat = fed.server_round(tparams, tds, gen(5), tcfg)
    tree = fed.server_round(tparams, tds, gen(5),
                            tcfg._replace(topology="two_level", pods=2))
    assert max_err(flat, tree) <= TOLS["xla"]


@pytest.mark.parametrize("ok", [dict(participation_method="sampled"),
                                dict(aggregation="average", defense="clip"),
                                dict(aggregation="average",
                                     defense="trimmed_mean"),
                                dict(upload_noise=0.1),
                                dict(quantize_bits=8)])
def test_ported_fed_core_options_pass(ok):
    _, tcfg = config("xla", **ok)
    assert fed.check_supported(tcfg) is tcfg


@pytest.mark.parametrize("bad", [dict(aggregation="product",
                                      defense="median"),
                                 dict(aggregation="average",
                                      defense="screen"),
                                 dict(upload_noise=0.1, quantize_bits=8)])
def test_fed_core_configs_no_path_accepts_are_refused(bad):
    _, tcfg = config("xla", **bad)
    with pytest.raises(ValueError):
        fed.check_supported(tcfg)


@pytest.mark.parametrize("ok", [dict(engine="local"),
                                dict(engine="local_opb"),
                                dict(engine="dense"),
                                dict(rank_tol=1e-3),
                                dict(rank_cap=4),
                                dict(ensemble_dtype="bf16"),
                                dict(rank_tol=1e-3, rank_cap=6,
                                     ensemble_dtype="f32")])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ported_engines_and_approx_knobs_pass(ok, impl):
    _, tcfg = config(impl, **ok)
    assert fed.check_supported(tcfg) is tcfg


@pytest.mark.parametrize("bad", [dict(engine="dense", rank_tol=1e-3),
                                 dict(engine="local_opb", rank_cap=2),
                                 dict(engine="dense", ensemble_dtype="f32"),
                                 dict(engine="sparse"),
                                 dict(rank_tol=1.5),
                                 dict(ensemble_dtype="f16")])
def test_approx_knobs_outside_the_local_engine_are_refused(bad):
    _, tcfg = config("xla", **bad)
    with pytest.raises(ValueError):
        fed.check_supported(tcfg)


@pytest.mark.parametrize("bad", [dict(participation="stratified"),
                                 dict(aggregation="median"),
                                 dict(impl="cuda")])
def test_unknown_names_are_refused(bad):
    _, tcfg = config(**{"impl": "xla", **bad})
    with pytest.raises(ValueError):
        fed.check_supported(tcfg)
