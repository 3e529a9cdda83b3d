"""The port's two-level aggregation tree (``repro_torch.core.fed.cohort.
hierarchy``) and the rounds that take it, on the CPU.

* ``pod_products``, ``merge_products``, ``tree_chain`` and
  ``tree_mean_generators`` equal the reference's functions to <= 1e-10
  (x64), the port's carrying the session axis as a stack of one.
* A two-level round equals the flat round for both combines, and the
  strided pods the flat average, to <= 1e-10 in complex128 (the tree
  reassociates the chain: its rounding differs in order only); the
  kernels' plain versions to <= 1e-5. The defended and momentum rounds
  keep the reference's order (screen, then the product tree; clip, then
  the mean tree; momentum on the tree's mean).
* The port's two-level round equals the reference's (full
  participation, GD: no draw in the round) to <= 1e-10.
* The strided product's error, ``partial_fn``'s dispatch; the round
  with fanout="shard_map" on two gloo ranks (the nodes and the pod tier
  spread) against the reference's vmap round; a two-level stacked round
  against each session's solo round; a two-level session run and
  resumed bit for bit under the sync and async schedulers."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import api as japi  # noqa: E402
from repro.core.fed import strategies as jstrategies  # noqa: E402
from repro.core.fed.cohort import hierarchy as jhier  # noqa: E402
from repro.core.fed.cohort import topology as jtopo  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fed import api, strategies  # noqa: E402
from repro_torch.core.fed.cohort import hierarchy, topology  # noqa: E402
from repro_torch.core.quantum import data as qdata  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402
from repro_torch.core.quantum import qnn  # noqa: E402

TOL = 1e-10
KERNEL_TOL = 1e-5
WIDTHS = (2, 3, 2)


def max_dev(xs, ys):
    return max(float((torch.as_tensor(np.array(x)) -
                      torch.as_tensor(np.array(y))).abs().max())
               for x, y in zip(xs, ys))


def rand_unitaries(rng, *shape):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return np.linalg.qr(z)[0]


# ------------------------------------------------- the tree functions
TREE_FNS = ("pod_products", "merge_products", "tree_chain",
            "tree_mean_generators")


@pytest.mark.parametrize("assignment", topology.ASSIGNMENTS)
@pytest.mark.parametrize("name", TREE_FNS)
def test_tree_function_matches_reference(x64, name, assignment):
    rng = np.random.default_rng(3)
    n, il, m, d, pods = 8, 2, 3, 4, 4
    upd = rand_unitaries(rng, n, il, m, d, d)
    us = rand_unitaries(rng, m, d, d)
    ks = rng.standard_normal((n, il, m, d, d)) + 0j
    w = rng.random(n)
    jt = jtopo.Topology(pods, assignment)
    tt = topology.Topology(pods, assignment)

    def t(x):
        return torch.as_tensor(x)[None]       # a stack of one session
    if name == "pod_products":
        want = jhier.pod_products(jnp.asarray(upd), jt)
        got = hierarchy.pod_products(t(upd), tt)
    elif name == "merge_products":
        parts = rand_unitaries(rng, pods, il, m, d, d)
        want = jhier.merge_products(jnp.asarray(parts))
        got = hierarchy.merge_products(t(parts))
    elif name == "tree_chain":
        want = jhier.tree_chain(jnp.asarray(us), jnp.asarray(upd), jt)
        got = hierarchy.tree_chain(t(us), t(upd), tt)
    else:
        want = jhier.tree_mean_generators(jnp.asarray(ks), jnp.asarray(w),
                                          jt)
        got = hierarchy.tree_mean_generators(t(ks), t(w), tt)
    assert got.shape[0] == 1 and got.shape[1:] == want.shape
    assert max_dev([got[0]], [want]) <= TOL


def test_tree_groups_pods_inside_each_session():
    """Two sessions stacked: each session's tree is its own solo tree
    (one session's pods never mix with another's)."""
    rng = np.random.default_rng(4)
    tt = topology.Topology(2, "strided")
    ks = torch.as_tensor(rng.standard_normal((2, 4, 1, 2, 4, 4)) + 0j)
    w = torch.as_tensor(rng.random((2, 4)))
    upd = torch.as_tensor(rand_unitaries(rng, 2, 4, 1, 2, 4, 4))
    us = torch.as_tensor(rand_unitaries(rng, 2, 2, 4, 4))
    both = hierarchy.tree_mean_generators(ks, w, tt)
    chain = hierarchy.tree_chain(us, upd, topology.Topology(2))
    for s in range(2):
        assert torch.equal(both[s], hierarchy.tree_mean_generators(
            ks[s:s + 1], w[s:s + 1], tt)[0])
        assert torch.equal(chain[s], hierarchy.tree_chain(
            us[s:s + 1], upd[s:s + 1], topology.Topology(2))[0])


def test_partial_fn_dispatch():
    assert hierarchy.partial_fn(strategies.get_aggregation("product")) \
        is hierarchy.pod_products
    for name in ("average", "served"):
        assert hierarchy.partial_fn(strategies.get_aggregation(name)) \
            is hierarchy.pod_generators
    odd = strategies.Aggregation("odd", combine="median")
    with pytest.raises(ValueError) as got:
        hierarchy.partial_fn(odd)
    with pytest.raises(ValueError) as want:
        jhier.partial_fn(jstrategies.Aggregation("odd", combine="median"))
    assert str(got.value) == str(want.value)


# ------------------------------------------------- rounds, port alone
@functools.lru_cache(maxsize=None)
def port_setup():
    """The reference cohort tests' round shape on the port's own data:
    N = 8 nodes of 3 pairs, N_p = 4, I_l = 2, eps 0.05."""
    _, ds, test = qdata.make_federated_dataset(
        torch.Generator().manual_seed(0), 2, 8, 3, n_test=4, device="cpu")
    params = qnn.init_params(torch.Generator().manual_seed(1), WIDTHS,
                             device="cpu")
    return params, ds, test


def port_cfg(**kw):
    return fed.QuantumFedConfig(**{**dict(
        widths=WIDTHS, num_nodes=8, nodes_per_round=4, interval_length=2,
        eps=0.05), **kw})


def gen(seed=2):
    return torch.Generator().manual_seed(seed)


ROUND_CASES = {
    "product": dict(aggregation="product"),
    "average": dict(aggregation="average"),
    "average_strided": dict(aggregation="average",
                            pod_assignment="strided"),
    "screen_product": dict(aggregation="product", defense="screen",
                           screen_tol=0.5),
    "clip_average": dict(aggregation="average", defense="clip",
                         clip_norm=0.5),
    "momentum_average": dict(aggregation="average"),
    "noisy_average": dict(aggregation="average", upload_noise=0.02),
    "minibatch_product": dict(aggregation="product", minibatch=2),
}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_two_level_round_matches_flat(case, impl, monkeypatch):
    """Same params, data and generator: the two-level round (pods = 2)
    is the flat round reassociated. Three rounds with server momentum
    (its state carried) for the momentum case. The tree's entry points
    are counted, so a round that ignored the topology would fail."""
    calls = []
    for name in ("tree_chain", "tree_mean_generators"):
        orig = getattr(hierarchy, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(hierarchy, name, counted)
    params, ds, test = port_setup()
    kw = dict(ROUND_CASES[case])
    assignment = kw.pop("pod_assignment", "block")
    flat_cfg = port_cfg(impl=impl, **kw)
    tree_cfg = flat_cfg._replace(topology="two_level", pods=2,
                                 pod_assignment=assignment)
    server_opt = "momentum" if case.startswith("momentum") else "none"
    probe = test if kw.get("defense") == "screen" else None
    out = {}
    for label, cfg in (("flat", flat_cfg), ("tree", tree_cfg)):
        p, m = params, None
        for r in range(3 if server_opt != "none" else 1):
            p, m = fed.server_round_opt(p, m, ds, gen(2 + r), cfg,
                                        server_opt=server_opt,
                                        server_beta=0.8, probe=probe)
        out[label] = list(p) + ([] if m is None else list(m))
        if label == "flat":
            assert calls == []
    assert calls and set(calls) == {
        "tree_chain" if flat_cfg.aggregation == "product"
        else "tree_mean_generators"}
    tol = TOL if impl == "xla" else KERNEL_TOL
    assert max_dev(out["flat"], out["tree"]) <= tol


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_two_level_aggregate_phase_takes_any_pod_multiple(aggregation):
    """An async commit aggregates K uploads of a cohort: under the tree
    K must still split into the pods (the spec checks the commit size),
    and the tree then equals the flat combine of the same K uploads."""
    params, ds, _ = port_setup()
    cfg = port_cfg(aggregation=aggregation, nodes_per_round=6,
                   topology="two_level", pods=2)
    ks = fed.local_phase(params, ds, torch.arange(6), gen(), cfg)
    w = torch.full((4,), 0.25)
    flat = fed.aggregate_phase(params, [k[:4] for k in ks], w,
                               cfg._replace(topology="flat", pods=None))[0]
    tree = fed.aggregate_phase(params, [k[:4] for k in ks], w, cfg)[0]
    assert max_dev(flat, tree) <= TOL
    with pytest.raises(ValueError, match="equal pods"):
        fed.aggregate_phase(params, [k[:3] for k in ks], w[:3], cfg)


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_two_level_stacked_round_matches_solo(aggregation):
    """Three sessions with their own data, params, eta and eps through
    one two-level ``server_round_stacked``: each equals its solo
    two-level round."""
    sess = []
    for s in range(3):
        _, ds, _ = qdata.make_federated_dataset(
            torch.Generator().manual_seed(10 + s), 2, 8, 3, n_test=4,
            device="cpu")
        sess.append((qnn.init_params(torch.Generator().manual_seed(20 + s),
                                     WIDTHS, device="cpu"), ds))
    cfg = port_cfg(aggregation=aggregation, topology="two_level", pods=2)
    eta, eps = [0.5, 1.0, 1.5], [0.05, 0.1, 0.2]
    params = [torch.stack(x) for x in zip(*[p for p, _ in sess])]
    sds = qdata.QuantumDataset(torch.stack([d.phi_in for _, d in sess]),
                               torch.stack([d.phi_out for _, d in sess]))
    got, _, _ = fed.server_round_stacked(
        params, sds, [gen(30 + s) for s in range(3)], cfg,
        eta=torch.tensor(eta, dtype=torch.float64),
        eps=torch.tensor(eps, dtype=torch.float64))
    for s, (p, ds) in enumerate(sess):
        want = fed.server_round(p, ds, gen(30 + s),
                                cfg._replace(eta=eta[s], eps=eps[s]))
        assert max_dev([x[s] for x in got], want) <= TOL


# ------------------------------------------------- the port vs the reference
@functools.lru_cache(maxsize=None)
def ref_setup():
    """The reference's cohort round data (built under x64 by the first
    caller), converted for the port."""
    _, ds, _ = jdata.make_federated_dataset(jax.random.PRNGKey(0), 2,
                                            num_nodes=8, n_per_node=3,
                                            n_test=4)
    params = jqnn.init_params(jax.random.PRNGKey(1), WIDTHS)
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), None, "cpu")
    tparams = convert.params_to_torch([np.asarray(p) for p in params],
                                      "cpu")
    return (params, ds), (tparams, tds)


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_two_level_round_matches_reference(x64, aggregation):
    """Full participation and GD: the round draws nothing, so the port
    and the reference aggregate the same uploads under the same tree."""
    (jparams, jds), (tparams, tds) = ref_setup()
    base = dict(widths=WIDTHS, num_nodes=8, nodes_per_round=8,
                interval_length=2, eps=0.05, aggregation=aggregation,
                participation="full", topology="two_level", pods=4)
    want = jfed.server_round(jparams, jds, jax.random.PRNGKey(2),
                             jfed.QuantumFedConfig(**base))
    got = fed.server_round(tparams, tds, gen(), fed.QuantumFedConfig(**base))
    assert max_dev(got, want) <= TOL


def _error(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the error is the result
        return type(e), str(e)
    return None


def test_strided_product_error_equals_reference(x64):
    """The strided product is refused with the reference's error, by the
    round and by the spec."""
    (jparams, jds), (tparams, tds) = ref_setup()
    base = dict(widths=WIDTHS, num_nodes=8, nodes_per_round=4,
                interval_length=2, eps=0.05, aggregation="product",
                topology="two_level", pods=2, pod_assignment="strided")
    want = _error(lambda: jfed.server_round(
        jparams, jds, jax.random.PRNGKey(0), jfed.QuantumFedConfig(**base)))
    got = _error(lambda: fed.server_round(tparams, tds, gen(),
                                          fed.QuantumFedConfig(**base)))
    assert want is not None and want[0] is ValueError
    assert "product chain" in want[1]
    assert got == want
    spec_kw = dict(num_nodes=8, nodes_per_round=4, n_per_node=2, n_test=2,
                   topology="two_level", pods=2, pod_assignment="strided")
    assert _error(lambda: api.FedSpec.quantum(WIDTHS, **spec_kw)) == \
        _error(lambda: japi.FedSpec.quantum(WIDTHS, **spec_kw))


RANKS = """
from repro_torch.core.fed.cohort import hierarchy
from repro_torch.core.quantum import federated as fed
from repro_torch.core.quantum.data import QuantumDataset
case = torch.load(OUT + "/in.pt", weights_only=False)
mesh = host_mesh((WORLD,), ("pod",))
calls = {"pod_tier": 0}
tier = hierarchy._pod_tier

def counted(body, grouped, mesh_, topo):
    calls["pod_tier"] += hierarchy._shard_axis(mesh_, topo) == "pod"
    return tier(body, grouped, mesh_, topo)
hierarchy._pod_tier = counted
out, spread = [], []
with mesh:
    for kw in case["cfgs"]:
        calls["pod_tier"] = 0
        out.append(fed.server_round(
            case["params"], QuantumDataset(*case["dataset"]),
            torch.Generator().manual_seed(2), fed.QuantumFedConfig(**kw)))
        spread.append(calls["pod_tier"])
torch.save((out, spread), f"{OUT}/rank{RANK}.pt")
mesh_lib.close()
"""


def tree_base(aggregation):
    return dict(widths=WIDTHS, num_nodes=8, nodes_per_round=8,
                interval_length=2, eps=0.05, aggregation=aggregation,
                participation="full", topology="two_level", pods=4)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-level round of both combines with fanout="shard_map" on
    two gloo ranks: each rank runs 4 of the 8 nodes and 2 of the 4 pods'
    partials. {aggregation: ((rank 0's params, rank 1's), the pod tiers
    each rank spread)}."""
    from torch_ranks import run_ranks
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        _, (tparams, tds) = ref_setup()
    finally:
        jax.config.update("jax_enable_x64", prev)
    tmp = tmp_path_factory.mktemp("ranks")
    aggs = ("product", "average")
    torch.save({"params": tparams, "dataset": tuple(tds),
                "cfgs": [dict(tree_base(a), fanout="shard_map")
                         for a in aggs]}, tmp / "in.pt")
    run_ranks(RANKS, 2, tmp)
    outs = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return {a: (tuple(out[i] for out, _ in outs),
                [spread[i] for _, spread in outs])
            for i, a in enumerate(aggs)}


@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_two_level_shard_map_on_two_ranks_matches_reference(
        x64, two_ranks, aggregation):
    """The node pass and the pod tier spread over two ranks: the
    reference's vmap round to 1e-10, the same bits on both ranks."""
    (jparams, jds), _ = ref_setup()
    want = jfed.server_round(jparams, jds, jax.random.PRNGKey(2),
                             jfed.QuantumFedConfig(**tree_base(aggregation)))
    (rank0, rank1), spread = two_ranks[aggregation]
    assert spread == [2, 2]           # one pod tier a layer, on each rank
    assert all(torch.equal(a, b) for a, b in zip(rank0, rank1))
    assert max_dev(rank0, want) <= TOL


# ------------------------------------------------- sessions
def _tree_spec(**kw):
    base = dict(num_nodes=8, nodes_per_round=4, interval_length=1,
                n_per_node=2, n_test=2, topology="two_level", pods=2)
    base.update(kw)
    return api.FedSpec.quantum(WIDTHS, **base)


@pytest.mark.parametrize("schedule", ["sync", "async"])
def test_two_level_session_runs_and_resumes(tmp_path, schedule):
    """A two-level session steps, checkpoints and resumes bit-exactly
    (the topology rides the spec); under async the commit of K = 2 of
    N_p = 4 splits into the pods and the cut leaves uploads in flight."""
    kw = dict(aggregation="average")
    if schedule == "async":
        kw.update(schedule="async", async_commit=2)
    spec = _tree_spec(**kw)
    straight = api.FederationSession.create(spec, 1, device="cpu")
    straight.run(3)
    killed = api.FederationSession.create(spec, 1, device="cpu")
    killed.run(2)
    path = str(tmp_path / "tree.npz")
    killed.save(path)
    resumed = api.FederationSession.resume(path, device="cpu")
    assert resumed.spec.topology == "two_level"
    resumed.run(1)
    assert all(torch.equal(a, b) for a, b in zip(resumed.state,
                                                  straight.state))
    flat = api.FederationSession.create(
        dataclasses.replace(spec, topology="flat", pods=None), 1,
        device="cpu")
    flat.run(3)
    assert max_dev(flat.state, straight.state) <= TOL


def test_two_level_overlapped_session_matches_flat():
    spec = _tree_spec(aggregation="product", schedule="overlapped")
    tree = api.FederationSession.create(spec, 3, device="cpu")
    flat = api.FederationSession.create(
        dataclasses.replace(spec, topology="flat", pods=None), 3,
        device="cpu")
    tree.run(3)
    flat.run(3)
    assert max_dev(flat.state, tree.state) <= TOL
