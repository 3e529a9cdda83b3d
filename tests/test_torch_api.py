"""The port's federation front door (``repro_torch.core.fed.api``) and the
modules it copies (``core/fed/config.py``, ``cohort/latency.py``,
``cohort/topology.py``) against the JAX reference.

``FedSpec`` is held field for field: the same validation errors (type
and message) on the same bad specs, the same JSON and ``fingerprint``,
the committed spec files loading unchanged, the same legacy configs.
The latency models are numpy on both sides and agree bit for bit. The
sessions themselves are held in ``test_torch_schedulers.py`` and
``test_torch_checkpoint.py``."""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.fed import FederatedConfig as JFederatedConfig  # noqa: E402
from repro.core.fed import api as japi  # noqa: E402
from repro.core.fed.cohort import latency as jlatency  # noqa: E402
from repro.core.fed.cohort import topology as jtopology  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro_torch.core.fed import FederatedConfig, api  # noqa: E402
from repro_torch.core.fed.cohort import latency, topology  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SPECS = os.path.join(ROOT, "benchmarks", "specs")
LAT_TRACE = os.path.join(ROOT, "benchmarks", "traces", "tiny_lognormal.json")
QBASE = dict(widths=(2, 2), num_nodes=4, nodes_per_round=2,
             interval_length=2, eps=0.1, n_per_node=3, n_test=4, data_seed=5)

# bad quantum specs (overrides of QBASE), one per validation rule
BAD_QUANTUM = {
    "aggregation": dict(aggregation="majority-vote"),
    "participation": dict(participation="round-robin"),
    "participation_method": dict(participation_method="x"),
    "defense_unknown": dict(defense="krum"),
    "defense_vs_product": dict(defense="median"),
    "screen_vs_average": dict(aggregation="average", defense="screen"),
    "two_channels": dict(upload_noise=0.1, quantize_bits=8),
    "quantize_bits_low": dict(quantize_bits=0),
    "quantize_bits_high": dict(quantize_bits=40),
    "schedule": dict(schedule="gossip"),
    "server_opt": dict(server_opt="adamw"),
    "topology": dict(topology="ring"),
    "pods_flat": dict(pods=2),
    "two_level_no_pods": dict(topology="two_level"),
    "pods_divide": dict(topology="two_level", pods=3),
    "strided_product": dict(topology="two_level", pods=2,
                            pod_assignment="strided"),
    "pod_assignment": dict(pod_assignment="x"),
    "two_level_async": dict(topology="two_level", pods=2, schedule="async",
                            async_commit=1),
    "latency_model": dict(latency_model="weibull"),
    "latency_trace_alone": dict(latency_trace="x.json"),
    "latency_sigma": dict(latency_model="lognormal", latency_sigma=0.0),
    "latency_alpha": dict(latency_model="pareto", latency_alpha=1.0),
    "latency_trace_missing": dict(latency_model="trace"),
    "latency_trace_file": dict(latency_model="trace",
                               latency_trace="/nonexistent/trace.json"),
    "fault_model": dict(fault_model="meteor"),
    "fault_rate_alone": dict(fault_rate=0.1),
    "fault_scale": dict(fault_model="crash", fault_rate=0.1,
                        fault_scale=0.0),
    "slow_without_timeline": dict(fault_model="slow", fault_rate=0.1),
    "fault_rate_zero": dict(fault_model="crash"),
    "fault_trace_alone": dict(fault_trace="x"),
    "fault_trace_missing": dict(fault_model="trace"),
    "trim_frac": dict(aggregation="average", defense="trimmed_mean",
                      trim_frac=0.5),
    "clip_norm": dict(aggregation="average", defense="clip", clip_norm=0.0),
    "screen_tol": dict(defense="screen", screen_tol=-1.0),
    "round_deadline": dict(round_deadline=0.0),
    "overlapped_deadline": dict(schedule="overlapped", round_deadline=1.0),
    "max_retries": dict(max_retries=-1),
    "retry_backoff": dict(retry_backoff=0.5),
    "min_participants_low": dict(min_participants=0),
    "min_participants_high": dict(min_participants=3),
    "server_opt_product": dict(server_opt="momentum"),
    "server_momentum": dict(aggregation="average", server_opt="momentum",
                            server_momentum=1.5),
    "async_commit": dict(schedule="async", async_commit=7),
    "staleness_decay": dict(schedule="async", staleness_decay=0.0),
    "nodes_per_round": dict(nodes_per_round=9),
    "interval_length": dict(interval_length=0),
    "dropout_rate": dict(dropout_rate=1.5),
    "node_sizes_len": dict(node_sizes=(1, 2)),
    "node_sizes_positive": dict(node_sizes=(1, 2, 0, 1)),
    "full": dict(participation="full"),
    "widths_short": dict(widths=(2,)),
    "widths_positive": dict(widths=(2, 0)),
    "engine": dict(engine="tensor-network"),
    "impl": dict(impl="triton"),
    "fanout": dict(fanout="pmap"),
    "minibatch": dict(minibatch=0),
    "rank_engine": dict(engine="dense", rank_cap=2),
    "ensemble_dtype": dict(ensemble_dtype="f16"),
    "rank_tol": dict(rank_tol=1.5),
    "rank_cap": dict(rank_cap=0),
}
BAD_CLASSICAL = {
    "two_level": dict(topology="two_level", pods=2),
    "product": dict(aggregation="product"),
    "upload_noise": dict(upload_noise=0.1),
    "rank_tol": dict(rank_tol=0.1),
}

# specs that exercise every field family, for JSON and fingerprints
GOOD = {
    "quantum": lambda m: m.FedSpec.quantum(**QBASE),
    "quantum_rich": lambda m: m.FedSpec.quantum(
        **dict(QBASE, node_sizes=(2, 3, 4, 5), upload_noise=0.5,
               participation="dropout", dropout_rate=0.25,
               schedule="async", async_commit=2, staleness_decay=0.75,
               latency_model="pareto", latency_alpha=2.5,
               fault_model="sign_flip", fault_rate=0.3, fault_seed=4,
               round_deadline=2.0, max_retries=3, engine="local",
               impl="pallas", rank_tol=1e-3, rank_cap=4)),
    "quantum_defended": lambda m: m.FedSpec.quantum(
        **dict(QBASE, aggregation="average", defense="trimmed_mean",
               trim_frac=0.3, server_opt="nesterov", server_momentum=0.5,
               quantize_bits=6)),
    "classical": lambda m: m.FedSpec.classical(
        arch="qwen1.5-4b", n_layers=1, num_nodes=3, nodes_per_round=2,
        aggregation="served", seq_len=16, data_seed=3),
}


def _error(make):
    try:
        make()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(BAD_QUANTUM))
def test_quantum_spec_validation_matches_reference(case):
    kw = dict(QBASE, **BAD_QUANTUM[case])
    want = _error(lambda: japi.FedSpec.quantum(**kw))
    assert want is not None
    assert _error(lambda: api.FedSpec.quantum(**kw)) == want


@pytest.mark.parametrize("case", sorted(BAD_CLASSICAL) + ["substrate"])
def test_classical_spec_validation_matches_reference(case):
    if case == "substrate":
        def make(m):
            return m.FedSpec(substrate="analog")
    else:
        def make(m):
            return m.FedSpec.classical(arch="qwen1.5-4b",
                                       **BAD_CLASSICAL[case])
    want = _error(lambda: make(japi))
    assert want is not None
    assert _error(lambda: make(api)) == want


def test_from_json_validates_like_the_reference():
    blob = api.FedSpec.quantum(**QBASE).to_json_dict()
    for field, bad in (("schedule", "gossip"), ("n_qubits", 7),
                       ("version", api.SPEC_VERSION + 1)):
        d = dict(blob, **{field: bad})
        assert _error(lambda: api.FedSpec.from_json(d)) == _error(
            lambda: japi.FedSpec.from_json(d))
        assert _error(lambda: api.FedSpec.from_json(d)) is not None


@pytest.mark.parametrize("name", sorted(GOOD))
def test_spec_json_and_fingerprint_match_reference(name):
    spec, ref = GOOD[name](api), GOOD[name](japi)
    assert spec.to_json() == ref.to_json()
    assert spec.fingerprint() == ref.fingerprint()
    again = api.FedSpec.from_json(spec.to_json())
    assert again == spec
    assert again.fingerprint() == spec.fingerprint()
    assert isinstance(again.widths, (tuple, type(None)))
    # a spec written by the reference reads back as the same spec here
    assert api.FedSpec.from_json(ref.to_json()) == spec


@pytest.mark.parametrize("fname", ["quantum_tiny.json",
                                   "classical_tiny.json"])
def test_committed_spec_files_load_unchanged(fname):
    with open(os.path.join(SPECS, fname)) as f:
        raw = json.load(f)
    spec = api.FedSpec.from_json(raw)
    ref = japi.FedSpec.from_json(raw)
    assert spec.to_json_dict() == ref.to_json_dict()
    assert spec.fingerprint() == ref.fingerprint()
    # every field the file names keeps its value
    for k, v in raw.items():
        got = spec.to_json_dict()[k]
        assert got == v, k


def test_fingerprint_groups_as_the_reference_does():
    a = api.FedSpec.quantum(**QBASE)
    same = dataclasses.replace(a, eta=0.5, eps=0.2, data_seed=9,
                               latency_seed=3)
    other = dataclasses.replace(a, interval_length=3)
    assert a.fingerprint() == same.fingerprint()
    assert a.fingerprint() != other.fingerprint()
    ja = japi.FedSpec.quantum(**QBASE)
    assert dataclasses.replace(ja, eta=0.5, eps=0.2, data_seed=9,
                               latency_seed=3).fingerprint() == \
        same.fingerprint()


def test_quantum_config_is_the_reference_config_field_for_field():
    spec = api.FedSpec.quantum(**dict(
        QBASE, aggregation="average", defense="clip", clip_norm=0.5,
        minibatch=2, engine="dense", impl="pallas", participation="weighted",
        fanout="vmap", quantize_bits=8))
    cfg = spec.to_quantum_config()
    ref = japi.FedSpec.from_json(spec.to_json()).to_quantum_config()
    assert isinstance(cfg, fed.QuantumFedConfig)
    assert cfg._asdict() == ref._asdict()
    assert api.FedSpec.from_quantum_config(cfg).to_quantum_config() == cfg
    assert fed.QuantumFedConfig._fields == jfed.QuantumFedConfig._fields


def test_classical_config_is_the_reference_config():
    ccfg = FederatedConfig(num_nodes=5, nodes_per_round=3,
                           interval_length=2, aggregation="served",
                           participation="dropout", dropout_rate=0.3,
                           outer_lr=0.7, delta_dtype="bfloat16")
    jcfg = JFederatedConfig(**dataclasses.asdict(ccfg))
    spec = api.FedSpec.from_classical_config(ccfg, arch="qwen1.5-4b")
    assert spec.to_classical_config() == ccfg
    assert dataclasses.asdict(
        japi.FedSpec.from_classical_config(jcfg, arch="qwen1.5-4b")
        .to_classical_config()) == dataclasses.asdict(ccfg)
    assert [f.name for f in dataclasses.fields(FederatedConfig)] == \
        [f.name for f in dataclasses.fields(JFederatedConfig)]
    with pytest.raises(ValueError, match="quantization"):
        api.FedSpec.classical(arch="qwen1.5-4b",
                              quantize_bits=8).to_classical_config()


def test_classical_spec_constructs_and_its_substrate_is_refused():
    """A classical spec builds its substrate: ``make_substrate`` returns a
    ``ClassicalSubstrate`` on the device asked for, as the constructor
    does; a quantum spec is refused by it (the sessions themselves are
    held in ``test_torch_fed_classical.py``)."""
    spec = api.FedSpec.classical(arch="qwen1.5-4b", n_layers=1)
    assert spec.substrate == "classical"
    for make in (lambda: api.make_substrate(spec, device="cpu"),
                 lambda: api.ClassicalSubstrate(spec, device="cpu")):
        sub = make()
        assert isinstance(sub, api.ClassicalSubstrate)
        assert sub.device.type == "cpu" and sub.cfg.n_layers == 1
    with pytest.raises(ValueError, match="classical spec"):
        api.ClassicalSubstrate(api.FedSpec.quantum(**QBASE), device="cpu")


def test_two_level_spec_is_refused_by_the_port_round():
    """The two-level spec is no longer refused: its substrate builds and
    its session rounds equal the flat spec's (the tree reassociates the
    Eq. 6 chain). The mesh fan-out is no longer refused either: its
    substrate builds, and its round outside a mesh raises the
    reference's ValueError."""
    spec = api.FedSpec.quantum(**dict(QBASE, topology="two_level", pods=2))
    flat = api.FedSpec.quantum(**QBASE)
    tree = api.FederationSession.create(spec, 4, device="cpu")
    ref = api.FederationSession.create(flat, 4, device="cpu")
    tree.run(2)
    ref.run(2)
    assert max(float((a - b).abs().max())
               for a, b in zip(tree.state, ref.state)) <= 1e-10
    mesh = api.FedSpec.quantum(**dict(QBASE, topology="two_level", pods=2,
                                      fanout="shard_map"))
    api.QuantumSubstrate(mesh, device="cpu")
    sess = api.FederationSession.create(mesh, 4, device="cpu")
    with pytest.raises(ValueError, match="needs an active `with mesh:`"):
        sess.run(1)


def test_api_exports_the_reference_names():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and n not in ("phases", "scheduler", "session", "spec",
                              "substrate", "rng")}
    assert public(api) == public(japi)


def test_api_entry_points_default_to_the_card(tmp_path):
    from repro_torch import checkpoint as ckpt
    spec = api.FedSpec.quantum(**QBASE)
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"a": torch.zeros(2)})
    calls = [lambda: api.QuantumSubstrate(spec).dataset.phi_in,
             lambda: api.make_substrate(spec).test[0],
             lambda: api.FederationSession.create(spec, 0).state[0],
             lambda: ckpt.restore(path)[0]["a"]]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


# ---------------------------------------------------------------- cohort
LAT_SPECS = {
    "counter": dict(latency_seed=3),
    "lognormal": dict(latency_model="lognormal", latency_seed=5,
                      latency_mu=0.2, latency_sigma=0.7),
    "pareto": dict(latency_model="pareto", latency_seed=7,
                   latency_alpha=1.8),
    "trace": dict(latency_model="trace", latency_trace=LAT_TRACE),
}


@pytest.mark.parametrize("model", sorted(LAT_SPECS))
def test_latency_models_match_reference_bit_for_bit(model):
    kw = dict(QBASE, schedule="async", **LAT_SPECS[model])
    mine = latency.make_model(api.FedSpec.quantum(**kw))
    ref = jlatency.make_model(japi.FedSpec.quantum(**kw))
    assert mine.name == ref.name == model
    for node in (0, 1, 5, 17, 999):
        for dispatch in (0, 1, 2, 9, 40, 12345):
            a, b = mine(node, dispatch), ref(node, dispatch)
            assert type(a) is type(b)
            assert a == b and a > 0.0


def test_latency_trace_errors_match_reference(tmp_path):
    for name, body in (("not_obj", "[1, 2]"), ("empty", '{"clients": []}'),
                       ("row", '{"clients": [[]]}'),
                       ("neg", '{"clients": [[1.0, -2.0]]}')):
        p = str(tmp_path / f"{name}.json")
        with open(p, "w") as f:
            f.write(body)
        want = _error(lambda: jlatency.load_trace(p))
        assert want is not None
        assert _error(lambda: latency.load_trace(p)) == want


def test_topology_matches_reference():
    for n, pods in ((4, 2), (6, 3), (8, 4)):
        for a in topology.ASSIGNMENTS:
            np.testing.assert_array_equal(topology.pod_perm(n, pods, a),
                                          jtopology.pod_perm(n, pods, a))
    assert topology.resolve_topology("flat", None) is None
    t = topology.resolve_topology("two_level", 2, "strided")
    jt = jtopology.resolve_topology("two_level", 2, "strided")
    assert (t.pods, t.assignment) == (jt.pods, jt.assignment)
    assert t.pod_size(6) == jt.pod_size(6)
    assert _error(lambda: t.pod_size(5)) == _error(lambda: jt.pod_size(5))
    assert _error(lambda: topology.pod_perm(5, 2, "block")) == _error(
        lambda: jtopology.pod_perm(5, 2, "block"))
