"""The port's schedulers and sessions (``repro_torch.core.fed.api``)
against the JAX reference's, round for round (x64, widths (2,3,2), N=5).

The port keys its rounds with its own counter-based streams, so the two
packages meet exactly only where a round draws nothing:
``participation="full"``, GD and the identity channel. Under those
conditions both sessions start from the reference's params, dataset and
test pairs (through ``repro_torch.convert``) and run the same rounds:
sync, overlapped and async (the latency streams are numpy on both sides
and the simulated clocks agree bit for bit), and faulted sync with a
round deadline that forces retries (the same survivors and retries).
impl="xla" agrees with the reference to <= 1e-10, impl="pallas" (the
kernels' fp32 plain versions on the CPU) to <= 1e-5. The phase
composition equals the fused round inside the port, with its draws."""
import dataclasses
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import api as japi  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fed import api  # noqa: E402
from repro_torch.core.fed.api import phases, scheduler  # noqa: E402

TOLS = {"xla": 1e-10, "pallas": 1e-5}
WIDTHS, N, ROUNDS = (2, 3, 2), 5, 4
LAT_TRACE = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                         "traces", "tiny_lognormal.json")
FULL = dict(widths=WIDTHS, num_nodes=N, nodes_per_round=N,
            participation="full", interval_length=2, eps=0.1)
# faults + a deadline (the sync retry path); crash and slow force at
# least one retry in 4 rounds at this deadline (min_participants=3)
FAULTED = {
    "crash": dict(fault_model="crash", fault_rate=0.3, fault_seed=2,
                  round_deadline=1.5, min_participants=3),
    "slow": dict(fault_model="slow", fault_rate=0.3, fault_seed=1,
                 fault_scale=4.0, round_deadline=1.5, min_participants=3),
    "sign_flip_median": dict(fault_model="sign_flip", fault_rate=0.2,
                             fault_seed=1, fault_scale=5.0,
                             round_deadline=1.5, aggregation="average",
                             defense="median"),
}


@functools.lru_cache(maxsize=None)
def reference_data():
    """The reference's dataset, test pairs and params (callers run x64),
    and the same arrays in the port on the CPU."""
    _, ds, test = jdata.make_federated_dataset(
        jax.random.PRNGKey(3), WIDTHS[0], num_nodes=N, n_per_node=3,
        n_test=6)
    params = jqnn.init_params(jax.random.PRNGKey(4), WIDTHS)
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), None, "cpu")
    ttest = tuple(convert.states_to_torch(np.asarray(x), "cpu")
                  for x in test)
    tparams = convert.params_to_torch([np.asarray(p) for p in params],
                                      "cpu")
    return (ds, test, params), (tds, ttest, tparams)


def sessions(**kw):
    """The same spec as a reference session and a port session, each
    from the reference's arrays."""
    (ds, test, params), (tds, ttest, tparams) = reference_data()
    jspec = japi.FedSpec.quantum(**dict(FULL, **kw))
    spec = api.FedSpec.quantum(**dict(FULL, **kw))
    jsess = japi.FederationSession.create(
        jspec, jax.random.PRNGKey(0), params=params,
        substrate=japi.QuantumSubstrate(jspec, dataset=ds, test=test))
    sess = api.FederationSession.create(
        spec, 0, params=tparams,
        substrate=api.QuantumSubstrate(spec, dataset=tds, test=ttest,
                                       device="cpu"))
    return jsess, sess


def params_of(state):
    return state["params"] if isinstance(state, dict) else state


def max_err(tstate, jstate):
    return max(float(np.max(np.abs(t.resolve_conj().numpy()
                                   - np.asarray(j))))
               for t, j in zip(params_of(tstate), params_of(jstate)))


def host(metrics):
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("schedule", ["sync", "overlapped", "async"])
def test_session_matches_reference(x64, schedule, impl):
    kw = dict(schedule=schedule)
    if schedule == "async":
        kw.update(async_commit=2, latency_seed=4)
    jsess, sess = sessions(impl=impl, **kw)
    for _ in range(ROUNDS):
        jm, m = jsess.step(), sess.step()
        assert host(m) == host(jm)
        assert max_err(sess.state, jsess.state) <= TOLS[impl]
    assert sess.round == jsess.round == ROUNDS
    ev, jev = sess.evaluate(), jsess.evaluate()
    assert ev.keys() == jev.keys()
    assert max(abs(ev[k] - jev[k]) for k in ev) <= TOLS[impl]
    sess.flush()
    jsess.flush()
    assert max_err(sess.state, jsess.state) <= TOLS[impl]


@pytest.mark.parametrize("model", ["counter", "lognormal", "pareto",
                                   "trace"])
def test_async_timeline_matches_reference_bit_for_bit(x64, model):
    kw = {"counter": dict(latency_seed=7),
          "lognormal": dict(latency_model="lognormal", latency_seed=2,
                            latency_sigma=0.8),
          "pareto": dict(latency_model="pareto", latency_seed=5,
                         latency_alpha=1.6),
          "trace": dict(latency_model="trace",
                        latency_trace=LAT_TRACE)}[model]
    jsess, sess = sessions(schedule="async", async_commit=3, **kw)
    for _ in range(3):
        jsess.step()
        sess.step()
        assert sess.sim_clock == jsess.sim_clock
        mine = [(e["arrival"], e["version"], e["weight"], e["node"],
                 e["born"]) for e in sess.scheduler.entries]
        ref = [(e["arrival"], e["version"], e["weight"], e["node"],
                e["born"]) for e in jsess.scheduler.entries]
        assert mine == ref
    assert sess.scheduler.dispatched == jsess.scheduler.dispatched
    assert max_err(sess.state, jsess.state) <= TOLS["xla"]


@pytest.mark.parametrize("case", sorted(FAULTED))
def test_faulted_sync_with_deadline_matches_reference(x64, case):
    jsess, sess = sessions(**FAULTED[case])
    assert isinstance(sess.scheduler, api.SyncScheduler)
    assert sess.scheduler.robust
    retries = 0
    for _ in range(ROUNDS):
        jm, m = jsess.step(), sess.step()
        assert host(m) == host(jm)
        retries += m["n_retries"]
        assert max_err(sess.state, jsess.state) <= TOLS["xla"]
    if case != "sign_flip_median":
        assert retries >= 1


def test_faulted_async_matches_reference(x64):
    jsess, sess = sessions(schedule="async", async_commit=2,
                           fault_model="crash", fault_rate=0.3,
                           fault_seed=2, round_deadline=1.0)
    for _ in range(ROUNDS):
        jm, m = jsess.step(), sess.step()
        assert host(m) == host(jm)
        assert max_err(sess.state, jsess.state) <= TOLS["xla"]


def test_retries_exhausted_fail_loud_as_the_reference():
    spec = api.FedSpec.quantum(**dict(FULL, fault_model="crash",
                                      fault_rate=1.0, n_per_node=2,
                                      n_test=2))
    sess = api.FederationSession.create(spec, 0, device="cpu")
    with pytest.raises(RuntimeError, match="min_participants"):
        sess.step()
    assert sess.round == 0
    aspec = dataclasses.replace(spec, schedule="async", async_commit=2)
    with pytest.raises(RuntimeError, match="starved"):
        api.FederationSession.create(aspec, 0, device="cpu").step()


# ------------------------------------------- the port's own randomness
def uniform_spec(**kw):
    base = dict(widths=(2, 2), num_nodes=4, nodes_per_round=2,
                interval_length=2, eps=0.1, n_per_node=3, n_test=4,
                data_seed=5)
    base.update(kw)
    return api.FedSpec.quantum(**base)


@pytest.mark.parametrize("kw", [
    {}, dict(minibatch=2, upload_noise=0.1),
    dict(aggregation="average", quantize_bits=6, server_opt="momentum"),
    dict(rank_tol=1e-3, rank_cap=2)],
    ids=["plain", "minibatch_noise", "quantize_momentum", "certified"])
def test_compose_round_equals_run_round(kw):
    spec = uniform_spec(**kw)
    sub = api.QuantumSubstrate(spec, device="cpu")
    state = sub.init_state(11)
    fused, fm = sub.run_round(state, 12, 0)
    composed, cm = phases.compose_round(sub, state, 12, 0)
    for a, b in zip(params_of(fused), params_of(composed)):
        assert float((a - b).abs().max()) <= TOLS["xla"]
    assert fm.keys() == cm.keys()
    for k in fm:
        assert abs(float(fm[k]) - float(cm[k])) <= TOLS["xla"]


def test_sync_matches_the_bare_round_loop():
    """schedule='sync' == state <- run_round(state, round_key(t), t)."""
    spec = uniform_spec()
    sess = api.FederationSession.create(spec, 7, device="cpu")
    state = sess.substrate.init_state(api.session.rng.split(7)[0])
    for t in range(3):
        state, _ = sess.substrate.run_round(state, sess.round_key(t), t)
    sess.run(3)
    assert all(torch.equal(a, b) for a, b in zip(sess.state, state))


def test_fault_free_sync_does_not_copy_the_cohort(monkeypatch):
    """The fault-free sync step is the fused round: it never takes the
    cohort to the host (the robust path's one copy)."""
    def refuse(cohort):
        raise AssertionError("host copy on the fault-free path")
    monkeypatch.setattr(scheduler, "host_cohort", refuse)
    sess = api.FederationSession.create(uniform_spec(), 1, device="cpu")
    sess.run(2)
    assert sess.round == 2
    faulted = api.FederationSession.create(
        uniform_spec(fault_model="crash", fault_rate=0.3), 1, device="cpu")
    with pytest.raises(AssertionError, match="host copy"):
        faulted.step()


def test_async_deterministic_and_distinct_from_sync():
    spec = uniform_spec(schedule="async", async_commit=1)
    runs = []
    for _ in range(2):
        sess = api.FederationSession.create(spec, 2, device="cpu")
        sess.run(4, callbacks=[api.EvalEvery(2)])
        runs.append(sess)
    assert runs[0].history == runs[1].history
    assert all(torch.equal(a, b)
               for a, b in zip(runs[0].state, runs[1].state))
    sync = api.FederationSession.create(
        dataclasses.replace(spec, schedule="sync"), 2, device="cpu")
    sync.run(4, callbacks=[api.EvalEvery(2)])
    assert sync.history != runs[0].history
    assert runs[0].scheduler.dispatched >= 1
    assert runs[0].sim_clock > 0.0 and sync.sim_clock is None


def test_flush_drains_pipeline_and_buffer():
    over = api.FederationSession.create(uniform_spec(schedule="overlapped"),
                                        3, device="cpu")
    over.run(2)
    before = [p.clone() for p in over.state]
    over.flush()
    assert over.scheduler.pending is None and over.round == 2
    assert any(not torch.equal(a, b) for a, b in zip(before, over.state))
    over.flush()  # nothing left: a no-op
    asyn = api.FederationSession.create(
        uniform_spec(schedule="async", async_commit=1), 3, device="cpu")
    asyn.run(1)
    assert asyn.scheduler.entries
    asyn.flush()
    assert not asyn.scheduler.entries and asyn.round == 1


def test_upload_slice_and_stack_are_inverse():
    g = torch.Generator().manual_seed(0)
    up = [torch.randn((3, 2, 4, 4), generator=g, dtype=torch.complex128),
          torch.randn((3, 2, 1, 8, 8), generator=g, dtype=torch.complex128)]
    again = phases.upload_stack([phases.upload_slice(up, i)
                                 for i in range(3)])
    assert all(torch.equal(a, b) for a, b in zip(up, again))
