"""The port's checkpoints (``repro_torch.checkpoint``) and its sessions'
save / resume (``repro_torch.core.fed.api.session``).

* Kill-and-resume inside the port is bit-exact under every scheduler,
  with the certified engine's running error bound and with server
  momentum, on the port's own random rounds.
* A checkpoint the reference's session wrote loads in the port (x64,
  full participation, GD, the identity channel, the reference's arrays
  through ``repro_torch.convert``): ``evaluate`` agrees with the
  reference's on the same file to <= 1e-10, and the rounds run after the
  resume stay within 1e-10 of the reference's. The port's files read
  back in the reference.
* The format itself: the reserved metadata key, the bf16 leaves, the
  torn-file error, the format 1-2 round counter.
* The hooks, and the deprecated ``federated.train`` shim."""
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core.fed import api as japi  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fed import api  # noqa: E402
from repro_torch.core.fed.api import rng  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402

TOL = 1e-10
WIDTHS, N = (2, 3, 2), 5


def small_spec(**kw):
    base = dict(widths=(2, 2), num_nodes=4, nodes_per_round=2,
                interval_length=2, eps=0.1, n_per_node=3, n_test=4,
                data_seed=5)
    base.update(kw)
    return api.FedSpec.quantum(**base)


RESUME_CASES = {
    "sync": dict(),
    "overlapped": dict(schedule="overlapped"),
    "async_mid_buffer": dict(schedule="async", nodes_per_round=3,
                             async_commit=2, staleness_decay=0.5,
                             latency_seed=9),
    "certified": dict(widths=(2, 3, 2), rank_tol=1e-3, rank_cap=2),
    "momentum": dict(aggregation="average", server_opt="momentum",
                     server_momentum=0.5),
    "faulted_sync": dict(fault_model="crash", fault_rate=0.3, fault_seed=1,
                         round_deadline=1.0),
}


def flat_state(state):
    if isinstance(state, dict):
        out = list(state["params"])
        out += list(state.get("smom") or [])
        if "err_bound" in state:
            out.append(state["err_bound"])
        return out
    return list(state)


def assert_bit_equal(a, b):
    fa, fb = flat_state(a), flat_state(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_kill_and_resume_is_bit_exact(case, tmp_path):
    spec = small_spec(**RESUME_CASES[case])
    straight = api.FederationSession.create(spec, 3, device="cpu")
    straight.run(4, callbacks=[api.EvalEvery(2)])

    killed = api.FederationSession.create(spec, 3, device="cpu")
    killed.run(2, callbacks=[api.EvalEvery(2)])
    if case == "async_mid_buffer":
        assert killed.scheduler.entries, "buffer must be non-empty"
    if case == "overlapped":
        assert killed.scheduler.pending is not None
    if case == "momentum":
        assert killed.state["smom"] is not None
    path = str(tmp_path / "fed.npz")
    killed.save(path)
    del killed

    resumed = api.FederationSession.resume(path, device="cpu")
    assert resumed.round == 2
    assert resumed.spec == spec
    resumed.run(2, callbacks=[api.EvalEvery(2)])
    assert_bit_equal(straight.state, resumed.state)
    assert resumed.history == straight.history
    if case == "async_mid_buffer":
        assert resumed.scheduler.clock == straight.scheduler.clock
        assert resumed.scheduler.dispatched == straight.scheduler.dispatched
    if case == "certified":
        assert straight.history["err_bound"][-1] > 0.0


def test_resume_keeps_the_round_key_plan(tmp_path):
    spec = small_spec()
    straight = api.FederationSession.create(spec, 4, rounds=3, device="cpu")
    straight.run(3)
    killed = api.FederationSession.create(spec, 4, rounds=3, device="cpu")
    killed.run(1)
    path = str(tmp_path / "plan.npz")
    killed.save(path)
    resumed = api.FederationSession.resume(path, device="cpu")
    assert resumed.round_keys == straight.round_keys
    resumed.run(2)
    assert_bit_equal(straight.state, resumed.state)
    plan = api.sequential_split_plan(5, 3)
    assert plan[:2] == api.sequential_split_plan(5, 2)
    assert len(set(plan)) == 3


def test_rng_is_counter_based():
    assert rng.fold_in(7, 3) == rng.fold_in(7, 3) != rng.fold_in(7, 4)
    assert rng.split(7) == rng.split(7, 2)
    assert set(rng.split(7)).isdisjoint({rng.fold_in(7, i)
                                         for i in range(4)})
    assert all(0 <= k < 2 ** 63 for k in rng.split(2 ** 70, 5))
    a = torch.rand(4, generator=rng.generator(11))
    assert torch.equal(a, torch.rand(4, generator=rng.generator(11)))
    assert rng.from_key_words(np.array([1, 2], np.uint32)) == (1 << 32) + 2


# ------------------------------------------ reference checkpoints here
@functools.lru_cache(maxsize=None)
def reference_data():
    _, ds, test = jdata.make_federated_dataset(
        jax.random.PRNGKey(3), WIDTHS[0], num_nodes=N, n_per_node=3,
        n_test=6)
    params = jqnn.init_params(jax.random.PRNGKey(4), WIDTHS)
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), None, "cpu")
    ttest = tuple(convert.states_to_torch(np.asarray(x), "cpu")
                  for x in test)
    return (ds, test, params), (tds, ttest)


REF_CASES = {
    "sync": dict(),
    "overlapped": dict(schedule="overlapped"),
    "async_mid_buffer": dict(schedule="async", async_commit=2,
                             latency_seed=4),
    "momentum": dict(aggregation="average", server_opt="momentum",
                     server_momentum=0.5),
    "certified": dict(rank_tol=1e-3, rank_cap=2),
}


def full_kw(**kw):
    return dict(dict(widths=WIDTHS, num_nodes=N, nodes_per_round=N,
                     participation="full", interval_length=2, eps=0.1),
                **kw)


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_checkpoint_resumes_in_the_port(x64, case, tmp_path):
    (ds, test, params), (tds, ttest) = reference_data()
    jspec = japi.FedSpec.quantum(**full_kw(**REF_CASES[case]))
    jsub = japi.QuantumSubstrate(jspec, dataset=ds, test=test)
    jsess = japi.FederationSession.create(jspec, jax.random.PRNGKey(0),
                                          substrate=jsub, params=params)
    jsess.run(2, callbacks=[japi.EvalEvery(1)])
    if case == "async_mid_buffer":
        assert jsess.scheduler.entries
    path = str(tmp_path / "ref.npz")
    jsess.save(path)

    spec = api.FedSpec.quantum(**full_kw(**REF_CASES[case]))
    sub = api.QuantumSubstrate(spec, dataset=tds, test=ttest, device="cpu")
    sess = api.FederationSession.resume(path, substrate=sub, device="cpu")
    ref = japi.FederationSession.resume(path, substrate=jsub)
    assert sess.spec == spec and sess.round == ref.round == 2
    assert sess.history == ref.history
    ev, jev = sess.evaluate(), ref.evaluate()
    assert ev.keys() == jev.keys()
    assert max(abs(ev[k] - jev[k]) for k in ev) <= TOL
    if case == "async_mid_buffer":
        assert len(sess.scheduler.entries) == len(ref.scheduler.entries)
        assert sess.scheduler.clock == ref.scheduler.clock
    if case == "overlapped":
        assert sess.scheduler.pending["round"] == \
            ref.scheduler.pending["round"]
    # the rounds after the resume draw from the port's stream; with no
    # draws in these rounds they stay on the reference's trajectory
    assert sess.key == rng.from_key_words(np.asarray(ref.key))
    for _ in range(2):
        sess.step()
        ref.step()
    got, want = flat_state(sess.state), ref.state
    want = (list(want["params"]) + list(want.get("smom") or [])
            + ([want["err_bound"]] if "err_bound" in want else [])
            if isinstance(want, dict) else list(want))
    for a, b in zip(got, want):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= TOL


def test_reference_format_2_round_counter_from_metadata(x64, tmp_path):
    """Formats 1-2 carry the round only as the npz metadata step."""
    (ds, test, params), (tds, ttest) = reference_data()
    jspec = japi.FedSpec.quantum(**full_kw())
    jsess = japi.FederationSession.create(
        jspec, jax.random.PRNGKey(0), params=params,
        substrate=japi.QuantumSubstrate(jspec, dataset=ds, test=test))
    jsess.run(3)
    tree = jsess.state_pytree()
    del tree["round"]
    path = str(tmp_path / "fmt2.npz")
    jckpt.save(path, tree, step=3, extra={"fed_spec":
                                          jspec.to_json_dict(),
                                          "history": {}, "format": 2})
    spec = api.FedSpec.quantum(**full_kw())
    sess = api.FederationSession.resume(
        path, substrate=api.QuantumSubstrate(spec, dataset=tds, test=ttest,
                                             device="cpu"), device="cpu")
    assert sess.round == 3
    for a, b in zip(sess.state, jsess.state):
        assert torch.equal(a, torch.from_numpy(np.array(b)))


def test_port_checkpoint_reads_back_in_the_reference(x64, tmp_path):
    spec = small_spec(schedule="async", async_commit=1)
    sess = api.FederationSession.create(spec, 5, device="cpu")
    sess.run(2)
    path = str(tmp_path / "port.npz")
    sess.save(path)
    flat, meta = jckpt.restore(path)
    assert meta["extra"]["rng"] == "repro_torch.splitmix64"
    assert meta["extra"]["format"] == 3 and meta["step"] == 2
    assert japi.FedSpec.from_json(meta["extra"]["fed_spec"]).fingerprint() \
        == spec.fingerprint()
    for i, p in enumerate(sess.state):
        np.testing.assert_array_equal(np.asarray(flat[f"state/params/{i}"]),
                                      p.numpy())
    assert int(flat["round"]) == 2
    assert int(flat["rng/base"]) == sess.key
    n_buf = len(sess.scheduler.entries)
    assert np.asarray(flat["sched/arrival"]).shape == (n_buf,)
    with open(path + ".meta.json") as f:
        assert json.load(f) == meta


def test_not_a_session_checkpoint(tmp_path):
    path = str(tmp_path / "plain.npz")
    ckpt.save(path, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="not a FederationSession"):
        api.FederationSession.resume(path, device="cpu")


# ---------------------------------------------------------- the format
def test_torn_checkpoint_raises_a_named_value_error(tmp_path):
    path = str(tmp_path / "torn.npz")
    sess = api.FederationSession.create(small_spec(), 1, device="cpu")
    sess.save(path)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="torn.npz is torn"):
        ckpt.restore(path, device="cpu")
    with pytest.raises(ValueError, match="torn"):
        api.FederationSession.resume(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "missing.npz"), device="cpu")
    # an atomic save leaves no temp file behind
    assert sorted(os.listdir(tmp_path)) == ["torn.npz", "torn.npz.meta.json"]


def test_reserved_key_is_refused(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save(str(tmp_path / "x.npz"), {"__meta__": torch.ones(1)})


def test_bf16_leaves_round_trip_in_both_packages(x64, tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 5), generator=g).to(torch.bfloat16)
    tree = {"w": w, "nest": [torch.arange(4), {"c": torch.ones(
        2, dtype=torch.complex128)}], "s": np.float64(2.5), "skip": None}
    path = str(tmp_path / "bf.npz")
    ckpt.save(path, tree, step=7, extra={"k": 1}, specs={"w": "P(x)"})
    flat, meta = ckpt.restore(path, device="cpu")
    assert meta["dtypes"] == {"w": "bfloat16"} and meta["step"] == 7
    assert meta["specs"] == {"w": "P(x)"}
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"], w)
    assert torch.equal(flat["nest/0"], torch.arange(4))
    assert flat["nest/1/c"].dtype == torch.complex128
    assert float(flat["s"]) == 2.5 and "skip" not in flat
    back = ckpt.unflatten_like({"w": 0, "nest": [0, {"c": 0}]}, flat,
                               device="cpu")
    assert torch.equal(back["nest"][1]["c"], tree["nest"][1]["c"])
    # the reference reads the same bits as its bfloat16, and writes
    # bf16 leaves the port reads
    jflat, _ = jckpt.restore(path)
    assert jflat["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jflat["w"]).view(np.uint16),
        w.view(torch.int16).numpy().view(np.uint16))
    jpath = str(tmp_path / "jbf.npz")
    jckpt.save(jpath, {"w": jflat["w"]})
    again, _ = ckpt.restore(jpath, device="cpu")
    assert torch.equal(again["w"], w)
    with pytest.raises(KeyError, match="missing"):
        ckpt.unflatten_like({"absent": 0}, flat, device="cpu")


# -------------------------------------------------------------- hooks
def test_hooks_early_stop_checkpointer_metric_stream(tmp_path):
    spec = small_spec()
    path = str(tmp_path / "hook.npz")
    streamed = []
    sess = api.FederationSession.create(spec, 1, device="cpu")
    sess.run(6, callbacks=[
        api.EvalEvery(1),
        api.EarlyStop("test_fidelity", target=-1.0),  # fires on 1st eval
        api.Checkpointer(path, every=1),
        api.MetricStream(lambda r, m: streamed.append(r)),
    ])
    # early stop after the first round's eval, not all 6
    assert sess.round == 1
    assert sess.history["iteration"] == [0, 1]
    assert streamed == []  # quantum rounds emit no per-round metrics
    resumed = api.FederationSession.resume(path, device="cpu")
    assert resumed.round == 1  # checkpointer wrote the final state
    assert_bit_equal(sess.state, resumed.state)
    for bad in (lambda: api.EvalEvery(0), lambda: api.Checkpointer(path, 0),
                lambda: api.EarlyStop(mode="mean")):
        with pytest.raises(ValueError):
            bad()


def test_metric_stream_copies_metrics_once(capsys):
    spec = small_spec(rank_tol=1e-3, rank_cap=2)
    got = []
    sess = api.FederationSession.create(spec, 2, device="cpu")
    sess.run(2, callbacks=[api.MetricStream(lambda r, m: got.append((r, m))),
                           api.MetricStream()])
    assert [r for r, _ in got] == [1, 2]
    assert set(got[0][1]) == {"err_bound_round", "err_bound_total"}
    assert all(isinstance(v, float) for v in got[0][1].values())
    assert "round    2  err_bound_round" in capsys.readouterr().out


def test_train_shim_equals_a_hand_driven_session():
    spec = small_spec()
    sub = api.QuantumSubstrate(spec, device="cpu")
    with pytest.warns(DeprecationWarning, match="legacy shim"):
        params, hist = fed.train(7, spec.to_quantum_config(), sub.dataset,
                                 sub.test, 3, eval_every=2)
    sess = api.FederationSession.create(spec, 7, substrate=sub, rounds=3)
    sess.run(3, callbacks=[api.EvalEvery(2)])
    assert hist == sess.history
    assert hist["iteration"] == [0, 2, 3]
    assert all(torch.equal(a, b) for a, b in zip(params, sess.state))


def test_evaluate_matches_the_reference_on_the_same_params(x64):
    (ds, test, params), (tds, ttest) = reference_data()
    for impl, tol in (("xla", TOL), ("pallas", 1e-5)):
        jspec = japi.FedSpec.quantum(**full_kw(impl=impl))
        spec = api.FedSpec.quantum(**full_kw(impl=impl))
        want = japi.QuantumSubstrate(jspec, dataset=ds, test=test).evaluate(
            params)
        sub = api.QuantumSubstrate(spec, dataset=tds, test=ttest,
                                   device="cpu")
        got = sub.evaluate(convert.params_to_torch(
            [np.asarray(p) for p in params], "cpu"))
        assert got.keys() == want.keys()
        assert all(isinstance(v, float) for v in got.values())
        assert max(abs(got[k] - want[k]) for k in got) <= tol


def test_substrate_state_dtypes_survive_a_32_bit_reference_file(tmp_path):
    """complex64 leaves (a reference run without x64) widen to the
    port's complex128 on restore."""
    spec = small_spec()
    sub = api.QuantumSubstrate(spec, device="cpu")
    p32 = [p.to(torch.complex64) for p in sub.init_state(1)]
    state = sub.state_restore({f"params/{i}": p for i, p in enumerate(p32)})
    assert all(p.dtype == torch.complex128 for p in state)
