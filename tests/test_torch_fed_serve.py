"""The port's multi-tenant serving (``repro_torch.core.fed.serve``) on
the CPU: each gate of the reference's ``tests/test_fed_serve.py``, held
on the port, plus a served tenant against the reference's own session.

* served == solo: a tenant driven on a busy stacked grid ends within
  1e-10 (complex128) of the same session stepped alone, across mixed
  specs, per-tenant hyperparameters and multi-round ticks;
* park -> evict -> revive mid-run is BIT-exact;
* admission is deterministic: replaying a submission sequence
  reproduces every final state bit for bit;
* ``FedSpec.fingerprint`` groups what must stack together and survives
  the JSON round-trip;
* torn checkpoints are detected, failed saves leave the old file;
* a tenant whose data is poisoned with NaN is quarantined alone.

The port's round keys are its own (ints, ``api/rng.py``), so the
comparison with the reference runs with ``participation="full"``, GD
and the identity channel, the reference's arrays fed to both packages
through ``repro_torch.convert``."""
import dataclasses
import glob
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import api as japi  # noqa: E402
from repro.core.fed import serve as jserve  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import qnn as jqnn  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fed.api import QuantumSubstrate  # noqa: E402
from repro_torch.core.fed.api.session import FederationSession  # noqa: E402
from repro_torch.core.fed.api.spec import FedSpec  # noqa: E402
from repro_torch.core.fed.serve import (CheckpointStore,  # noqa: E402
                                        FederationServer, SlotGrid,
                                        group_key, group_mode)

SPEC = FedSpec.quantum((2, 3, 2), num_nodes=4, nodes_per_round=2,
                       n_per_node=4, interval_length=2, n_test=4)
TOL = 1e-10


def _params_of(sess):
    return sess.substrate.state_parts(sess.state)[0]


def _max_diff(a, b):
    return max(float((torch.as_tensor(np.array(x)) -
                      torch.as_tensor(np.array(y))).abs().max())
               for x, y in zip(a, b))


def _create(spec, key):
    return FederationSession.create(spec, key, device="cpu")


def _solo(spec, key, rounds):
    solo = _create(spec, key)
    for _ in range(rounds):
        solo.step()
    return solo


# -- fingerprint grouping (spec-level, no serving needed) ---------------

def test_fingerprint_stable_and_json_roundtrip():
    fp = SPEC.fingerprint()
    assert fp == SPEC.fingerprint()
    assert FedSpec.from_json(SPEC.to_json()).fingerprint() == fp


def test_fingerprint_ignores_traced_fields_only():
    for kw in ({"eta": 2.0}, {"eps": 0.5}, {"data_seed": 7},
               {"server_momentum": 0.5}, {"data_noise": 0.25},
               {"data_iid": True}, {"n_test": 8}):
        assert dataclasses.replace(SPEC, **kw).fingerprint() == \
            SPEC.fingerprint(), kw
    for kw in ({"widths": (2, 2, 2)}, {"num_nodes": 6},
               {"nodes_per_round": 3}, {"interval_length": 1},
               {"aggregation": "average"}, {"engine": "dense"}):
        assert dataclasses.replace(SPEC, **kw).fingerprint() != \
            SPEC.fingerprint(), kw


def test_group_mode_routing():
    assert group_mode(SPEC) == "stacked"
    assert group_mode(dataclasses.replace(SPEC, schedule="async")) \
        == "sequential"
    sess = FederationSession.create(SPEC, 0, rounds=3, device="cpu")
    assert group_mode(SPEC, sess) == "sequential"
    assert group_key(SPEC).endswith(":stacked")
    # the keys are the reference's: same fingerprint, same routing
    jspec = japi.FedSpec.from_json(SPEC.to_json())
    assert group_key(SPEC) == jserve.group_key(jspec)


# -- admission ----------------------------------------------------------

def test_slot_grid_sizes_to_first_admission():
    g = SlotGrid(64)
    for sid in ("a", "b", "c"):
        g.submit(sid)
    assert g.n_slots == 0               # width unknown until admission
    assert [s for _, s in g.admit()] == ["a", "b", "c"]
    assert g.n_slots == 3               # queue-sized, not cap-sized
    g.submit("d")
    assert g.admit() == []              # frozen width: d waits for a slot
    g.free(1)
    assert g.admit() == [(1, "d")]


def test_slot_grid_fifo_lowest_index_first():
    g = SlotGrid(2)
    for sid in ("a", "b", "c"):
        g.submit(sid)
    assert g.admit() == [(0, "a"), (1, "b")]
    assert g.admit() == []            # full: c waits
    assert g.free(0) == "a"
    assert g.admit() == [(0, "c")]    # freed slot claimed immediately
    with pytest.raises(ValueError):
        g.submit("b")                 # already seated
    with pytest.raises(ValueError):
        g.free(1) and g.free(1)


# -- served == solo -----------------------------------------------------

def test_served_matches_solo_mixed_specs():
    """Five tenants, two groups, per-tenant eta/eps, fewer slots than
    tenants — every served tenant ends within 1e-10 of stepping alone."""
    mix = [(SPEC, 3),
           (dataclasses.replace(SPEC, widths=(2, 2, 2)), 2),
           (dataclasses.replace(SPEC, eta=2.0, eps=0.05), 4),
           (SPEC, 1),
           (dataclasses.replace(SPEC, widths=(2, 2, 2), eta=0.7), 3)]
    server = FederationServer(slots=3, device="cpu")
    sids = [server.submit(spec, key=100 + i, rounds=r)
            for i, (spec, r) in enumerate(mix)]
    server.drain()
    assert len(server.groups) == 2
    for i, (sid, (spec, r)) in enumerate(zip(sids, mix)):
        solo = _solo(spec, 100 + i, r)
        served = server.session(sid)
        assert served.round == solo.round == r
        assert _max_diff(_params_of(served), _params_of(solo)) <= TOL


def test_multi_round_ticks_match_solo():
    """rounds_per_tick=4 with budgets that do NOT divide 4: slots stop
    advancing at their budget inside the tick (merged out), so every
    tenant still matches stepping alone."""
    budgets = [3, 4, 1, 6]
    server = FederationServer(slots=2, rounds_per_tick=4, device="cpu")
    sids = [server.submit(SPEC, key=40 + i, rounds=r)
            for i, r in enumerate(budgets)]
    server.drain()
    for i, (sid, r) in enumerate(zip(sids, budgets)):
        served = server.session(sid)
        assert served.round == r
        assert _max_diff(_params_of(served),
                         _params_of(_solo(SPEC, 40 + i, r))) <= TOL


def test_sequential_fallback_matches_solo():
    """An async-schedule quantum spec can't stack — the server drives it
    through the sequential group and still matches solo stepping."""
    spec = dataclasses.replace(SPEC, schedule="async", async_commit=2)
    server = FederationServer(slots=2, device="cpu")
    sid = server.submit(spec, key=4, rounds=3)
    server.drain()
    assert group_key(spec).endswith(":sequential")
    assert _max_diff(_params_of(server.session(sid)),
                     _params_of(_solo(spec, 4, 3))) == 0.0


def test_deterministic_slot_reuse_replay():
    """Replaying the same submission sequence (4 tenants, 2 slots —
    slots are reused; keys from the submission index) reproduces every
    final state bit-exactly."""
    def serve_all():
        server = FederationServer(slots=2, device="cpu")
        sids = [server.submit(SPEC, rounds=2) for _ in range(4)]
        server.drain()
        return [p.clone() for sid in sids
                for p in _params_of(server.session(sid))]

    a, b = serve_all(), serve_all()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- park / evict / revive ---------------------------------------------

def test_park_revive_bit_exact_mid_run(tmp_path):
    """Serve 2 rounds, park to disk, revive, serve 2 more — identical
    to 4 rounds uninterrupted."""
    store = CheckpointStore(str(tmp_path))
    server = FederationServer(slots=2, store=store, device="cpu")
    sid = server.submit(SPEC, key=11, rounds=2)
    server.drain()
    path = server.park(sid)
    assert store.is_parked(sid) and os.path.exists(path)
    assert str(path).startswith(str(tmp_path))

    revived = store.get(sid)          # revives from the checkpoint
    assert not store.is_parked(sid)
    assert revived.substrate.device.type == "cpu"
    for _ in range(2):
        revived.step()
    for a, b in zip(_params_of(revived), _params_of(_solo(SPEC, 11, 4))):
        assert torch.equal(a, b)


def test_lru_eviction_parks_coldest(tmp_path):
    store = CheckpointStore(str(tmp_path), capacity=2)
    sessions = {f"s{i}": _create(SPEC, i) for i in range(3)}
    for sid, s in sessions.items():
        store.add(sid, s)
    # s0 was coldest -> parked to disk; live set stays at capacity
    assert store.is_parked("s0") and store.n_live == 2
    assert os.path.exists(store.path("s0"))
    ref = [p.clone() for p in _params_of(sessions["s0"])]
    revived = store.get("s0")         # LRU: parks s1 on revival
    assert store.is_parked("s1")
    assert (store.parks, store.revives) == (2, 1)
    for a, b in zip(_params_of(revived), ref):
        assert torch.equal(a, b)


def test_pinned_sessions_never_park(tmp_path):
    store = CheckpointStore(str(tmp_path), capacity=1)
    store.add("a", _create(SPEC, 0))
    store.pin("a")
    store.add("b", _create(SPEC, 1))
    # "a" is pinned (state lives on a grid): the cap falls on "b", the
    # only evictable session, even though it is the newest
    assert not store.is_parked("a")
    assert store.is_parked("b")
    with pytest.raises(ValueError):
        store.park("a")
    store.unpin("a")
    store.get("b")       # reviving "b" re-applies the cap: now "a" parks
    assert store.is_parked("a") and not store.is_parked("b")
    with pytest.raises(ValueError, match="filesystem-safe"):
        store.add("../x", _create(SPEC, 2))


def test_served_park_evict_revive_matches_uninterrupted(tmp_path):
    """A live-session cap below the tenant count: tenants park while
    queued, revive at admission and park again after retirement; each
    ends bit-equal to the same tenant served on an uncapped server."""
    def serve(max_live, store_dir):
        server = FederationServer(slots=2, rounds_per_tick=2,
                                  store_dir=store_dir, max_live=max_live,
                                  device="cpu")
        sids = [server.submit(SPEC, key=60 + i, rounds=3) for i in range(5)]
        server.drain()
        return server, [[p.clone() for p in _params_of(server.session(s))]
                        for s in sids]
    capped, got = serve(2, str(tmp_path / "capped"))
    _, want = serve(None, str(tmp_path / "free"))
    assert capped.store.parks > 0 and capped.store.revives > 0
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


# -- crash-safe checkpointing ------------------------------------------

def test_torn_checkpoint_detected(tmp_path):
    p = str(tmp_path / "c.npz")
    ckpt.save(p, {"x": np.arange(8.0)}, step=1)
    raw = open(p, "rb").read()
    torn = str(tmp_path / "torn.npz")
    with open(torn, "wb") as f:
        f.write(raw[: int(len(raw) * 0.6)])   # truncation injection
    with pytest.raises(ValueError, match="torn"):
        ckpt.restore(torn, device="cpu")
    with pytest.raises(FileNotFoundError):    # missing stays distinct
        ckpt.restore(str(tmp_path / "nope.npz"), device="cpu")


def test_failed_save_keeps_old_checkpoint(tmp_path, monkeypatch):
    p = str(tmp_path / "c.npz")
    ckpt.save(p, {"x": np.arange(3.0)}, step=1)

    def boom(f, **kw):
        f.write(b"partial garbage")
        raise RuntimeError("disk full")

    monkeypatch.setattr("repro_torch.checkpoint.checkpoint.np.savez", boom)
    with pytest.raises(RuntimeError):
        ckpt.save(p, {"x": np.zeros(3)}, step=2)
    monkeypatch.undo()
    flat, meta = ckpt.restore(p, device="cpu")   # old checkpoint intact...
    assert meta["step"] == 1
    np.testing.assert_array_equal(flat["x"].numpy(), np.arange(3.0))
    assert not glob.glob(str(tmp_path / "tmp*"))   # ...and no debris


def test_session_save_is_crash_safe(tmp_path, monkeypatch):
    """A session checkpoint interrupted mid-write leaves the previous
    round's file restorable (the serving store's park path)."""
    sess = _create(SPEC, 2)
    sess.step()
    p = str(tmp_path / "s.npz")
    sess.save(p)
    ref = [x.clone() for x in _params_of(sess)]
    sess.step()
    calls = []

    def boom(f, **kw):
        calls.append(1)
        raise OSError("kill -9 mid-write")

    monkeypatch.setattr("repro_torch.checkpoint.checkpoint.np.savez", boom)
    with pytest.raises(OSError):
        sess.save(p)
    monkeypatch.undo()
    assert calls
    revived = FederationSession.resume(p, device="cpu")
    assert revived.round == 1
    for a, b in zip(_params_of(revived), ref):
        assert torch.equal(a, b)


# -- failure isolation --------------------------------------------------

def test_poisoned_tenant_is_quarantined_alone():
    """One tenant's training data is NaN: its slot is pulled off the
    grid and parked with its diagnostic; every other tenant of the same
    grid still equals its solo run."""
    spec = dataclasses.replace(SPEC, aggregation="average")
    server = FederationServer(slots=3, device="cpu")
    good = [server.submit(spec, key=70 + i, rounds=3) for i in range(2)]
    bad = _create(spec, 79)
    ds = bad.substrate.dataset
    bad.substrate.dataset = ds._replace(
        phi_in=torch.full_like(ds.phi_in, complex(float("nan"), 0.0)))
    bad_sid = server.submit(session=bad, rounds=3)
    server.drain()
    assert set(server.quarantined) == {bad_sid}
    assert "non-finite" in server.quarantined[bad_sid]
    assert server.store.is_parked(bad_sid)
    for i, sid in enumerate(good):
        assert sid in server.done
        assert _max_diff(_params_of(server.session(sid)),
                         _params_of(_solo(spec, 70 + i, 3))) <= TOL


# -- the port against the reference ------------------------------------

def test_served_tenant_matches_the_reference_session(x64):
    """The reference's data and initial params fed to both packages
    (full participation, GD, the identity channel: no draw in a round):
    the port's served tenant, sharing its grid with two other tenants,
    ends within 1e-10 of the reference's solo session."""
    spec = dataclasses.replace(SPEC, participation="full", num_nodes=2,
                               nodes_per_round=2, eta=0.8)
    jspec = japi.FedSpec.from_json(spec.to_json())
    key = jax.random.PRNGKey(5)
    _, jds, jtest = jdata.make_federated_dataset(
        key, 2, num_nodes=2, n_per_node=4, n_test=4)
    jparams = jqnn.init_params(jax.random.PRNGKey(6), spec.widths)
    jsess = japi.FederationSession.create(
        jspec, key, substrate=japi.QuantumSubstrate(
            jspec, dataset=jds, test=jtest), params=jparams)
    for _ in range(3):
        jsess.step()
    ds = convert.dataset_to_torch(np.asarray(jds.phi_in),
                                  np.asarray(jds.phi_out), None, "cpu")
    test = tuple(convert.states_to_torch(np.asarray(x), "cpu")
                 for x in jtest)
    params = convert.params_to_torch([np.asarray(p) for p in jparams],
                                     "cpu")
    server = FederationServer(slots=3, device="cpu")
    for i in range(2):
        server.submit(dataclasses.replace(spec, eta=0.5 + i), key=i,
                      rounds=3)
    sid = server.submit(session=FederationSession.create(
        spec, 5, substrate=QuantumSubstrate(spec, dataset=ds, test=test,
                                            device="cpu"),
        params=params), rounds=3)
    server.drain()
    assert len(server.groups) == 1
    want = jsess.substrate.state_parts(jsess.state)[0]
    assert _max_diff(_params_of(server.session(sid)), want) <= TOL
