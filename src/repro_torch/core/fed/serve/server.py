"""``FederationServer`` — thousands of federations on one card (the
port of ``repro.core.fed.serve.server``).

The multi-tenant serving loop over the pieces next door: tenants
``submit`` a ``FedSpec`` (or a prebuilt session) with a round budget;
the server routes each to a GROUP by ``FedSpec.fingerprint`` +
execution mode (``groups``), seats queued tenants on idle slots each
``tick`` (``admission``), advances every occupied slot up to
``rounds_per_tick`` rounds — same-fingerprint quantum tenants as ONE
``server_round_stacked`` call a round — and retires tenants the instant
their budget is spent, freeing the slot for the next in line. Sessions
not currently seated live in the ``CheckpointStore`` (``store``), which
LRU-parks cold ones to disk and revives them bit-exactly on demand.

The determinism story composes end to end: FIFO admission +
lowest-index-first slots (``SlotGrid``), fold-in round keys pure in
(session key, round), masked merges that never let one tenant's state
touch another's — so replaying the same submission sequence on a fresh
server reproduces every tenant's final state exactly, and a tenant
served on a busy grid matches the same tenant stepped alone
(``tests/test_torch_fed_serve.py``, <= 1e-10 in complex128).

    server = FederationServer(slots=64)          # sessions on the card
    for i in range(10_000):
        server.submit(spec, key=i, rounds=20)
    server.drain()
    final = server.session("s000042")   # revives from disk if parked
"""
from __future__ import annotations

import tempfile
from typing import Dict, Optional

from repro_torch.core.fed.api.session import FederationSession
from repro_torch.core.fed.api.spec import FedSpec
from repro_torch.core.fed.serve.groups import group_key, group_mode, make_group
from repro_torch.core.fed.serve.store import CheckpointStore


class FederationServer:
    """See module docstring.

    slots: slot CAP per group (each group owns its own grid,
    materialized at first admission and sized to the queue present).
    rounds_per_tick: federation rounds a tick runs per seated tenant —
    k stacked calls between two admissions, at the cost of admission
    latency (freed slots re-admit only at tick boundaries; a tenant
    whose budget is not a multiple of k sits masked for the rest of its
    last tick). Results are EXACT either way: slots stop advancing at
    their round budget.
    store / store_dir / max_live: session residency — pass a configured
    ``CheckpointStore``, or a directory (+ optional live-session cap)
    and the server builds one; neither gives a temp-dir store with no
    cap (nothing parks unless asked).
    device: where sessions the server creates from a spec live (the
    card unless "cpu" is asked for); a prebuilt session keeps its own.
    """

    def __init__(self, *, slots: int = 32, rounds_per_tick: int = 1,
                 store: Optional[CheckpointStore] = None,
                 store_dir: Optional[str] = None,
                 max_live: Optional[int] = None, device="cuda"):
        if slots < 1:
            raise ValueError(f"need slots >= 1, got {slots}")
        if rounds_per_tick < 1:
            raise ValueError(
                f"need rounds_per_tick >= 1, got {rounds_per_tick}")
        if store is None:
            store = CheckpointStore(
                store_dir or tempfile.mkdtemp(prefix="fedserve-"),
                capacity=max_live)
        self.slots = slots
        self.rounds_per_tick = rounds_per_tick
        self.store = store
        self.device = device
        self.groups: Dict[str, object] = {}
        self._group_of: Dict[str, str] = {}     # sid -> group key
        self._target: Dict[str, int] = {}       # sid -> absolute round
        self.done: set = set()
        # sid -> diagnostic for sessions pulled off the grid after a
        # fault (non-finite state, deadline/retry exhaustion); their
        # last state is parked for inspection
        self.quarantined: Dict[str, str] = {}
        self._seq = 0
        self.ticks = 0

    # -- intake ----------------------------------------------------------
    def submit(self, spec: Optional[FedSpec] = None, *,
               key: Optional[int] = None, rounds: int = 1,
               session: Optional[FederationSession] = None,
               sid: Optional[str] = None) -> str:
        """Register a tenant and queue it for admission. Pass ``spec``
        (+ optional int ``key``; by default the submission index, so a
        replayed submission sequence is deterministic) to have the
        server create the session, or a prebuilt ``session``. ``rounds``
        is the budget ON TOP of the session's current round."""
        if (spec is None) == (session is None):
            raise ValueError("pass exactly one of spec= or session=")
        if rounds < 0:
            raise ValueError(f"need rounds >= 0, got {rounds}")
        if sid is None:
            sid = f"s{self._seq:06d}"
        if sid in self.store:
            raise ValueError(f"session id {sid!r} already submitted")
        self._seq += 1
        if session is None:
            if key is None:
                key = self._seq - 1
            # no rounds= here: fold-in keys, the stackable RNG contract
            session = FederationSession.create(spec, key,
                                               device=self.device)
        gk = group_key(session.spec, session)
        group = self.groups.get(gk)
        if group is None:
            group = make_group(session.spec,
                               group_mode(session.spec, session),
                               self.slots, self.rounds_per_tick)
            self.groups[gk] = group
        self.store.add(sid, session)
        self._target[sid] = session.round + rounds
        self._group_of[sid] = gk
        if rounds == 0:
            self.done.add(sid)
        else:
            group.grid.submit(sid)
        return sid

    # -- the serving loop ------------------------------------------------
    def tick(self) -> Dict[str, int]:
        """One serving tick: admit queued tenants onto idle slots, run
        up to ``rounds_per_tick`` rounds per occupied slot (stacked
        calls per stacked group), retire spent tenants. Returns tick
        stats."""
        admitted = stepped = retired = quarantined = 0
        for group in self.groups.values():
            claims = []
            for slot, sid in group.grid.admit():
                session = self.store.get(sid)   # revives if parked
                self.store.pin(sid)             # truth moves on-device
                claims.append((slot, session, self._target[sid]))
            group.seat_many(claims)             # one copy per buffer
            admitted += len(claims)
            stepped += group.step()
            # failure isolation: a faulted tenant is pulled off the grid
            # BEFORE retirement so its slot frees for the next in line;
            # its state (possibly poisoned) parks to disk for inspection
            # and the diagnostic lands in ``quarantined``
            for slot, diag in group.take_faulted():
                sid = group.grid.sid[slot]
                if sid is None:
                    continue
                group.unseat(slot)
                self.store.unpin(sid)
                self.store.park(sid)
                self.quarantined[sid] = diag
                quarantined += 1
            for slot, sid in enumerate(group.grid.sid):
                if sid is None:
                    continue
                if group.round_of(slot) >= self._target[sid]:
                    group.unseat(slot)          # syncs state + frees slot
                    self.store.unpin(sid)
                    self.done.add(sid)
                    retired += 1
        self.ticks += 1
        return {"admitted": admitted, "stepped": stepped,
                "retired": retired, "quarantined": quarantined,
                "pending": self.n_pending}

    def drain(self, max_ticks: int = 1_000_000) -> int:
        """Tick until every submitted tenant is done; returns ticks
        spent."""
        t0 = self.ticks
        while self.n_pending and self.ticks - t0 < max_ticks:
            self.tick()
        if self.n_pending:
            raise RuntimeError(f"drain hit max_ticks={max_ticks} with "
                               f"{self.n_pending} tenants pending")
        return self.ticks - t0

    # -- inspection ------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return sum(g.grid.n_active + g.grid.n_queued
                   for g in self.groups.values())

    def session(self, sid: str) -> FederationSession:
        """The tenant's session, revived from disk if parked; if it is
        mid-flight on a grid, its device state is synced out first so
        the object is current."""
        session = self.store.get(sid)
        gk = self._group_of.get(sid)
        if gk is not None:
            group = self.groups[gk]
            slot = group.grid.slot_of(sid)
            if slot is not None:
                group.sync_out(slot)
        return session

    def park(self, sid: str) -> str:
        """Explicitly checkpoint an off-grid tenant to disk."""
        return self.store.park(sid)
