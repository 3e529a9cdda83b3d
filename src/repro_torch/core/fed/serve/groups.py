"""Session grouping — WHO shares a stacked round (the port of
``repro.core.fed.serve.groups``).

``FedSpec.fingerprint()`` hashes the group-relevant spec fields (QNN
widths, cohort shape, strategy names, engine/impl/rank knobs — not
per-tenant hyperparameters, not data content), so sessions with equal
fingerprints run the SAME federation round on tensors of the same
shapes. A ``StackedGroup`` seats such sessions on a fixed grid of S
slots and drives every occupied slot's next round as ONE
``federated.server_round_stacked`` call over the leading session axis.

Per-slot state lives RESIDENT on the device in stacked buffers (params,
server momentum, the certificate, the dataset and the screening probe;
the round keys are host ints): seating copies a session into its slot
in place, reading a slot out gathers it, and the grid is never
re-stacked per tick. Slot s's round t draws from the generator of
``rng.fold_in(key_s, t)``, exactly ``FederationSession.round_key(t)``,
so a served tenant and the same tenant stepped alone draw the same
cohorts. Idle slots, and slots whose round budget ran out inside a
multi-round tick, compute but their results are merged out with
``torch.where`` on a live mask (the fixed-shape price of continuous
batching), which leaves their state bit for bit as it was.

Sessions the stacked path cannot drive — async/overlapped schedules
(their in-flight buffers are per-session host state), faulted or
deadline runs (a host-side loop per session), sessions pinned to an
explicit round-key plan — fall back to a ``SequentialGroup``: the same
admission grid, ``session.step()`` per active slot per tick. The
server routes by ``group_mode``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fed.api import rng
from repro_torch.core.fed.api.session import FederationSession
from repro_torch.core.fed.api.spec import FedSpec
from repro_torch.core.fed.serve.admission import SlotGrid

# a target past any budget: the slot never stops on its own
_UNBOUNDED = np.iinfo(np.int64).max


def group_mode(spec: FedSpec,
               session: Optional[FederationSession] = None) -> str:
    """"stacked" when the spec's rounds can run as one stacked call —
    quantum substrate, sync schedule, fold-in round keys — else
    "sequential"."""
    if spec.substrate != "quantum" or spec.schedule != "sync":
        return "sequential"
    if spec.fault_model is not None or spec.round_deadline is not None:
        # the robust sync path (fault effects, deadline retries) is a
        # host-side per-session loop, not one stacked round
        return "sequential"
    if session is not None and session.round_keys is not None:
        return "sequential"  # explicit key plans are per-session state
    return "stacked"


def group_key(spec: FedSpec,
              session: Optional[FederationSession] = None) -> str:
    """The routing key: fingerprint + execution mode."""
    return f"{spec.fingerprint()}:{group_mode(spec, session)}"


def _slot_finite(params) -> torch.Tensor:
    """(S,) bool: every layer buffer of the slot is finite. An entry is
    finite where x * 0 == 0 (inf * 0 and NaN * 0 are NaN), the test of
    ``linalg.eigh_herm``."""
    fin = None
    for p in params:
        f = (p * 0 == 0).reshape(p.shape[0], -1).all(dim=1)
        fin = f if fin is None else (fin & f)
    return fin


def _state_finite(session) -> bool:
    """True when every floating leaf of the session state is finite."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        elif torch.is_tensor(t):
            yield t
    return all(bool((x * 0 == 0).all())
               for x in leaves(session.substrate.state_flat(session.state))
               if x.is_floating_point() or x.is_complex())


class StackedGroup:
    """S slots driving same-fingerprint quantum sessions, up to
    ``rounds_per_tick`` stacked rounds per tick (module docstring)."""

    mode = "stacked"

    def __init__(self, spec: FedSpec, n_slots: int,
                 rounds_per_tick: int = 1):
        from repro_torch.core.quantum import federated as fed
        from repro_torch.core.quantum import linalg as ql

        self.spec = spec  # structural template (fingerprint fields)
        self.grid = SlotGrid(n_slots)
        self.rounds_per_tick = rounds_per_tick
        self.cfg = fed.check_supported(spec.to_quantum_config())
        self.with_smom = spec.server_opt != "none"
        self.certified = ql.resolve_approx(
            spec.rank_tol, spec.rank_cap, spec.ensemble_dtype) is not None
        self.sessions: Dict[int, FederationSession] = {}
        # host-side per-slot scalars + stacked device residents, all
        # shaped by the first seat (the grid's width materializes at
        # first admission, sized to the queue actually present)
        self.rounds = None    # (S,) absolute session rounds
        self._targets = None  # (S,) absolute round budgets
        self._keys = None     # (S,) the sessions' int base keys
        self._eta = None      # (S,) per-tenant hyperparameters
        self._eps = None
        self._beta = None
        self._params = None   # per-layer list, each (S, m_l, d, d)
        self._smom = None     # per-layer list, each (S, I_l, m_l, d, d)
        self._err = None      # (S,) running certificates
        self._data = None     # stacked QuantumDataset
        self._probe = None    # stacked screening batch (defense="screen")
        # (slot, diagnostic) pairs the server quarantines after a tick
        self._faulted: List[Tuple[int, str]] = []

    # -- seating --------------------------------------------------------
    def _parts(self, session: FederationSession):
        """A session's per-slot tensors in buffer order (None where the
        group keeps no such buffer)."""
        sub = session.substrate
        params, smom, err = sub.state_parts(session.state)
        ds = sub.dataset
        return (list(params), list(smom) if self.with_smom else None,
                err if self.certified else None,
                [ds.phi_in, ds.phi_out] + ([] if ds.n_per is None
                                           else [ds.n_per]),
                (None if getattr(sub, "_probe", None) is None
                 else list(sub._probe)))

    def _buffers(self):
        data = [self._data.phi_in, self._data.phi_out] + (
            [] if self._data.n_per is None else [self._data.n_per])
        return (self._params, self._smom, self._err, data, self._probe)

    def _init_buffers(self, session: FederationSession) -> None:
        """The first seat shapes the whole grid: every buffer is one
        session's tensors tiled S times (real copies, written in place
        by later seats)."""
        from repro_torch.core.quantum.data import QuantumDataset
        s = self.grid.n_slots
        spec = self.spec

        def tile(x):
            return x.unsqueeze(0).expand((s,) + tuple(x.shape)).clone()
        params, smom, err, data, probe = self._parts(session)
        self.rounds = np.zeros(s, np.int64)
        self._targets = np.zeros(s, np.int64)
        self._keys = np.zeros(s, np.int64)
        self._eta = np.full(s, spec.eta, np.float64)
        self._eps = np.full(s, spec.eps, np.float64)
        self._beta = np.full(s, spec.server_momentum, np.float64)
        self._params = [tile(p) for p in params]
        self._smom = None if smom is None else [tile(m) for m in smom]
        self._err = None if err is None else tile(err)
        data = [tile(x) for x in data]
        self._data = QuantumDataset(*data)
        self._probe = None if probe is None else [tile(x) for x in probe]

    def seat(self, slot: int, session: FederationSession,
             target: Optional[int] = None) -> None:
        """Copy a session's state into its slot's stacked buffers.
        ``target`` is the absolute round budget (the slot stops
        advancing there when ticks run multiple rounds); None means
        unbounded."""
        self.seat_many([(slot, session, target)])

    def seat_many(self, claims) -> None:
        """Seat a wave of (slot, session, target) claims: one
        ``index_copy_`` per buffer for the whole wave."""
        if not claims:
            return
        if self._params is None:
            self._init_buffers(claims[0][1])
        bufs = self._buffers()
        parts = [self._parts(session) for _, session, _ in claims]
        dev = self._params[0].device
        idx = torch.tensor([slot for slot, _, _ in claims], device=dev)

        def write(buf, vals):
            if buf is None:
                return
            if torch.is_tensor(buf):
                buf.index_copy_(0, idx, torch.stack(vals).to(buf.dtype))
                return
            for i, b in enumerate(buf):
                write(b, [v[i] for v in vals])
        for i, buf in enumerate(bufs):
            write(buf, [p[i] for p in parts])
        for slot, session, target in claims:
            self.rounds[slot] = session.round
            self._targets[slot] = _UNBOUNDED if target is None else target
            self._keys[slot] = session.key
            self._eta[slot] = session.spec.eta
            self._eps[slot] = session.spec.eps
            self._beta[slot] = session.spec.server_momentum
            self.sessions[slot] = session

    def sync_out(self, slot: int) -> None:
        """Gather a slot's stacked state back into its session object
        (exact copies: park/revive after a sync is bit-exact)."""
        session = self.sessions[slot]
        params = [b[slot].clone() for b in self._params]
        smom = (None if self._smom is None
                else [b[slot].clone() for b in self._smom])
        err = None if self._err is None else self._err[slot].clone()
        session.state = session.substrate.pack_state(params, smom, err)
        session.round = int(self.rounds[slot])

    def unseat(self, slot: int) -> str:
        """Gather state out and free the slot for the next queued
        session (the buffers keep the retired state as inert filler)."""
        self.sync_out(slot)
        del self.sessions[slot]
        return self.grid.free(slot)

    def round_of(self, slot: int) -> int:
        return int(self.rounds[slot])

    # -- the stacked round ---------------------------------------------
    def _round(self, live: np.ndarray, eta, eps, beta) -> None:
        """One stacked round of every slot, each drawing from its own
        ``fold_in(key, round)`` generator; the live slots take the new
        state, the rest keep theirs bit for bit."""
        from repro_torch.core.quantum import federated as fed
        gens = [rng.generator(rng.fold_in(int(k), int(r)))
                for k, r in zip(self._keys, self.rounds)]
        new_p, new_m, err_r = fed.server_round_stacked(
            self._params, self._data, gens, self.cfg, smom=self._smom,
            eta=eta, eps=eps, server_opt=self.spec.server_opt,
            server_beta=beta, probe=self._probe)
        dev = self._params[0].device
        mask = torch.as_tensor(live, device=dev)

        def merge(new, old):
            return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)),
                               new, old)
        self._params = [merge(n, o) for n, o in zip(new_p, self._params)]
        if self._smom is not None:
            self._smom = [merge(n, o) for n, o in zip(new_m, self._smom)]
        if self._err is not None:
            self._err = merge(self._err + err_r.to(self._err.dtype),
                              self._err)
        self.rounds[live] += 1

    def step(self) -> int:
        """Up to ``rounds_per_tick`` stacked rounds for every occupied
        slot; a slot advances exactly ``min(k, target - round)``
        rounds. Then one host read of the slots' finiteness: a slot
        whose model went non-finite is flagged for the server to
        quarantine (the stacked round already kept it from touching
        any other slot's buffers)."""
        active = self.grid.active_mask()
        n = int(active.sum())
        if n == 0:
            return 0
        dev = self._params[0].device

        def vec(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)
        eta, eps, beta = vec(self._eta), vec(self._eps), vec(self._beta)
        for _ in range(self.rounds_per_tick):
            live = active & (self.rounds < self._targets)
            if not live.any():
                break
            self._round(live, eta, eps, beta)
        fin = _slot_finite(self._params).cpu().numpy()
        for slot in np.nonzero(active & ~fin)[0]:
            self._faulted.append(
                (int(slot), "non-finite model state after stacked tick"))
        return n

    def take_faulted(self):
        """Drain the (slot, diagnostic) pairs flagged by ``step``."""
        out, self._faulted = self._faulted, []
        return out


class SequentialGroup:
    """Fallback execution: the same slot grid, up to ``rounds_per_tick``
    ``session.step()`` calls per active slot per tick (async/overlapped
    schedules, faulted runs, explicit round-key plans)."""

    mode = "sequential"

    def __init__(self, spec: FedSpec, n_slots: int,
                 rounds_per_tick: int = 1):
        self.spec = spec
        self.grid = SlotGrid(n_slots)
        self.rounds_per_tick = rounds_per_tick
        self.sessions: Dict[int, FederationSession] = {}
        self._targets: Dict[int, Optional[int]] = {}
        self._faulted: List[Tuple[int, str]] = []

    def seat(self, slot: int, session: FederationSession,
             target: Optional[int] = None) -> None:
        self.sessions[slot] = session
        self._targets[slot] = target

    def seat_many(self, claims) -> None:
        for slot, session, target in claims:
            self.seat(slot, session, target)

    def sync_out(self, slot: int) -> None:
        pass  # the session object IS the live state

    def unseat(self, slot: int) -> str:
        del self.sessions[slot]
        self._targets.pop(slot, None)
        return self.grid.free(slot)

    def round_of(self, slot: int) -> int:
        return self.sessions[slot].round

    def step(self) -> int:
        n = 0
        check_finite = self.spec.fault_model is not None
        for slot, sid in enumerate(self.grid.sid):
            if sid is None:
                continue
            if any(slot == s for s, _ in self._faulted):
                continue  # already flagged; server will quarantine it
            session = self.sessions[slot]
            target = self._targets.get(slot)
            todo = self.rounds_per_tick
            if target is not None:
                todo = min(todo, max(target - session.round, 0))
            try:
                for _ in range(todo):
                    session.step()
            except RuntimeError as e:
                # deadline/retry exhaustion or commit starvation: isolate
                # this session, keep serving the rest of the grid
                self._faulted.append((slot, f"{type(e).__name__}: {e}"))
                continue
            if check_finite and not _state_finite(session):
                self._faulted.append(
                    (slot, "non-finite model state after step"))
                continue
            n += 1
        return n

    def take_faulted(self):
        """Drain the (slot, diagnostic) pairs flagged by ``step``."""
        out, self._faulted = self._faulted, []
        return out


def make_group(spec: FedSpec, mode: str, n_slots: int,
               rounds_per_tick: int = 1):
    if mode == "stacked":
        return StackedGroup(spec, n_slots, rounds_per_tick)
    return SequentialGroup(spec, n_slots, rounds_per_tick)
