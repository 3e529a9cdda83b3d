"""Pluggable round schedulers — HOW a session sequences the phases (the
port of ``repro.core.fed.api.scheduler``).

``FederationSession.step`` delegates to a ``Scheduler`` picked by
``FedSpec.schedule``:

* ``"sync"`` — Alg. 2 lock-step: one ``run_round`` (the substrate's
  fused canonical phase composition) per step, keyed by the round
  index. With fault injection or a round deadline the step runs the
  phased round instead (``SyncScheduler._robust_step``).
* ``"async"`` — staleness-weighted BUFFERED aggregation (FedBuff-style):
  cohorts are dispatched and their per-node uploads land in a buffer at
  simulated arrival times; the server commits an aggregation as soon as
  ``async_commit`` (K) uploads have arrived, decaying each upload's
  Alg. 2 weight by ``staleness_decay ** staleness`` (staleness = commits
  since the upload's dispatch) and renormalizing over the K committed.
  Per-node latency streams come from the ``cohort.latency`` registry;
  every model is counter-based (pure in ``(latency_seed, node,
  dispatch)``), so runs are deterministic and resumable: the buffer
  (uploads, arrival times, dispatch versions, weights) rides in the
  checkpoint and nothing latency-related needs to.
* ``"overlapped"`` — software pipelining: round t+1's local fan-out is
  dispatched against the pre-aggregation state and round t's aggregation
  commits AFTER it is enqueued (a staleness-1 delayed-aggregation
  schedule). The one pending round rides in the checkpoint.

One scheduler ``step`` == one server COMMIT == one session round, so
eval cadence, early stopping and checkpoint hooks mean the same thing
under every schedule.

Host copies: the fault-free sync step copies nothing from the device.
The robust sync step and each async dispatch copy the cohort (selection,
mask and weights) to the host once, because the fault and latency
streams are keyed by node id on the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fed import faults as ffaults
from repro_torch.core.fed.api import phases, rng
from repro_torch.core.fed.cohort import latency as flatency
from repro_torch.optim.tree import tree_leaves, tree_map


def host_cohort(cohort: phases.Cohort
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(sel int64, mask float64, weights float64)`` of a cohort on the
    host, from ONE device-to-host copy."""
    host = torch.stack([cohort.sel.reshape(-1).to(torch.float64),
                        cohort.mask.reshape(-1).to(torch.float64),
                        cohort.weights.reshape(-1).to(torch.float64)]
                       ).cpu().numpy()
    return host[0].astype(np.int64), host[1], host[2]


def fault_effects(sel: Sequence[int], mask: Sequence[float], faults,
                  r: int, latency=None, deadline: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Each selected slot's fate at the transmit boundary of round (or
    dispatch) ``r``: ``(coeff, survive)``. A masked-out slot, a crashed
    node and an upload whose simulated latency (``latency(node, r)``
    times the fault's delay) misses ``deadline`` do not survive; a
    survivor's upload is scaled by its fault coefficient (1.0 honest,
    NaN corrupt)."""
    coeff = np.ones(len(sel))
    survive = np.asarray(mask, np.float64).reshape(-1) > 0.0
    for i, node in enumerate(sel):
        if not survive[i]:
            continue
        c, drop, delay = (faults(int(node), r) if faults is not None
                          else ffaults.OK)
        if drop:
            survive[i] = False
            continue
        if deadline is not None:
            if float(latency(int(node), r)) * delay > deadline:
                survive[i] = False
                continue
        coeff[i] = c
    return coeff, survive


def apply_effects(received: Any, base_w: np.ndarray,
                  coeff: np.ndarray, survive: np.ndarray, faulty: bool
                  ) -> Tuple[Any, torch.Tensor]:
    """The cohort's uploads and float32 aggregation weights after
    ``fault_effects``: with a fault model on and any coefficient off 1,
    dead uploads are zeroed outright (NaN * 0 would stay NaN) and the
    survivors scaled by their coefficient; the Alg. 2 weights are
    renormalised over the survivors."""
    dev = tree_leaves(received)[0].device
    if faulty and bool(np.any(coeff != 1.0)):
        cv = np.where(survive, coeff, 0.0)
        received = tree_map(
            lambda x: x * torch.tensor(cv, dtype=x.real.dtype, device=dev)
            .reshape((-1,) + (1,) * (x.dim() - 1)), received)
    w = np.asarray(base_w, np.float64) * survive
    w = w / max(w.sum(), 1e-12)
    return received, torch.tensor(w, dtype=torch.float32, device=dev)


class Scheduler:
    """One round-sequencing policy over a ``PhasedSubstrate``."""

    name = "base"

    def __init__(self, spec, substrate):
        self.spec = spec
        self.substrate = substrate

    def step(self, session) -> Dict[str, Any]:
        raise NotImplementedError

    def flush(self, session) -> None:
        """Commit any deferred work WITHOUT dispatching new cohorts —
        drain the overlapped pipeline's pending round / the async
        buffer's in-flight uploads. Explicit (``session.flush()``), not
        part of ``run``: an automatic end-of-run flush would make a run
        split across checkpoint/resume diverge from the uninterrupted
        one. Sync has nothing in flight — no-op."""

    # -- checkpoint boundary (buffered uploads etc.) --------------------
    def state_flat(self) -> Dict[str, Any]:
        return {}

    def state_restore(self, flat: Dict[str, Any]) -> None:
        if flat:
            raise ValueError(f"checkpoint carries scheduler state but "
                             f"{self.name!r} holds none")


class SyncScheduler(Scheduler):
    """Lock-step Alg. 2: one fused ``run_round`` per step, keyed by the
    round index.

    With fault injection (``FedSpec.fault_model``) or a round deadline
    (``FedSpec.round_deadline``) active, the step runs the PHASED round
    instead: dispatch, apply the deterministic per-(node, round) fault
    effects at the transmit boundary, drop crashed/late uploads, and —
    when fewer than ``min_participants`` survive — RE-DISPATCH the round
    (fresh selection under ``fold_in(round_key, attempt)``, deadline
    relaxed by ``retry_backoff`` per attempt) up to ``max_retries``
    times before failing loud. Everything is a pure function of
    (checkpointed round counter, fault_seed, latency_seed), so faulted
    runs are deterministic and kill-and-resume stays bit-exact. The
    fault-free path is the untouched fused round (same ops, same keys,
    same empty metrics dict, no host copy)."""

    name = "sync"

    def __init__(self, spec, substrate):
        super().__init__(spec, substrate)
        self.faults = ffaults.make_model(spec)
        self.deadline = getattr(spec, "round_deadline", None)
        self.robust = self.faults is not None or self.deadline is not None
        self.latency = (flatency.make_model(spec)
                        if self.deadline is not None else None)

    def step(self, session) -> Dict[str, Any]:
        if self.robust:
            return self._robust_step(session)
        session.state, metrics = self.substrate.run_round(
            session.state, session.round_key(session.round), session.round)
        session.round += 1
        return metrics

    def _robust_step(self, session) -> Dict[str, Any]:
        spec = self.spec
        r = session.round
        attempt = 0
        while True:
            # retries re-select under a fresh-but-deterministic key; the
            # failed attempt's work is discarded (re-dispatch semantics),
            # so each attempt starts from a snapshot of the round's state
            key = session.round_key(r)
            if attempt > 0:
                key = rng.fold_in(key, attempt)
            state, cohort, received, metrics = phases.dispatch_round(
                self.substrate, self.substrate.snapshot(session.state), key,
                r)
            sel, mask, base_w = host_cohort(cohort)
            deadline = (None if self.deadline is None else
                        self.deadline * spec.retry_backoff ** attempt)
            coeff, survive = fault_effects(sel, mask, self.faults, r,
                                           self.latency, deadline)
            n_surv = int(survive.sum())
            if n_surv >= spec.min_participants:
                break
            if attempt >= spec.max_retries:
                raise RuntimeError(
                    f"round {r}: {n_surv} of {sel.shape[0]} uploads "
                    f"survived faults/deadline after {attempt + 1} "
                    f"attempts (min_participants={spec.min_participants})"
                    " — lower fault_rate, raise round_deadline, or raise "
                    "max_retries")
            attempt += 1
        received, w = apply_effects(received, base_w, coeff, survive,
                                    self.faults is not None)
        session.state = self.substrate.aggregate(state, received, w)
        session.round += 1
        metrics = dict(metrics)
        metrics.update(n_selected=float(sel.shape[0]),
                       n_survived=float(n_surv),
                       n_quarantined=float(sel.shape[0] - n_surv),
                       n_retries=float(attempt))
        return metrics


class AsyncScheduler(Scheduler):
    """Staleness-weighted buffered aggregation (module docstring)."""

    name = "async"

    def __init__(self, spec, substrate):
        super().__init__(spec, substrate)
        self.commit_k = (spec.async_commit if spec.async_commit is not None
                         else max(1, spec.nodes_per_round // 2))
        self.decay = spec.staleness_decay
        # the per-node arrival-time stream, from the cohort registry
        self.latency = flatency.make_model(spec)
        # fault injection + deadline semantics (pure in the checkpointed
        # dispatch counter, so nothing extra rides in the checkpoint)
        self.faults = ffaults.make_model(spec)
        self.deadline = getattr(spec, "round_deadline", None)
        self.clock = 0.0
        self.dispatched = 0
        # each entry: one node's in-flight upload + its arrival metadata
        self.entries: List[Dict[str, Any]] = []

    # latency streams are COUNTER-BASED — every registered model is pure
    # in (seed, node, dispatch) — so nothing about them needs
    # checkpointing and mid-buffer resume stays bit-exact under all
    def _latency(self, node: int, dispatch: int) -> float:
        return float(self.latency(node, dispatch))

    def _dispatch(self, session, wave: int = 0):
        """Send the next cohort to work against the CURRENT state.
        Returns ``(metrics, n_selected, n_buffered)`` — crashed nodes
        and deadline misses are selected but never buffered. ``wave``
        counts the re-dispatch waves of the current commit: each wave
        relaxes the deadline by ``retry_backoff`` (capped at
        ``max_retries`` relaxations), the async form of sync's retry."""
        d = self.dispatched
        session.state, cohort, received, metrics = phases.dispatch_round(
            self.substrate, session.state, session.round_key(d), d)
        sel, _, base_w = host_cohort(cohort)
        deadline = None
        if self.deadline is not None:
            deadline = self.deadline * self.spec.retry_backoff ** min(
                wave, self.spec.max_retries)
        n_buf = 0
        for i in range(sel.shape[0]):
            node = int(sel[i])
            c, drop, delay = (self.faults(node, d)
                              if self.faults is not None else ffaults.OK)
            if drop:
                continue
            lat = self._latency(node, d) * delay
            if deadline is not None and lat > deadline:
                continue
            up = phases.upload_slice(received, i)
            if c != 1.0:  # True for NaN too
                # the Byzantine coefficient perturbs the upload BEFORE
                # buffering, so checkpoints carry the poisoned payload
                # and mid-buffer resume needs no fault replay
                up = tree_map(lambda x: x * torch.tensor(
                    c, dtype=x.real.dtype, device=x.device), up)
            # the timeline is kept float32-REPRESENTABLE so arrival
            # times survive the checkpoint's array round-trip bit-exactly
            # (as the reference keeps them)
            self.entries.append({
                "arrival": float(np.float32(self.clock + lat)),
                "version": session.round,   # commits seen at dispatch
                "weight": float(base_w[i]),
                "node": node,
                "born": d,
                "up": up,
            })
            n_buf += 1
        self.dispatched += 1
        return metrics, sel.shape[0], n_buf

    def _commit(self, session, take) -> np.ndarray:
        """Aggregate the ``take`` entries, staleness-weighted; returns
        their staleness."""
        self.clock = max(self.clock, max(e["arrival"] for e in take))
        stale = np.asarray([session.round - e["version"] for e in take],
                           np.float64)
        w = np.asarray([e["weight"] for e in take], np.float64) \
            * self.decay ** stale
        w = w / max(w.sum(), 1e-12)
        received = phases.upload_stack([e["up"] for e in take])
        session.state = self.substrate.aggregate(
            session.state, received,
            torch.tensor(w, dtype=torch.float32,
                         device=tree_leaves(received)[0].device))
        return stale

    def step(self, session) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {}
        n_sel = n_buf = 0
        # dispatches needed to fill the buffer with NO losses; waves
        # beyond the first are the retry budget before failing loud
        base = max(1, -(-self.commit_k // self.spec.nodes_per_round))
        cap = (getattr(self.spec, "max_retries", 2) + 1) * base + 8
        dispatches = 0
        while len(self.entries) < self.commit_k:
            if dispatches >= cap:
                raise RuntimeError(
                    f"async commit starved: {dispatches} cohort "
                    f"dispatches filled only {len(self.entries)}/"
                    f"{self.commit_k} buffer slots — faults/deadline "
                    "drop (nearly) every upload; lower fault_rate, raise "
                    "round_deadline or max_retries, or lower async_commit")
            metrics, s, b = self._dispatch(session,
                                           wave=dispatches // base)
            n_sel += s
            n_buf += b
            dispatches += 1
        order = sorted(range(len(self.entries)),
                       key=lambda j: (self.entries[j]["arrival"],
                                      self.entries[j]["born"],
                                      self.entries[j]["node"]))
        take = [self.entries[j] for j in order[:self.commit_k]]
        keep = set(order[:self.commit_k])
        self.entries = [e for j, e in enumerate(self.entries)
                        if j not in keep]
        stale = self._commit(session, take)
        session.round += 1
        metrics = dict(metrics)
        metrics.update(sched_clock=self.clock,
                       sched_staleness=float(stale.mean()),
                       sched_buffered=float(len(self.entries)))
        if self.faults is not None or self.deadline is not None:
            metrics.update(n_selected=float(n_sel),
                           n_survived=float(n_buf),
                           n_quarantined=float(n_sel - n_buf),
                           n_retries=float(max(0, dispatches - base)))
        return metrics

    def flush(self, session) -> None:
        """Commit ALL buffered uploads in one final staleness-weighted
        aggregation (no new dispatches)."""
        if not self.entries:
            return
        take = sorted(self.entries,
                      key=lambda e: (e["arrival"], e["born"], e["node"]))
        self.entries = []
        # a drain, not a scheduled round: the round counter already
        # advanced when these uploads' commits were stepped
        self._commit(session, take)

    def state_flat(self) -> Dict[str, Any]:
        if self.dispatched == 0 and not self.entries:
            return {}
        flat: Dict[str, Any] = {
            "clock": np.float64(self.clock),
            "dispatched": np.int64(self.dispatched),
            "arrival": np.asarray([e["arrival"] for e in self.entries],
                                  np.float64),
            "version": np.asarray([e["version"] for e in self.entries],
                                  np.int64),
            "weight": np.asarray([e["weight"] for e in self.entries],
                                 np.float64),
            "node": np.asarray([e["node"] for e in self.entries],
                               np.int64),
            "born": np.asarray([e["born"] for e in self.entries],
                               np.int64),
            "up": {str(i): e["up"] for i, e in enumerate(self.entries)},
        }
        return flat

    def state_restore(self, flat: Dict[str, Any]) -> None:
        if not flat:
            return

        def host(k):
            return flat[k].cpu().numpy().reshape(-1)
        self.clock = float(host("clock")[0])
        self.dispatched = int(host("dispatched")[0])
        arrival, version, weight = host("arrival"), host("version"), \
            host("weight")
        node, born = host("node"), host("born")
        self.entries = []
        for i in range(arrival.shape[0]):
            pre = f"up/{i}/"
            up = self.substrate.upload_restore(
                {k[len(pre):]: v for k, v in flat.items()
                 if k.startswith(pre)})
            self.entries.append({
                "arrival": float(arrival[i]), "version": int(version[i]),
                "weight": float(weight[i]), "node": int(node[i]),
                "born": int(born[i]), "up": up,
            })


class OverlappedScheduler(Scheduler):
    """Staleness-1 pipelining: local phase t+1 overlaps aggregate t."""

    name = "overlapped"

    def __init__(self, spec, substrate):
        super().__init__(spec, substrate)
        # the one in-flight round: (stacked received uploads, weights)
        self.pending: Optional[Dict[str, Any]] = None

    def step(self, session) -> Dict[str, Any]:
        sub = self.substrate
        r = session.round
        # round r's fan-out is enqueued FIRST (it depends only on the
        # pre-aggregation state), then round r-1's aggregation commits
        state, cohort, received, metrics = phases.dispatch_round(
            sub, session.state, session.round_key(r), r)
        if self.pending is not None:
            state = sub.aggregate(state, self.pending["up"],
                                  self.pending["weights"])
        self.pending = {"up": received, "weights": cohort.weights,
                        "round": r}
        session.state = state
        session.round += 1
        metrics = dict(metrics)
        metrics["sched_pending"] = 1.0
        return metrics

    def flush(self, session) -> None:
        """Commit the pending round (drain the 1-deep pipeline)."""
        if self.pending is None:
            return
        session.state = self.substrate.aggregate(
            session.state, self.pending["up"], self.pending["weights"])
        self.pending = None

    def state_flat(self) -> Dict[str, Any]:
        if self.pending is None:
            return {}
        return {"pround": np.int64(self.pending["round"]),
                "pweights": self.pending["weights"],
                "up": self.pending["up"]}

    def state_restore(self, flat: Dict[str, Any]) -> None:
        if not flat:
            return
        up = self.substrate.upload_restore(
            {k[len("up/"):]: v for k, v in flat.items()
             if k.startswith("up/")})
        dev = self.substrate.device
        self.pending = {"up": up,
                        "weights": flat["pweights"].to(dev, torch.float32),
                        "round": int(flat["pround"])}


SCHEDULERS = {
    "sync": SyncScheduler,
    "async": AsyncScheduler,
    "overlapped": OverlappedScheduler,
}


def validate_schedule(name: str) -> str:
    if name not in SCHEDULERS:
        raise ValueError(f"unknown schedule {name!r}; registered: "
                         f"{sorted(SCHEDULERS)}")
    return name


def make_scheduler(spec, substrate) -> Scheduler:
    """Build the scheduler a spec names."""
    name = getattr(spec, "schedule", "sync")
    return SCHEDULERS[validate_schedule(name)](spec, substrate)
