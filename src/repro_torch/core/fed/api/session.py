"""``FederationSession`` — a drivable, checkpointable federation (the
port of ``repro.core.fed.api.session``).

One session = one federation run over a ``Substrate``: ``step()`` runs
a single QuanFedPS round under the spec's SCHEDULER (``"sync"``
lock-step, ``"async"`` staleness-weighted buffered commits,
``"overlapped"`` pipelined dispatch — see ``repro_torch.core.fed.api.
scheduler``; the async timeline's client latencies come from the
``FedSpec.latency_model`` registry in ``repro_torch.core.fed.cohort.
latency``), ``run(rounds, callbacks=...)`` drives many with a small
hook system (metric streaming, eval-every, early stop, periodic
checkpoints), ``save(path)`` writes spec + round + RNG state +
substrate state + in-flight scheduler state (async buffers and all)
through ``repro_torch.checkpoint`` in the reference's format, and
``FederationSession.resume(path)`` reconstructs the session onto
``device`` and continues BIT-exactly — the resumed run and the
uninterrupted run are indistinguishable.

RNG contract: a key is an int (``repro_torch.core.fed.api.rng``). The
round key for round ``t`` is a pure function of the session's
checkpointed base key and ``t`` — ``rng.fold_in(base, t)``; an explicit
``round_keys`` plan (a sequence of int keys) overrides it for rounds it
covers (``create(..., rounds=n)`` installs ``rng.split(k_loop, n)``,
``sequential_split_plan`` another). Each round draws from a fresh
generator seeded with its key, so purity in ``t`` is what makes
kill-and-resume exact. The port's trajectories are its OWN: the same
seed does not give the reference's keys, so under uniform selection (or
minibatches, or a random channel) the port's cohorts and draws differ
from the reference's. The two packages meet exactly only where a round
draws nothing (``participation="full"``, GD, the identity channel).

A checkpoint written by the reference's session resumes here too
(formats 1-3): spec, round counter, history, params, server momentum,
the certified error bound and the schedulers' in-flight uploads load as
they are, so ``evaluate`` agrees with the reference's on the same file.
Its ``rng/base`` is a JAX key, which no torch stream reproduces: rounds
run after such a resume draw from the port's stream, keyed
deterministically by the key's words (``rng.from_key_words``). The
port marks its own checkpoints (``extra["rng"]``) to tell them apart.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.core.fed.api import rng
from repro_torch.core.fed.api.scheduler import Scheduler, make_scheduler
from repro_torch.core.fed.api.spec import FedSpec
from repro_torch.core.fed.api.substrate import (Substrate, host_floats,
                                                make_substrate)

CKPT_FORMAT = 3  # 3: + "round" counter leaf; readable as 2 / 1
# the marker of the port's checkpoints: their RNG leaves are int keys
RNG_SCHEME = "repro_torch.splitmix64"


def sequential_split_plan(key: int, rounds: int) -> List[int]:
    """A sequential key stream: ``key, k = split(key)`` per round —
    pass as ``round_keys`` to reproduce it exactly."""
    ks = []
    for _ in range(rounds):
        key, k = rng.split(key)
        ks.append(k)
    return ks


class Callback:
    """Session hook — subclass and override what you need."""

    def on_run_begin(self, session: "FederationSession") -> None:
        pass

    def on_round_end(self, session: "FederationSession",
                     metrics: Dict[str, Any]) -> None:
        pass

    def on_run_end(self, session: "FederationSession") -> None:
        pass


class MetricStream(Callback):
    """Stream per-round training metrics to a sink (default: print),
    copied to the host in one transfer a round."""

    def __init__(self, sink: Optional[Callable[[int, Dict], None]] = None):
        self.sink = sink

    def on_round_end(self, session, metrics):
        if not metrics:
            return
        host = host_floats(metrics)
        if self.sink is None:
            parts = "  ".join(f"{k} {v:.4f}" for k, v in host.items())
            print(f"round {session.round:4d}  {parts}")
        else:
            self.sink(session.round, host)


class EvalEvery(Callback):
    """Record ``substrate.evaluate`` into the session history at round 0,
    every ``every`` rounds, and — with ``final=True``, the legacy
    ``fed.train`` eval schedule — at the end of the run.

    The ``final`` record fires at EVERY ``run()`` boundary. When
    splitting one logical training run across several ``run()`` calls
    (checkpoint/resume mid-stream), either align the split with
    ``every`` or pass ``final=False`` on the non-final segments —
    otherwise the stitched history carries an extra boundary record the
    uninterrupted run would not have (state and RNG are unaffected)."""

    def __init__(self, every: int = 1, verbose: bool = False,
                 final: bool = True):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = every
        self.verbose = verbose
        self.final = final

    def _record(self, session):
        it = session.history.get("iteration")
        if it and it[-1] == session.round:
            return  # already recorded this round
        session.record_eval(verbose=self.verbose)

    def on_run_begin(self, session):
        if session.round == 0 and not session.history.get("iteration"):
            self._record(session)

    def on_round_end(self, session, metrics):
        if (session.round % self.every == 0
                or (self.final and session.round == session.run_target)):
            self._record(session)


class EarlyStop(Callback):
    """Stop the run once an evaluated metric crosses a target (e.g. the
    paper's fidelity ~1 plateau). Checks fresh evals only — pair with
    ``EvalEvery``."""

    def __init__(self, metric: str = "test_fidelity", target: float = 0.99,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max'|'min', got {mode!r}")
        self.metric = metric
        self.target = target
        self.mode = mode
        self._seen = -1

    def on_round_end(self, session, metrics):
        it = session.history.get("iteration")
        if not it or it[-1] == self._seen or not session.last_eval:
            return
        self._seen = it[-1]
        v = session.last_eval.get(self.metric)
        if v is None:
            return
        hit = v >= self.target if self.mode == "max" else v <= self.target
        if hit:
            session.request_stop()


class Checkpointer(Callback):
    """``session.save(path)`` every ``every`` rounds and at run end."""

    def __init__(self, path: str, every: int = 1, final: bool = True):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = path
        self.every = every
        self.final = final
        self._saved_round = None

    def _save(self, session):
        if session.round != self._saved_round:
            session.save(self.path)
            self._saved_round = session.round

    def on_round_end(self, session, metrics):
        if session.round % self.every == 0:
            self._save(session)

    def on_run_end(self, session):
        if self.final:
            self._save(session)


def _host_key(x) -> int:
    """An int key from a checkpoint leaf: the port's int64 key as it is,
    a reference JAX key (two uint32 words) through its words."""
    arr = x.cpu().numpy()
    return int(arr) if arr.ndim == 0 else rng.from_key_words(arr)


def _host_plan(x, port: bool) -> List[int]:
    """The round-key plan of a checkpoint: the port's int64 keys, or a
    reference plan of JAX keys (n, 2) through their words."""
    arr = x.cpu().numpy()
    if port:
        return [int(k) for k in arr.reshape(-1)]
    return [rng.from_key_words(row) for row in arr.reshape(arr.shape[0], -1)]


class FederationSession:
    """See module docstring. Build with ``create`` (fresh) or ``resume``
    (from a checkpoint); ``__init__`` is the raw constructor."""

    def __init__(self, spec: FedSpec, substrate: Substrate, *,
                 key: int, state: Any, round: int = 0,
                 history: Optional[Dict[str, list]] = None,
                 round_keys: Optional[Sequence[int]] = None,
                 scheduler: Optional[Scheduler] = None):
        self.spec = spec
        self.substrate = substrate
        self.key = int(key)
        self.state = state
        self.round = round
        self.history: Dict[str, list] = history if history is not None \
            else {}
        self.round_keys = None if round_keys is None else \
            [int(k) for k in round_keys]
        self.scheduler = scheduler if scheduler is not None else \
            make_scheduler(spec, substrate)
        self.last_eval: Dict[str, float] = {}
        self.run_target: Optional[int] = None
        self._stop = False

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, spec: FedSpec, key: int,
               substrate: Optional[Substrate] = None, params: Any = None,
               rounds: Optional[int] = None,
               round_keys: Optional[Sequence[int]] = None,
               device="cuda") -> "FederationSession":
        """Fresh session: split ``key`` into (init, loop); with ``rounds``
        given, the pre-split round-key plan ``rng.split(k_loop, rounds)``
        is installed. The substrate is built from the spec on ``device``
        unless one is passed (it then keeps its own device)."""
        substrate = substrate if substrate is not None else \
            make_substrate(spec, device=device)
        k_init, k_loop = rng.split(key)
        state = substrate.init_state(k_init, params=params)
        if rounds is not None and round_keys is None:
            round_keys = rng.split(k_loop, rounds)
        return cls(spec, substrate, key=k_loop, state=state,
                   round_keys=round_keys)

    @classmethod
    def resume(cls, path: str, substrate: Optional[Substrate] = None,
               device="cuda") -> "FederationSession":
        """Rebuild a session from ``save`` output (the port's or the
        reference's) and continue bit-exact. The substrate is rebuilt
        from the spec inside the checkpoint on ``device`` unless one is
        passed (for data the spec cannot describe); the state and the
        in-flight uploads are restored onto the substrate's device."""
        flat, meta = ckpt.restore(path, device="cpu")
        extra = meta.get("extra", {})
        if "fed_spec" not in extra:
            raise ValueError(f"{path} is not a FederationSession "
                             "checkpoint (no fed_spec in metadata)")
        spec = FedSpec.from_json(extra["fed_spec"])
        substrate = substrate if substrate is not None else \
            make_substrate(spec, device=device)
        state = substrate.state_restore(
            {k[len("state/"):]: v for k, v in flat.items()
             if k.startswith("state/")})
        port = extra.get("rng") == RNG_SCHEME
        plan = (_host_plan(flat["rng/plan"], port) if "rng/plan" in flat
                else None)
        # the round counter is a state LEAF (format 3); older
        # checkpoints carry it only as the npz metadata step
        rnd = (int(flat["round"]) if "round" in flat
               else int(meta.get("step", 0)))
        sess = cls(spec, substrate, key=_host_key(flat["rng/base"]),
                   state=state, round=rnd,
                   history={k: list(v)
                            for k, v in extra.get("history", {}).items()},
                   round_keys=plan)
        # in-flight scheduler state (async buffers, overlapped pending)
        sess.scheduler.state_restore(
            {k[len("sched/"):]: v for k, v in flat.items()
             if k.startswith("sched/")})
        return sess

    # -- per-session state as a pure tree -------------------------------
    # The round counter is a CHECKPOINTABLE LEAF (np.int32), not a bare
    # Python int: together with the RNG base key and the substrate's
    # state_flat, the whole per-session state is one tree — which is
    # what rides in the checkpoint (and not only in the npz metadata).
    @property
    def round(self) -> int:
        return int(self._round)

    @round.setter
    def round(self, value) -> None:
        self._round = np.int32(value)

    def state_pytree(self) -> Dict[str, Any]:
        """The session's complete evolving state as ONE tree: substrate
        state leaves + RNG base key (+ optional round-key plan) + round
        counter + in-flight scheduler state. This is the exact tree
        ``save`` writes; spec / history / wall-time are metadata, not
        state."""
        tree: Dict[str, Any] = {
            "state": self.substrate.state_flat(self.state),
            "rng": {"base": np.int64(self.key)},
            "round": np.asarray(self._round),
        }
        if self.round_keys is not None:
            tree["rng"]["plan"] = np.asarray(self.round_keys, np.int64)
        sched = self.scheduler.state_flat()
        if sched:  # in-flight uploads ride in the checkpoint
            tree["sched"] = sched
        return tree

    # -- driving --------------------------------------------------------
    def round_key(self, t: int) -> int:
        """Round ``t``'s key — pure in (checkpointed RNG state, t)."""
        if self.round_keys is not None and t < len(self.round_keys):
            return self.round_keys[t]
        return rng.fold_in(self.key, t)

    def step(self) -> Dict[str, Any]:
        """One federation round — one server COMMIT under the spec's
        scheduler; returns the round metrics."""
        return self.scheduler.step(self)

    @property
    def sim_clock(self) -> Optional[float]:
        """The scheduler's simulated wall-clock — seconds of modeled
        client latency (``FedSpec.latency_model``; see ``repro_torch.
        core.fed.cohort.latency``) advanced so far. None for schedulers
        without a timeline ("sync")."""
        clock = getattr(self.scheduler, "clock", None)
        return None if clock is None else float(clock)

    def run(self, rounds: int, callbacks: Iterable[Callback] = ()
            ) -> Dict[str, list]:
        """Drive ``rounds`` rounds through the hook system; returns the
        (possibly eval-extended) metric history."""
        cbs: List[Callback] = list(callbacks)
        self.run_target = self.round + rounds
        self._stop = False
        for cb in cbs:
            cb.on_run_begin(self)
        while self.round < self.run_target and not self._stop:
            metrics = self.step()
            for cb in cbs:
                cb.on_round_end(self, metrics)
        for cb in cbs:
            cb.on_run_end(self)
        self.run_target = None
        return self.history

    def request_stop(self) -> None:
        """Ask ``run`` to stop after the current round (early-stop hook)."""
        self._stop = True

    def flush(self) -> None:
        """Drain the scheduler's deferred work (the overlapped pipeline's
        pending round, the async buffer's in-flight uploads) WITHOUT
        dispatching new cohorts. Explicit by design — never part of
        ``run`` — so a run split across checkpoint/resume stays
        bit-identical to the uninterrupted one. No-op under "sync"."""
        self.scheduler.flush(self)

    # -- evaluation / history -------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """Substrate metrics for the CURRENT state (one host sync)."""
        return self.substrate.evaluate(self.state)

    def record_eval(self, verbose: bool = False) -> Dict[str, float]:
        """Evaluate and append to ``history`` under ``iteration`` =
        current round."""
        m = self.evaluate()
        self.history.setdefault("iteration", []).append(self.round)
        for k, v in m.items():
            self.history.setdefault(k, []).append(v)
        self.last_eval = m
        if verbose:
            parts = "  ".join(f"{k} {v:.4f}" for k, v in m.items())
            print(f"iter {self.round:4d}  {parts}")
        return m

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """Write spec + the session state tree (round counter and RNG
        included as leaves) through ``repro_torch.checkpoint`` (atomic,
        fsynced npz + json sidecar, tensors copied to the host)."""
        tree = self.state_pytree()
        extra = {
            "fed_spec": self.spec.to_json_dict(),
            "history": self.history,
            "format": CKPT_FORMAT,
            "rng": RNG_SCHEME,
            "wall_time": time.time(),
        }
        ckpt.save(path, tree, step=self.round, extra=extra)
