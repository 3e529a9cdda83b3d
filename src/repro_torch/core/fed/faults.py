"""Deterministic fault injection for the federation timeline (the port's
own copy of ``repro.core.fed.faults``: numpy only, the same draws bit
for bit).

The QuantumFed paper's central experimental claim is robustness — yet a
benign simulator only ever models passive failure (dropout masking,
data pollution, channel noise). This registry makes ADVERSARIAL and
infrastructural failure first-class: a ``FaultModel`` perturbs the
transmit/aggregate boundary per (node, round), selected by
``FedSpec.fault_model``:

* ``"crash"``     — the upload never arrives: the node is dropped from
  the round (sync: its weight renormalizes over survivors; async: no
  buffer entry is ever born).
* ``"stale"``     — stale replay: the node re-sends an already-applied
  update, whose INCREMENTAL effect is the identity (a zero generator),
  while still occupying its aggregation slot at full weight — the
  round's weight mass is diluted, exactly what a replayed upload does.
* ``"corrupt"``   — the uploaded generators are NaN (bit-rot / a
  hostile node shipping garbage). Undefended aggregation goes NaN; the
  robust defenses (``FedSpec.defense``) quarantine it.
* ``"sign_flip"`` — Byzantine poisoning: the upload is scaled by
  ``-fault_scale`` (gradient-ascent attack on the Eq. 8 mean / Eq. 6
  product).
* ``"scale"``     — Byzantine amplification: the upload is scaled by
  ``+fault_scale`` (a dominating client).
* ``"slow"``      — the node's simulated upload latency is multiplied
  by ``fault_scale`` — composes with the ``cohort.latency``
  models, so slow nodes miss ``round_deadline`` / arrive stale in the
  async buffer.
* ``"trace"``     — replay an explicit committed fault schedule file
  (``fault_trace``; see ``load_fault_trace`` for the format).

Byzantine IDENTITY is persistent: ``corrupt`` / ``sign_flip`` /
``scale`` draw once per node (``rng([fault_seed, node])``), so a
hostile node is hostile every round it is sampled — the threat model
robust aggregation is defined against. Crash/stale/slow are transient
per (node, round) (``rng([fault_seed, node, round])``).

Every model is a PURE function of ``(fault_seed, node, round)`` (trace
replay is pure in the file contents) — mirroring the latency registry —
so schedulers checkpoint nothing fault-related and kill-and-resume
stays bit-exact with faults active mid-buffer.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# kind -> (upload coefficient, dropped, latency multiplier)
_EFFECTS: Dict[str, Callable[[float], Tuple[float, bool, float]]] = {
    "crash": lambda s: (1.0, True, 1.0),
    "stale": lambda s: (0.0, False, 1.0),
    "corrupt": lambda s: (float("nan"), False, 1.0),
    "sign_flip": lambda s: (-s, False, 1.0),
    "scale": lambda s: (s, False, 1.0),
    "slow": lambda s: (1.0, False, s),
}

# kinds whose draw fixes a per-node Byzantine identity (one uniform per
# node) rather than an independent per-round event
PERSISTENT = frozenset({"corrupt", "sign_flip", "scale"})

OK = (1.0, False, 1.0)


class FaultModel:
    """One fault stream: ``model(node, round) -> (coeff, drop, delay)``.

    ``coeff`` multiplies the node's uploaded generators/deltas (1.0 =
    honest), ``drop`` means the upload never arrives, ``delay``
    multiplies the node's simulated latency draw. ``round`` is the
    dispatch index under the async schedule — whatever counter the
    caller's key schedule is pure in.
    """

    name = "base"

    def __call__(self, node: int, round: int) -> Tuple[float, bool, float]:
        raise NotImplementedError

    def hits(self, node: int, round: int) -> bool:
        """True when this (node, round) is faulted at all."""
        return self(node, round) != OK


class DrawFault(FaultModel):
    """A primitive fault kind under an i.i.d. Bernoulli(rate) draw —
    persistent per node for the Byzantine kinds, per (node, round)
    otherwise (module docstring)."""

    def __init__(self, kind: str, rate: float, seed: int, scale: float):
        if kind not in _EFFECTS:
            raise ValueError(f"unknown fault kind {kind!r}; registered: "
                             f"{sorted(_EFFECTS)}")
        self.name = kind
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.scale = float(scale)

    def __call__(self, node: int, round: int) -> Tuple[float, bool, float]:
        ident = ([self.seed, int(node)] if self.kind in PERSISTENT
                 else [self.seed, int(node), int(round)])
        if np.random.default_rng(ident).uniform() >= self.rate:
            return OK
        return _EFFECTS[self.kind](self.scale)


_FAULT_TRACE_CACHE: Dict[str, Tuple[dict, dict]] = {}


def load_fault_trace(path: str) -> Tuple[Dict[Tuple[int, int], str],
                                         Dict[int, str]]:
    """Load (and cache) an explicit fault schedule file.

    Format — a JSON object with a ``faults`` list of events, each
    ``{"node": n, "kind": k}`` with an optional ``"round": r``::

        {"faults": [{"node": 3, "round": 5, "kind": "crash"},
                    {"node": 7, "kind": "sign_flip"}]}

    An event WITH a round fires at exactly that (node, round); one
    WITHOUT is persistent (every round — a standing Byzantine node).
    Kinds are the primitive registry kinds. Returns ``(scheduled,
    persistent)`` lookup dicts.
    """
    cached = _FAULT_TRACE_CACHE.get(path)
    if cached is not None:
        return cached
    if not os.path.exists(path):
        raise ValueError(f"fault_trace file not found: {path!r}")
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "faults" not in raw:
        raise ValueError(f"fault_trace {path!r}: expected a JSON object "
                         "with a 'faults' list of events")
    scheduled: Dict[Tuple[int, int], str] = {}
    persistent: Dict[int, str] = {}
    for i, ev in enumerate(raw["faults"]):
        if not isinstance(ev, dict) or "node" not in ev or "kind" not in ev:
            raise ValueError(f"fault_trace {path!r}: event {i} needs "
                             "'node' and 'kind'")
        kind = ev["kind"]
        if kind not in _EFFECTS:
            raise ValueError(f"fault_trace {path!r}: event {i} has unknown "
                             f"kind {kind!r}; registered: {sorted(_EFFECTS)}")
        node = int(ev["node"])
        if node < 0:
            raise ValueError(f"fault_trace {path!r}: event {i} has a "
                             "negative node")
        if "round" in ev and ev["round"] is not None:
            scheduled[(node, int(ev["round"]))] = kind
        else:
            persistent[node] = kind
    out = (scheduled, persistent)
    _FAULT_TRACE_CACHE[path] = out
    return out


class TraceFault(FaultModel):
    """Replay a committed fault schedule — deterministic in the file
    contents alone (no RNG draw at all)."""

    name = "trace"

    def __init__(self, path: str, scale: float):
        self.path = path
        self.scale = float(scale)
        self.scheduled, self.persistent = load_fault_trace(path)

    def __call__(self, node: int, round: int) -> Tuple[float, bool, float]:
        kind = self.scheduled.get((int(node), int(round)))
        if kind is None:
            kind = self.persistent.get(int(node))
        if kind is None:
            return OK
        return _EFFECTS[kind](self.scale)


FAULTS: Dict[str, Callable[..., FaultModel]] = {
    **{k: (lambda spec, _k=k: DrawFault(_k, spec.fault_rate,
                                        spec.fault_seed, spec.fault_scale))
       for k in _EFFECTS},
    "trace": lambda spec: TraceFault(spec.fault_trace, spec.fault_scale),
}


def validate_spec(spec: Any) -> None:
    """Fail-loud validation of the FedSpec fault knobs (eagerly parses a
    named fault trace so a bad schedule fails at spec construction)."""
    name = getattr(spec, "fault_model", None)
    if name is None:
        if spec.fault_rate != 0.0:
            raise ValueError(f"fault_rate={spec.fault_rate} without a "
                             "fault_model — set fault_model to inject "
                             "faults")
        if spec.fault_trace is not None:
            raise ValueError("fault_trace without fault_model='trace'")
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault_model {name!r}; registered: "
                         f"{sorted(FAULTS)}")
    if not spec.fault_scale > 0.0:
        raise ValueError(f"fault_scale must be > 0, got {spec.fault_scale}")
    if name == "trace":
        if not spec.fault_trace:
            raise ValueError("fault_model='trace' requires fault_trace "
                             "(path to a fault schedule file)")
        if spec.fault_rate != 0.0:
            raise ValueError("fault_rate is meaningless with "
                             "fault_model='trace' (events are explicit)")
        load_fault_trace(spec.fault_trace)
        return
    if spec.fault_trace is not None:
        raise ValueError(f"fault_trace is only meaningful with "
                         f"fault_model='trace' (got {name!r})")
    if not 0.0 < spec.fault_rate <= 1.0:
        raise ValueError(f"fault_model={name!r} needs fault_rate in "
                         f"(0, 1], got {spec.fault_rate}")
    if (name == "slow" and spec.schedule == "sync"
            and spec.round_deadline is None):
        raise ValueError(
            "fault_model='slow' multiplies simulated latency — it needs a "
            "timeline: schedule='async' or a round_deadline")


def make_model(spec: Any) -> Optional[FaultModel]:
    """Build the fault model a spec names; None when faults are off."""
    name = getattr(spec, "fault_model", None)
    if name is None:
        return None
    if name not in FAULTS:
        raise ValueError(f"unknown fault_model {name!r}; registered: "
                         f"{sorted(FAULTS)}")
    return FAULTS[name](spec)
