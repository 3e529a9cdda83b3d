"""Latency models for the simulated federation timeline (the port's own
copy of ``repro.core.fed.cohort.latency``: numpy only, the same floats
bit for bit).

The async/overlapped schedulers stamp every dispatched upload with a
simulated arrival time. This module turns the latency draw into a
pluggable ``LatencyModel`` registry selected by ``FedSpec.latency_model``:

* ``"counter"``   — the original synthetic streams, bit-compatible: a
  persistent per-node lognormal(0, 0.5) speed times an exponential
  per-dispatch draw, both from ``numpy`` ``SeedSequence`` on
  ``(latency_seed, node[, dispatch])``.
* ``"lognormal"`` — parametric heterogeneous clients: a persistent
  per-node lognormal(``latency_mu``, ``latency_sigma``) speed times a
  lognormal(0, ``latency_sigma``) per-dispatch jitter.
* ``"pareto"``    — heavy-tailed stragglers: a persistent per-node
  lognormal(0, 0.25) speed times ``1 + Pareto(latency_alpha)`` per
  dispatch; smaller ``latency_alpha`` → fatter straggler tail
  (``latency_alpha`` must exceed 1 so the mean exists).
* ``"trace"``     — replay of a committed trace file
  (``latency_trace``): measured per-client latency rows assigned to
  nodes round-robin (node ``n`` plays row ``n % clients``, dispatch
  ``d`` plays sample ``d % len(row)``). See ``load_trace`` for the
  format; ``benchmarks/traces/tiny_lognormal.json`` is a committed
  example.

Every model is COUNTER-BASED — a pure function of
``(latency_seed, node, dispatch)`` (trace replay is pure in the file
contents) — so the scheduler checkpoints nothing latency-related and
mid-buffer kill-and-resume stays bit-exact under all of them.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List

import numpy as np

LATENCY_PARAM_DEFAULTS = {
    "latency_mu": 0.0,
    "latency_sigma": 0.5,
    "latency_alpha": 1.5,
}


class LatencyModel:
    """One latency stream: ``model(node, dispatch) -> seconds``."""

    name = "base"

    def __call__(self, node: int, dispatch: int) -> float:
        raise NotImplementedError


class CounterLatency(LatencyModel):
    """The original synthetic streams, reproduced bit-exactly."""

    name = "counter"

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, node: int, dispatch: int) -> float:
        speed = np.random.default_rng(
            [self.seed, node]).lognormal(mean=0.0, sigma=0.5)
        draw = np.random.default_rng(
            [self.seed, node, dispatch]).exponential()
        return float(speed * draw)


class LognormalLatency(LatencyModel):
    name = "lognormal"

    def __init__(self, seed: int, mu: float, sigma: float):
        if not sigma > 0.0:
            raise ValueError(f"latency_sigma must be > 0, got {sigma}")
        self.seed, self.mu, self.sigma = int(seed), float(mu), float(sigma)

    def __call__(self, node: int, dispatch: int) -> float:
        speed = np.random.default_rng(
            [self.seed, node]).lognormal(mean=self.mu, sigma=self.sigma)
        draw = np.random.default_rng(
            [self.seed, node, dispatch]).lognormal(mean=0.0, sigma=self.sigma)
        return float(speed * draw)


class ParetoLatency(LatencyModel):
    name = "pareto"

    def __init__(self, seed: int, alpha: float):
        if not alpha > 1.0:
            raise ValueError(
                f"latency_alpha must be > 1 (finite mean), got {alpha}")
        self.seed, self.alpha = int(seed), float(alpha)

    def __call__(self, node: int, dispatch: int) -> float:
        speed = np.random.default_rng(
            [self.seed, node]).lognormal(mean=0.0, sigma=0.25)
        draw = 1.0 + np.random.default_rng(
            [self.seed, node, dispatch]).pareto(self.alpha)
        return float(speed * draw)


_TRACE_CACHE: Dict[str, List[List[float]]] = {}


def load_trace(path: str) -> List[List[float]]:
    """Load (and cache) a latency trace file.

    Format — JSON object with a ``clients`` list of per-client latency
    rows (seconds, strictly positive), e.g.::

        {"unit": "s", "clients": [[0.8, 1.1, 0.9], [2.4, 3.1], ...]}

    Each row is one measured client; rows may have different lengths
    and are replayed cyclically per dispatch.
    """
    cached = _TRACE_CACHE.get(path)
    if cached is not None:
        return cached
    if not os.path.exists(path):
        raise ValueError(f"latency_trace file not found: {path!r}")
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "clients" not in raw:
        raise ValueError(
            f"latency_trace {path!r}: expected a JSON object with a "
            "'clients' list of per-client latency rows")
    clients = raw["clients"]
    if not clients:
        raise ValueError(f"latency_trace {path!r}: empty 'clients' list")
    rows: List[List[float]] = []
    for i, row in enumerate(clients):
        if not row:
            raise ValueError(f"latency_trace {path!r}: client {i} is empty")
        vals = [float(v) for v in row]
        if any(not v > 0.0 for v in vals):
            raise ValueError(
                f"latency_trace {path!r}: client {i} has a non-positive "
                "latency sample")
        rows.append(vals)
    _TRACE_CACHE[path] = rows
    return rows


class TraceLatency(LatencyModel):
    """Replay measured per-client latencies with round-robin node
    assignment — deterministic in the file contents alone."""

    name = "trace"

    def __init__(self, path: str):
        self.path = path
        self.rows = load_trace(path)

    def __call__(self, node: int, dispatch: int) -> float:
        row = self.rows[node % len(self.rows)]
        return row[dispatch % len(row)]


LATENCY_MODELS: Dict[str, Callable[..., LatencyModel]] = {
    "counter": lambda spec: CounterLatency(spec.latency_seed),
    "lognormal": lambda spec: LognormalLatency(
        spec.latency_seed, spec.latency_mu, spec.latency_sigma),
    "pareto": lambda spec: ParetoLatency(spec.latency_seed,
                                         spec.latency_alpha),
    "trace": lambda spec: TraceLatency(spec.latency_trace),
}


def validate_spec(spec: Any) -> None:
    """Fail-loud validation of the FedSpec latency knobs (also eagerly
    parses + validates a named trace file so a bad trace fails at spec
    construction, not mid-run)."""
    name = spec.latency_model
    if name not in LATENCY_MODELS:
        raise ValueError(f"unknown latency_model {name!r}; registered: "
                         f"{sorted(LATENCY_MODELS)}")
    if name == "trace":
        if not spec.latency_trace:
            raise ValueError("latency_model='trace' requires latency_trace "
                             "(path to a trace file)")
        load_trace(spec.latency_trace)
    elif spec.latency_trace is not None:
        raise ValueError(
            f"latency_trace is only meaningful with latency_model='trace' "
            f"(got latency_model={name!r})")
    if name == "lognormal" and not spec.latency_sigma > 0.0:
        raise ValueError(
            f"latency_sigma must be > 0, got {spec.latency_sigma}")
    if name == "pareto" and not spec.latency_alpha > 1.0:
        raise ValueError(f"latency_alpha must be > 1 (finite mean), got "
                         f"{spec.latency_alpha}")


def make_model(spec: Any) -> LatencyModel:
    """Build the latency model a spec names (defaults preserve the
    original counter streams for specs predating the registry)."""
    name = getattr(spec, "latency_model", "counter")
    if name not in LATENCY_MODELS:
        raise ValueError(f"unknown latency_model {name!r}; registered: "
                         f"{sorted(LATENCY_MODELS)}")
    return LATENCY_MODELS[name](spec)
