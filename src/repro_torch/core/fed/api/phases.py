"""The phased round protocol — what ``Substrate.run_round`` is made of
(the port of ``repro.core.fed.api.phases``).

A federation round is four phases, and the server-side composition of a
round is DATA the session's scheduler owns instead of physics the
substrate hides:

    select(gen, round)                  -> Cohort
    local_update(state, cohort, gen)    -> (state', uploads, metrics)
    transmit(uploads, gen)              -> received
    aggregate(state, received, weights) -> state

* ``select`` — participation sampling + the round's Alg. 2 aggregation
  weights.
* ``local_update`` — the QuanFedNode fan-out / I_l local steps. It
  returns the post-local state alongside the uploads (node-side state
  commits at DISPATCH time); the quantum substrate returns its state
  unchanged, or with the certified engine's running error bound. It
  may CONSUME the state it is given: the classical substrate steps its
  per-node optimizer states in place (a full-width node's moments have
  no room for a second copy). A caller that dispatches twice from one
  state dispatches each time from ``snapshot(state)``, a copy of what
  the local phase consumes.
* ``transmit`` — the channel model (Hermitian noise, quantization) plus
  the strategy's wire cast.
* ``aggregate`` — the strategy combine into the global model (plus
  server-side outer momentum when the spec asks for it). ``received``
  may stack ANY number of uploads — the full cohort in a sync round, K
  buffered (possibly stale) uploads in an async commit.

An upload is a list of tensors, one per layer (quantum), or a dict of
deltas keyed like the model params (classical), each tensor with the
cohort's node axis first. ``split_round_key`` fixes each substrate's RNG
contract: the port's quantum round draws its selection, minibatches and
channel from ONE generator, in that order, so its split hands the
phases that same generator three times, and ``compose_round`` is the
fused round.

Schedulers hold uploads BETWEEN phases (async buffers, overlapped
pending rounds), so uploads must survive a checkpoint:
``upload_restore`` is the substrate-specific inverse of flattening one
upload through ``repro_torch.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Protocol, Sequence, Tuple

import torch

from repro_torch.optim.tree import tree_map


class Cohort(NamedTuple):
    """One round's selected nodes: indices, participation mask, paired
    aggregation weights (all (N_p,) tensors on the substrate's device),
    the round/dispatch index the cohort was drawn for, and — for
    substrates whose round data is selected per round — the cohort's
    local batches."""
    sel: torch.Tensor
    mask: torch.Tensor
    weights: torch.Tensor
    round: int
    data: Any = None


class PhasedSubstrate(Protocol):
    """A substrate that exposes the four round phases.

    ``run_round`` remains the canonical phase composition — substrates
    may fuse it — but the sequencing must match ``compose_round`` so
    sync scheduling is bit-compatible.
    """

    def split_round_key(self, key: int) -> Tuple[Any, Any, Any]:
        ...

    def select(self, gen: Any, round: int) -> Cohort:
        ...

    def local_update(self, state: Any, cohort: Cohort, gen: Any
                     ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        ...

    def snapshot(self, state: Any) -> Any:
        ...

    def transmit(self, uploads: Any, gen: Any) -> Any:
        ...

    def aggregate(self, state: Any, received: Any,
                  weights: torch.Tensor) -> Any:
        ...

    def upload_restore(self, flat: Dict[str, Any]) -> Any:
        ...


def dispatch_round(substrate: PhasedSubstrate, state: Any, key: int,
                   round: int
                   ) -> Tuple[Any, Cohort, Any, Dict[str, torch.Tensor]]:
    """The select -> local -> transmit PREFIX of a round: everything up
    to (but not including) the server commit. The single sequencing +
    key-split site shared by the canonical composition and by every
    scheduler that defers aggregation (async buffers, overlapped
    pipelining). Returns ``(post-local state, cohort, received,
    metrics)``."""
    g_sel, g_loc, g_tx = substrate.split_round_key(key)
    cohort = substrate.select(g_sel, round)
    state, uploads, metrics = substrate.local_update(state, cohort, g_loc)
    received = substrate.transmit(uploads, g_tx)
    return state, cohort, received, metrics


def compose_round(substrate: PhasedSubstrate, state: Any, key: int,
                  round: int) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The canonical phase composition — what ``run_round`` means."""
    state, cohort, received, metrics = dispatch_round(substrate, state,
                                                      key, round)
    return substrate.aggregate(state, received, cohort.weights), metrics


def upload_slice(uploads: Any, i: int) -> Any:
    """Node ``i``'s upload out of a stacked cohort upload."""
    return tree_map(lambda x: x[i], uploads)


def upload_stack(node_uploads: Sequence[Any]) -> Any:
    """Stack per-node uploads back into a cohort-style upload (the
    inverse of ``upload_slice`` over a list of entries)."""
    return tree_map(lambda *xs: torch.stack(xs), *node_uploads)
