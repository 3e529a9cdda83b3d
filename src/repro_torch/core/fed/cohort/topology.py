"""Declarative aggregation-tree topology for cohort-scale federation
(the port's own copy of ``repro.core.fed.cohort.topology``; the tree
aggregation itself is ``hierarchy``).

A federation round aggregates ``nodes_per_round`` local updates. The
default topology is ``"flat"``: one combiner pass over every sampled
node (Eq. 6 product chain / Eq. 8 weighted average). ``"two_level"``
interposes a pod tier — nodes → pods → root: each pod computes a
partial combine over its members, and a single cross-pod combine
closes the round. Because both registry combiners are associative
reassociations (a matrix product chain, a weighted sum), the two-level
tree is mathematically exact — it matches flat aggregation to float
round-off (the reference gates that at <=1e-10).

``pod_assignment`` decides which sampled slot lands in which pod:

* ``"block"``   — pod ``p`` owns the contiguous slots
  ``[p*per, (p+1)*per)``. Order-preserving, so it is valid for the
  order-sensitive product combine (Eq. 6 multiplies updates in slot
  order) as well as the average.
* ``"strided"`` — pod ``p`` owns slots ``p, p+pods, p+2*pods, ...``.
  Reorders the chain, so it is only valid for commutative combines
  (average); requesting it with the product combine fails loudly.

Everything here is host-side: a ``Topology`` is a small
frozen dataclass derived from ``FedSpec``/``QuantumFedConfig`` fields,
validated fail-loud at spec construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

TOPOLOGIES = ("flat", "two_level")
ASSIGNMENTS = ("block", "strided")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A resolved two-level tree: ``pods`` pods over the sampled cohort."""

    pods: int
    assignment: str = "block"

    def pod_size(self, n: int) -> int:
        if n % self.pods:
            raise ValueError(
                f"two_level topology: {n} sampled nodes do not split into "
                f"{self.pods} equal pods")
        return n // self.pods


def validate_topology(topology: str, pods: Optional[int], assignment: str,
                      *, nodes_per_round: int, combine: Optional[str] = None,
                      schedule: Optional[str] = None,
                      async_commit: Optional[int] = None) -> None:
    """Fail-loud validation of the FedSpec topology knobs.

    ``combine`` is the aggregation strategy's combine mode ("product" /
    "average"), used to reject order-breaking assignments; ``schedule``
    + ``async_commit`` gate the async commit size against the pod count
    (an async commit aggregates ``async_commit`` uploads, which must
    still split into equal pods).
    """
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {TOPOLOGIES}")
    if assignment not in ASSIGNMENTS:
        raise ValueError(
            f"unknown pod_assignment {assignment!r}; "
            f"expected one of {ASSIGNMENTS}")
    if topology == "flat":
        if pods is not None:
            raise ValueError(
                "pods is a two_level knob; leave it None for topology='flat'")
        return
    if pods is None:
        raise ValueError("topology='two_level' requires pods")
    if not isinstance(pods, int) or isinstance(pods, bool):
        raise ValueError(f"pods must be an int, got {pods!r}")
    if not 2 <= pods <= nodes_per_round:
        raise ValueError(
            f"pods={pods} out of range: need 2 <= pods <= "
            f"nodes_per_round={nodes_per_round}")
    if nodes_per_round % pods:
        raise ValueError(
            f"pods={pods} must divide nodes_per_round={nodes_per_round} "
            "(equal-size pods)")
    if combine == "product" and assignment != "block":
        raise ValueError(
            "pod_assignment='strided' reorders the Eq. 6 product chain; "
            "the product combine requires pod_assignment='block'")
    if schedule == "async":
        commit = async_commit if async_commit else max(1, nodes_per_round // 2)
        if commit % pods:
            raise ValueError(
                f"topology='two_level' under schedule='async' aggregates "
                f"{commit} buffered uploads per commit, which pods={pods} "
                "does not divide; pick async_commit as a multiple of pods")


def resolve_topology(topology: str, pods: Optional[int],
                     assignment: str = "block") -> Optional[Topology]:
    """The static ``Topology`` for a validated spec — ``None`` for flat."""
    if topology == "flat":
        return None
    return Topology(pods=int(pods), assignment=assignment)


def pod_perm(n: int, pods: int, assignment: str) -> np.ndarray:
    """Index permutation grouping ``n`` slots pod-major.

    ``x[pod_perm(n, pods, a)].reshape(pods, n // pods, ...)`` puts pod
    ``p``'s members in row ``p`` in their within-pod order.
    """
    if n % pods:
        raise ValueError(f"{n} slots do not split into {pods} equal pods")
    idx = np.arange(n)
    if assignment == "block":
        return idx
    if assignment == "strided":
        return idx.reshape(n // pods, pods).T.reshape(-1)
    raise ValueError(
        f"unknown pod_assignment {assignment!r}; expected one of {ASSIGNMENTS}")
