"""Cohort-scale federation in the port: the declarative aggregation-tree
topology (``topology``, which ``FedSpec`` validates), the tree
aggregation itself (``hierarchy``: per-pod partials of the Eq. 6 chain
and the Eq. 8 sum, then the cross-pod merge, batched over the pods on
one card) and the latency models of the async scheduler's simulated
timeline (``latency``). ``topology`` and ``latency`` are numpy-only
copies of the reference's modules.
"""
from repro_torch.core.fed.cohort.topology import (  # noqa: F401
    ASSIGNMENTS, TOPOLOGIES, Topology, pod_perm, resolve_topology,
    validate_topology)
from repro_torch.core.fed.cohort.latency import (  # noqa: F401
    LATENCY_MODELS, LatencyModel, load_trace, make_model, validate_spec)
from repro_torch.core.fed.cohort import hierarchy  # noqa: F401
