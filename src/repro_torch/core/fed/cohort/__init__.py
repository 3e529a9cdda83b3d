"""Cohort-scale federation in the port: the declarative aggregation-tree
topology (``topology``, which ``FedSpec`` validates) and the latency
models of the async scheduler's simulated timeline (``latency``). Both
are numpy-only copies of the reference's modules. The tree aggregation
itself (the reference's ``hierarchy``) is not ported yet.
"""
from repro_torch.core.fed.cohort.topology import (  # noqa: F401
    ASSIGNMENTS, TOPOLOGIES, Topology, pod_perm, resolve_topology,
    validate_topology)
from repro_torch.core.fed.cohort.latency import (  # noqa: F401
    LATENCY_MODELS, LatencyModel, load_trace, make_model, validate_spec)
