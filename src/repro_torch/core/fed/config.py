"""Configuration for classical federated / local-SGD training (the
port's own copy of ``repro.core.fed.config``, which ``FedSpec`` builds and
``fed_step.fed_train_round`` runs)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """QuantumFed hyperparameters mapped to the classical substrate.

    num_nodes / nodes_per_round: N and N_p of Alg. 2. In multi-pod
    training the nodes ARE the pods (num_nodes = mesh pod-axis size) and
    every pod participates in every round (node subsampling is a
    single-host simulation feature).
    interval_length: I_l of Alg. 1 — local optimizer steps between
    cross-node aggregations. I_l=1 reproduces synchronous data-parallel
    training exactly (the paper's §III-C observation).
    participation / dropout_rate: node-selection schedule (see
    repro_torch.core.fed.participation — the registry shared with the
    quantum stack): "uniform" (Alg. 2 step 3), "weighted" (by data
    volume), or "dropout" (straggler masking at the given rate).
    """
    num_nodes: int = 2
    nodes_per_round: int = 2
    interval_length: int = 1
    # Aggregation strategy name resolved through
    # repro_torch.core.fed.strategies: 'average' = Lemma-1 additive delta
    # aggregation (FedAvg / the paper's Eq. 8) with data-volume weights
    # from node token counts; 'served' = the same over a compressed
    # (bf16) wire. 'product' is quantum-only and rejected here.
    aggregation: str = "average"
    participation: str = "uniform"
    dropout_rate: float = 0.0
    # outer step scaling (1.0 = plain FedAvg; <1 damps, >1 Nesterov-ish)
    outer_lr: float = 1.0
    # dtype of the uploaded deltas. bf16 halves the cross-node traffic
    # (beyond-paper: quantized FedAvg; delta magnitudes are small and
    # the fp32 master copy is reconstructed server-side, so the paper's
    # Lemma-1 O(eps^2) error argument still dominates the bf16 rounding)
    delta_dtype: str = "float32"
