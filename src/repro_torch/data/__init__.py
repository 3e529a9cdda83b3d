"""Synthetic data and federated partitioning (the port of
``repro.data``): the Bigram token stream and the sort-based non-iid /
seeded iid node splits of the classical federation."""
from repro_torch.data.partition import (  # noqa: F401
    node_token_counts, partition_iid, partition_non_iid)
from repro_torch.data.synthetic import BigramTask, token_batches  # noqa: F401
