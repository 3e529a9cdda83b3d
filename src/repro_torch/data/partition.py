"""Federated data partitioning for classical streams (the port of
``repro.data.partition``): the paper's sort-based non-iid split applied
to token data. Sequences are sorted by a content key (the leading
token) and divided contiguously, so each node sees a skewed slice of the
distribution.

Unequal node volumes: both partitions accept explicit per-node sequence
counts ``node_seqs``. Nodes are padded to the largest count by cycling
their OWN sequences (oversampling real data, never garbage), batches
stay rectangular for the node pass, and the TRUE counts travel as the
``"n_seqs"`` entry so ``node_token_counts`` — and through it the Alg. 2
data-volume weights and "weighted" participation — see the real volumes
N_n.

The index work is numpy, as in the reference, so a batch gives the
reference's node shards element for element; the gathers run on the
batch's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _unequal_index(order: np.ndarray, node_seqs) -> np.ndarray:
    """(num_nodes, max_size) gather index for an UNEQUAL contiguous
    split of ``order``: node i owns the next ``node_seqs[i]`` sequences,
    padded to the largest size by cycling its own sequences."""
    sizes = [int(s) for s in node_seqs]
    if not all(s > 0 for s in sizes):
        raise ValueError(f"node_seqs must be positive, got {sizes}")
    if sum(sizes) > order.shape[0]:
        raise ValueError(f"node_seqs {sizes} ask for {sum(sizes)} "
                         f"sequences; the batch has {order.shape[0]}")
    n_max = max(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows = [order[starts[i]:starts[i] + s][np.arange(n_max) % s]
            for i, s in enumerate(sizes)]
    return np.stack(rows)


def _shard(batch: Dict[str, torch.Tensor], idx: np.ndarray, b: int,
           node_seqs=None) -> Dict[str, torch.Tensor]:
    """Gather a (num_nodes, per) index into every batch entry."""
    num_nodes, per = idx.shape
    flat = np.ascontiguousarray(idx.reshape(-1))

    def shard(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        ix = torch.from_numpy(flat).to(x.device)
        if x.shape[0] == b:
            return x[ix].reshape((num_nodes, per) + tuple(x.shape[1:]))
        if x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] == b:
            g = x[:, ix]                       # mrope (3, B, S)
            return g.reshape((3, num_nodes, per) + tuple(x.shape[2:])
                             ).movedim(1, 0)
        return x

    out = {k: shard(v) for k, v in batch.items()}
    if node_seqs is not None:
        dev = next(v.device for v in batch.values()
                   if isinstance(v, torch.Tensor))
        out["n_seqs"] = torch.tensor([int(s) for s in node_seqs],
                                     dtype=torch.float32, device=dev)
    return out


def _key_source(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return batch["tokens"] if "tokens" in batch else batch["labels"]


def partition_non_iid(batch: Dict[str, torch.Tensor], num_nodes: int,
                      node_seqs=None) -> Dict[str, torch.Tensor]:
    """Adds a leading node axis by sort-and-shard (paper §IV-A).
    node_seqs: optional per-node TRUE sequence counts (unequal split)."""
    keys = _key_source(batch)[:, 0].cpu().numpy()
    order = np.argsort(keys, kind="stable")
    b = keys.shape[0]
    if node_seqs is not None:
        return _shard(batch, _unequal_index(order, node_seqs), b,
                      node_seqs)
    per = b // num_nodes
    return _shard(batch, order[: per * num_nodes].reshape(num_nodes, per),
                  b)


def partition_iid(batch: Dict[str, torch.Tensor], num_nodes: int,
                  seed: int = 0, node_seqs=None) -> Dict[str, torch.Tensor]:
    """A seeded random split (numpy's ``default_rng(seed)``, as the
    reference)."""
    b = _key_source(batch).shape[0]
    order = np.random.default_rng(seed).permutation(b)
    if node_seqs is not None:
        return _shard(batch, _unequal_index(order, node_seqs), b,
                      node_seqs)
    per = b // num_nodes
    return _shard(batch, order[: per * num_nodes].reshape(num_nodes, per),
                  b)


def node_token_counts(nodes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """TRUE per-node token counts N_n (float32) from a partitioned batch.

    Unequal partitions carry their true sequence counts as ``"n_seqs"``
    (padded slots are oversampled repeats, which do NOT add volume);
    equal partitions count each node's own label tokens — labels exist
    for every arch, unlike "tokens", which embedding-input archs lack.
    Either way the Alg. 2 data-volume weights and "weighted"
    participation see the real volumes.
    """
    labels = nodes["labels"]  # (num_nodes, per_node, seq)
    if "n_seqs" in nodes:
        return nodes["n_seqs"].to(torch.float32) * labels.shape[-1]
    return torch.tensor([labels[i].numel() for i in range(labels.shape[0])],
                        dtype=torch.float32, device=labels.device)
