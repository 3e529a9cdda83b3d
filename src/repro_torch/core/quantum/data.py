"""Quantum training data for QuantumFed (§IV-A), the port of
``repro.core.quantum.data``.

A Haar-random unitary U_g on the input space is the target; pairs are
(|phi_in>, U_g|phi_in>) with Haar-random inputs, split across nodes
either sorted by a scalar key of the input vector (the paper's non-iid
partition) or shuffled. Unequal node sizes pad every node to the largest
count and carry the true counts in ``QuantumDataset.n_per``. Noisy data
(``pollute``, the paper's Fig. 3): the first ceil(ratio N_n) pairs of
each node are replaced by independent random input and output states.

The port draws from a ``torch.Generator``; it does not replay the
reference's ``jax.random`` streams, so parity tests hand both packages
the same arrays (``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantum import linalg as ql


class QuantumDataset(NamedTuple):
    """Per-node quantum data: (num_nodes, n_per_node, dim) state vectors
    (with a leading session axis S on every field when stacked for
    ``federated.server_round_stacked``).

    n_per: optional (num_nodes,) int32 TRUE pair counts when nodes are
    unequal; entries past a node's count are zero padding. None means
    every slot is a real pair.
    """
    phi_in: torch.Tensor
    phi_out: torch.Tensor
    n_per: Optional[torch.Tensor] = None

    def node_counts(self) -> torch.Tensor:
        """(num_nodes,) float32 data volumes N_n (Alg. 2 weights); a
        stacked dataset (a leading session axis S on every field) gives
        (S, num_nodes)."""
        if self.n_per is not None:
            return self.n_per.to(torch.float32)
        return torch.full(self.phi_in.shape[:-2], float(self.phi_in.shape[-2]),
                          dtype=torch.float32, device=self.phi_in.device)

    def valid_mask(self) -> Optional[torch.Tensor]:
        """(num_nodes, n_max) float32 validity mask ((S, num_nodes, n_max)
        when stacked), or None when every slot is valid."""
        if self.n_per is None:
            return None
        n_max = self.phi_in.shape[-2]
        idx = torch.arange(n_max, device=self.n_per.device)
        return (idx < self.n_per[..., None]).to(torch.float32)


def make_target_unitary(gen: torch.Generator, n_qubits: int,
                        device="cuda") -> torch.Tensor:
    return ql.haar_unitary(gen, ql.dim(n_qubits), device=device)


def make_pairs(gen: torch.Generator, u_target: torch.Tensor, n_pairs: int,
               n_qubits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    phi_in = ql.haar_state(gen, n_qubits, batch=(n_pairs,),
                           device=u_target.device)
    return phi_in, phi_in @ u_target.transpose(-1, -2)


def pollute(gen: torch.Generator, phi_in: torch.Tensor,
            phi_out: torch.Tensor, noise_ratio: float, n_qubits: int,
            counts: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace the first ceil(ratio * N_n) pairs of each node with random
    input and output states drawn from ``gen`` (the paper's noisy data).

    phi_in/phi_out: (num_nodes, n_per, d). counts: the per-node TRUE pair
    counts N_n of an unequal-size dataset (the slot count when None). The
    noisy count is exactly ceil(ratio * N_n), computed in float64 with a
    tiny downward guard, so a ratio like 0.3 gives 3 of 10, never 4."""
    n_nodes, n_per = phi_in.shape[:2]
    rnd_in = ql.haar_state(gen, n_qubits, batch=(n_nodes, n_per),
                           device=phi_in.device)
    rnd_out = ql.haar_state(gen, int(math.log2(phi_out.shape[-1])),
                            batch=(n_nodes, n_per), device=phi_out.device)
    cnt = (np.full((n_nodes,), n_per, np.float64) if counts is None
           else counts.cpu().numpy().astype(np.float64))
    n_noisy = np.ceil(np.float64(noise_ratio) * cnt - 1e-9).astype(np.int64)
    n_noisy = torch.from_numpy(np.maximum(n_noisy, 0)).to(phi_in.device)
    mask = (torch.arange(n_per, device=phi_in.device)[None, :]
            < n_noisy[:, None])[..., None]
    return (torch.where(mask, rnd_in, phi_in),
            torch.where(mask, rnd_out, phi_out))


def _pack_nodes(phi_in: torch.Tensor, phi_out: torch.Tensor,
                node_sizes: Sequence[int]) -> QuantumDataset:
    """Split a pair stream contiguously into nodes of the given sizes,
    zero-padding each node to the largest size."""
    sizes = [int(s) for s in node_sizes]
    if any(s <= 0 for s in sizes) or sum(sizes) > phi_in.shape[0]:
        raise ValueError(f"node sizes {sizes} do not fit "
                         f"{phi_in.shape[0]} pairs")
    n_max = max(sizes)
    ins, outs, start = [], [], 0
    for s in sizes:
        pad = (0, 0, 0, n_max - s)
        ins.append(torch.nn.functional.pad(phi_in[start:start + s], pad))
        outs.append(torch.nn.functional.pad(phi_out[start:start + s], pad))
        start += s
    return QuantumDataset(torch.stack(ins), torch.stack(outs),
                          torch.tensor(sizes, dtype=torch.int32,
                                       device=phi_in.device))


def _split(phi_in, phi_out, num_nodes, node_sizes) -> QuantumDataset:
    if node_sizes is not None:
        return _pack_nodes(phi_in, phi_out, node_sizes)
    n_per = phi_in.shape[0] // num_nodes
    n_tot = n_per * num_nodes
    return QuantumDataset(phi_in[:n_tot].reshape(num_nodes, n_per, -1),
                          phi_out[:n_tot].reshape(num_nodes, n_per, -1))


def partition_non_iid(phi_in: torch.Tensor, phi_out: torch.Tensor,
                      num_nodes: int,
                      node_sizes: Optional[Sequence[int]] = None
                      ) -> QuantumDataset:
    """Sort pairs by their vector-representation value and split
    contiguously (paper §IV-A)."""
    key_val = torch.angle(phi_in[:, 0]) + 1e-6 * phi_in[:, 1].abs()
    order = torch.argsort(key_val, stable=True)
    return _split(phi_in[order], phi_out[order], num_nodes, node_sizes)


def partition_iid(gen: torch.Generator, phi_in: torch.Tensor,
                  phi_out: torch.Tensor, num_nodes: int,
                  node_sizes: Optional[Sequence[int]] = None
                  ) -> QuantumDataset:
    order = torch.randperm(phi_in.shape[0], generator=gen,
                           device=gen.device).to(phi_in.device)
    return _split(phi_in[order], phi_out[order], num_nodes, node_sizes)


def make_federated_dataset(gen: torch.Generator, n_qubits: int,
                           num_nodes: int, n_per_node: int,
                           noise_ratio: float = 0.0, iid: bool = False,
                           n_test: int = 32,
                           node_sizes: Optional[Sequence[int]] = None,
                           device="cuda"
                           ) -> Tuple[torch.Tensor, QuantumDataset,
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (u_target, train dataset per node, clean test pairs), all
    on ``device``. noise_ratio > 0 pollutes each node's first
    ceil(ratio N_n) pairs (``pollute``). node_sizes: explicit per-node
    pair counts (overrides num_nodes / n_per_node)."""
    u_target = make_target_unitary(gen, n_qubits, device=device)
    if node_sizes is not None:
        num_nodes = len(node_sizes)
        n_total = int(sum(int(s) for s in node_sizes))
    else:
        n_total = num_nodes * n_per_node
    phi_in, phi_out = make_pairs(gen, u_target, n_total, n_qubits)
    if iid:
        ds = partition_iid(gen, phi_in, phi_out, num_nodes, node_sizes)
    else:
        ds = partition_non_iid(phi_in, phi_out, num_nodes, node_sizes)
    if noise_ratio > 0.0:
        noisy_in, noisy_out = pollute(gen, ds.phi_in, ds.phi_out,
                                      noise_ratio, n_qubits, counts=ds.n_per)
        ds = QuantumDataset(noisy_in, noisy_out, ds.n_per)
    test = make_pairs(gen, u_target, n_test, n_qubits)
    return u_target, ds, test
