"""Participation schedules for Alg. 2 node selection (the port of
``repro.core.fed.participation``: the ``uniform`` dense draw and
``full``).

``sample_nodes`` returns ``(sel, mask)``: the (N_p,) selected node
indices and a (N_p,) float32 participation mask. Weights stay float32,
as in the reference, whose Alg. 2 weights are float32 even under x64.
"""
from __future__ import annotations

from typing import Tuple

import torch

SCHEDULES = ("uniform", "full")


def validate(schedule: str) -> str:
    if schedule not in SCHEDULES:
        raise ValueError(f"participation schedule {schedule!r} is not in "
                         f"the port; have {list(SCHEDULES)}")
    return schedule


def sample_nodes(gen: torch.Generator, num_nodes: int,
                 nodes_per_round: int, *, device,
                 schedule: str = "uniform"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 node selection: ``uniform`` draws N_p of N without
    replacement in random order (a full permutation, then its first
    N_p); ``full`` takes every node in identity order. The results are
    made on ``device`` (the dataset's)."""
    validate(schedule)
    ones = torch.ones((nodes_per_round,), dtype=torch.float32,
                      device=device)
    if schedule == "full":
        if nodes_per_round != num_nodes:
            raise ValueError(
                f"'full' participation needs nodes_per_round "
                f"({nodes_per_round}) == num_nodes ({num_nodes})")
        return torch.arange(num_nodes, device=device), ones
    perm = torch.randperm(num_nodes, generator=gen, device=gen.device)
    return perm[:nodes_per_round].to(device), ones


def participation_weights(node_sizes: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Alg. 2 data-volume weights w_n = N_n / N_t over the nodes that
    participated (mask 1.0), in float32."""
    w = mask * node_sizes.to(torch.float32)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def round_weights(schedule: str, node_sizes: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Aggregation weights paired with the schedule: data-volume weights
    of the SELECTED nodes (node_sizes is (N_p,))."""
    validate(schedule)
    return participation_weights(node_sizes, mask)
