"""Participation schedules for Alg. 2 node selection (the port of
``repro.core.fed.participation``).

Schedules:

* ``"uniform"`` — N_p of N uniformly without replacement, in random order.
* ``"weighted"`` — without replacement, inclusion probability
  proportional to the node's data volume N_n (successive sampling, as
  the reference's ``jax.random.choice(..., p=...)``).
* ``"full"`` — every node, every round, in identity order (requires
  ``nodes_per_round == num_nodes``).
* ``"dropout"`` — uniform selection, then each selected node drops out
  independently with probability ``dropout_rate``; an all-dropped mask
  is drawn again until at least one node survives.

``sample_nodes`` returns ``(sel, mask)``: the (N_p,) selected node
indices and a (N_p,) float32 participation mask (1.0 = update counted).
Weights stay float32, as in the reference, whose Alg. 2 weights are
float32 even under x64.

Cost of the uniform draw: the dense method permutes all N nodes; past
``SAMPLED_MIN`` nodes (or with ``method="sampled"``) Floyd's O(N_p^2)
subset sampler takes over, plus an N_p-permutation. Every draw is made
on the generator's device and the result copied to ``device`` once; a
CPU generator keeps Floyd's short host loop off the card.

The port draws from a ``torch.Generator``: it does not replay the
reference's keys, so the draw-free cores (``floyd_from_uniforms``,
``dropout_mask``) are what its parity tests feed with chosen draws.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

SCHEDULES = ("uniform", "weighted", "dropout", "full")

# node count past which the uniform draw stops paying O(total): Floyd's
# O(N_p^2) sampler takes over (unless N_p is so large that the dense
# permutation is cheaper anyway)
SAMPLED_MIN = 4096

METHODS = ("auto", "dense", "sampled")


def validate(schedule: str) -> str:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown participation schedule {schedule!r}; "
                         f"registered: {list(SCHEDULES)}")
    return schedule


def validate_method(method: str) -> str:
    """Fail-loud check of a uniform-draw cost method name ("auto" |
    "dense" | "sampled")."""
    if method not in METHODS:
        raise ValueError(f"unknown participation method {method!r}; "
                         f"registered: {list(METHODS)}")
    return method


def floyd_from_uniforms(num_nodes: int, k: int,
                        u: Sequence[float]) -> list:
    """Floyd's subset sampler from k uniforms in [0, 1): for i = 0..k-1,
    t = floor(u_i (j + 1)) with j = n - k + i; if t was already taken,
    take j itself (fresh by construction). Uniform over k-subsets; the
    order is the insertion order."""
    sel, taken = [], set()
    for i, ui in enumerate(u):
        j = num_nodes - k + i
        t = min(int(ui * (j + 1)), j)
        t = j if t in taken else t
        taken.add(t)
        sel.append(t)
    return sel


def _floyd_choice(gen: torch.Generator, num_nodes: int, k: int
                  ) -> torch.Tensor:
    """Uniform k-of-n without O(n) state: Floyd's sampler over k uniforms,
    then a k-permutation so the order is uniform too (the product
    combine applies updates in ``sel`` order). Returns CPU int64."""
    u = torch.rand(k, generator=gen, dtype=torch.float64,
                   device=gen.device).tolist()
    sel = torch.tensor(floyd_from_uniforms(num_nodes, k, u),
                       dtype=torch.int64)
    perm = torch.randperm(k, generator=gen, device=gen.device).cpu()
    return sel[perm]


def _uniform_choice(gen: torch.Generator, num_nodes: int,
                    nodes_per_round: int, method: str) -> torch.Tensor:
    """The uniform without-replacement draw under a cost method: "dense"
    is the first N_p of a full permutation, "sampled" Floyd, "auto"
    dense below ``SAMPLED_MIN`` nodes and Floyd above it when
    N_p^2 < N."""
    validate_method(method)
    if method == "auto":
        method = ("sampled" if num_nodes >= SAMPLED_MIN
                  and nodes_per_round ** 2 < num_nodes else "dense")
    if method == "dense":
        perm = torch.randperm(num_nodes, generator=gen, device=gen.device)
        return perm[:nodes_per_round]
    return _floyd_choice(gen, num_nodes, nodes_per_round)


def dropout_mask(u: torch.Tensor, dropout_rate: float) -> torch.Tensor:
    """The float32 participation mask of one dropout draw: node i stays
    when its uniform u_i >= dropout_rate."""
    return (u >= dropout_rate).to(torch.float32)


def sample_nodes(gen: torch.Generator, num_nodes: int,
                 nodes_per_round: int, *, device,
                 schedule: str = "uniform",
                 node_sizes: Optional[torch.Tensor] = None,
                 dropout_rate: float = 0.0, method: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 node selection under a participation schedule; ``sel`` and
    ``mask`` are made on ``device`` (the dataset's).

    node_sizes: (num_nodes,) per-node data volumes N_n; required by
    "weighted", ignored otherwise. method: the uniform draw's cost policy
    (``_uniform_choice``; "weighted" is always dense)."""
    validate(schedule)
    validate_method(method)
    ones = torch.ones((nodes_per_round,), dtype=torch.float32, device=device)
    if schedule == "full":
        if nodes_per_round != num_nodes:
            raise ValueError(
                f"'full' participation needs nodes_per_round "
                f"({nodes_per_round}) == num_nodes ({num_nodes})")
        return torch.arange(num_nodes, device=device), ones
    if schedule == "uniform":
        sel = _uniform_choice(gen, num_nodes, nodes_per_round, method)
        return sel.to(device), ones
    if schedule == "weighted":
        if node_sizes is None:
            raise ValueError("'weighted' participation needs node_sizes")
        p = node_sizes.to(gen.device, torch.float64)
        sel = torch.multinomial(p / p.sum(), nodes_per_round,
                                replacement=False, generator=gen)
        return sel.to(device), ones
    if dropout_rate >= 1.0:
        raise ValueError(f"dropout_rate must be < 1.0 (every node would "
                         f"drop every round), got {dropout_rate}")
    sel = _uniform_choice(gen, num_nodes, nodes_per_round, method)
    while True:
        mask = dropout_mask(torch.rand(nodes_per_round, generator=gen,
                                       dtype=torch.float64,
                                       device=gen.device), dropout_rate)
        if bool(mask.any()):
            return sel.to(device), mask.to(device)


def participation_weights(node_sizes: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Alg. 2 data-volume weights w_n = N_n / N_t over the nodes that
    participated (mask 1.0), in float32, normalised along the last
    axis (leading axes are independent rounds)."""
    w = mask * node_sizes.to(torch.float32)
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)


def round_weights(schedule: str, node_sizes: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Aggregation weights paired with the schedule, so the round stays
    an unbiased estimate of Alg. 2's data-weighted objective:
    size-proportional ("weighted") sampling pairs with uniform weights
    over the survivors, the other schedules with the data volumes of the
    SELECTED nodes (node_sizes is (N_p,))."""
    validate(schedule)
    if schedule == "weighted":
        return participation_weights(torch.ones_like(node_sizes), mask)
    return participation_weights(node_sizes, mask)
