"""QuanFedPS for classical models (the port of
``repro.core.fed.fed_step``). One ``fed_train_round`` = Alg. 1 + Alg. 2
for one synchronization iteration:

  * every selected node runs I_l local optimizer steps on its own
    batches (the reference vmaps the nodes; one card runs them one
    after another),
  * node deltas are aggregated by data-volume-weighted mean (Eq. 8, the
    Lemma-1 additive form),
  * the server applies the aggregated delta with an outer LR.

Node-indexed trees carry a leading N_p axis, as in the reference: the
deltas and the inner optimizer state, which stays per node
(DiLoCo-style). The inner optimizer updates that state IN PLACE (the
port's optimizers do; the reference's jitted step donates it), so a
round consumes the opt state it is given. The global params are never
written: each node steps a copy, and the aggregate returns new params.

On a mesh whose 'fed_node' axis ('pod') has more than one rank (passed
as ``mesh=`` or entered with ``with mesh:``), the node axis is sharded
over that axis, as the reference's ``fed_params_axes`` lays it out:
each rank trains its contiguous block of the nodes and holds only
their optimizer states and batches; the weighted delta sum is one
all-reduce over the 'pod' group (``sharding.collectives``). Without a
mesh, or on one rank, the round is the one-process round.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.fed import participation, strategies
from repro_torch.core.fed.config import FederatedConfig
from repro_torch.core.fed.local import node_delta
from repro_torch.optim.tree import tree_map
from repro_torch.sharding import collectives, rules

F32 = torch.float32


def replicate_for_pods(tree, num_nodes: int):
    """Give every node its own copy (leading node axis)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(
        (num_nodes,) + tuple(x.shape)).clone(), tree)


def fed_params_axes(axes_tree, abstract_tree=None, num_nodes: int = 0):
    """Logical axes for node-indexed trees: prepend 'fed_node' (mapped
    to the 'pod' mesh axis by the rule table). ``axes_tree``: a dict of
    axes tuples, nested dicts allowed."""
    if isinstance(axes_tree, dict):
        return {k: fed_params_axes(v) for k, v in axes_tree.items()}
    return ("fed_node",) + tuple(axes_tree)


def node_shard(mesh):
    """(axis, ranks, rank) of the node axis' sharding on ``mesh``, or
    None without a mesh or with one rank on its 'fed_node' axis."""
    axis = None if mesh is None else rules.fed_fanout_axis(mesh)
    ranks = rules.axis_size(mesh, axis)
    if ranks <= 1:
        return None
    return axis, ranks, collectives.axis_rank(mesh, axis)


def resolve_delta_dtype(fed_cfg: FederatedConfig) -> torch.dtype:
    """The wire dtype node uploads transit: the aggregation strategy's
    ``wire_dtype`` when it names one, else the config's ``delta_dtype``.
    Also the classical stack's fail-loud point for quantum-only
    (multiplicative) strategies."""
    agg = strategies.get_aggregation(fed_cfg.aggregation)
    if agg.combine != "average":
        raise ValueError(
            f"classical substrate aggregates additive deltas; strategy "
            f"{fed_cfg.aggregation!r} (combine={agg.combine!r}) is "
            "quantum-only")
    return getattr(torch, agg.wire_dtype or fed_cfg.delta_dtype)


def node_uploads(loss_fn: Callable, opt, params, opt_states_nodes,
                 node_batches, lr, delta_dtype
                 ) -> Tuple[Dict[str, torch.Tensor], Any,
                            Dict[str, torch.Tensor]]:
    """The LOCAL phase: every node's I_l-step delta, cast to the wire
    dtype — the node's "upload". Returns (deltas, opt states, per-node
    metrics (N_p, I_l)), all with the leading node axis. The nodes run in
    order; node i steps its own copy of ``params`` with its slice of
    ``opt_states_nodes``, which is updated in place (and returned), and
    its delta is cast into slot i of the preallocated uploads."""
    n = next(iter(node_batches.values())).shape[0]
    deltas = {k: torch.empty((n,) + tuple(v.shape), dtype=delta_dtype,
                             device=v.device) for k, v in params.items()}
    per = []
    for i in range(n):
        state_i = tree_map(lambda x: x[i], opt_states_nodes)
        d, new_i, metrics = node_delta(
            loss_fn, opt, params, state_i,
            {k: v[i] for k, v in node_batches.items()}, lr)
        for k in list(d):
            deltas[k][i] = d.pop(k)             # the wire cast
        # an optimizer that returns new leaves (the step counter) has
        # them written back into the node's slot
        tree_map(lambda dst, old, new: None if new is old
                 else dst[i].copy_(new), opt_states_nodes, state_i, new_i)
        per.append(metrics)
    return deltas, opt_states_nodes, {
        k: torch.stack([m[k] for m in per]) for k in per[0]}


def aggregate_deltas(params, deltas, w: torch.Tensor, outer_lr,
                     server_sgd=None, server_state=None,
                     defense: Optional[str] = None, trim_frac: float = 0.2,
                     clip_norm: float = 1.0):
    """The AGGREGATE phase: weighted-mean the node deltas (Eq. 8) and
    apply with the outer LR — directly, or through the server-side outer
    optimizer (``repro_torch.core.fed.server_opt``) when ``server_sgd``
    is given. Returns ``(new_params, new server_state)``; neither
    ``params`` nor ``server_state`` is written.

    The leading axis of ``deltas`` is whatever set of uploads is being
    committed — the full cohort in a sync round, K buffered uploads in
    an async commit.

    Each node's delta is weighted in the wire dtype BEFORE the sum, as
    in the reference (so a bf16 wire stays bf16 on the wire): the
    products are rounded to the delta's dtype, then ``torch.sum`` over
    the node axis adds them (in fp32 for bf16 deltas) and rounds once.

    ``defense`` hardens the mean against hostile uploads
    (``strategies.DEFENSES``, additive modes only): "clip" norm-clips
    each node's per-leaf delta to ``clip_norm`` and de-weights
    non-finite uploads; "trimmed_mean"/"median" replace the weighted
    mean with the coordinate-wise order statistic over the valid
    (positively weighted, finite) nodes."""
    strategies.validate_defense(defense, "average")
    if defense == "clip":
        fin = strategies.finite_nodes(list(deltas.values()))
        w = w * fin.to(w.dtype)
        w = w / torch.clamp(torch.sum(w), min=1e-12)

        def clip(d):
            f = strategies.clip_factors(d, clip_norm,
                                        axes=tuple(range(1, d.dim())))
            return torch.where(fin.reshape((-1,) + (1,) * (d.dim() - 1)),
                               d * f.to(d.dtype),
                               torch.zeros((), dtype=d.dtype,
                                           device=d.device))
        deltas = {k: clip(d) for k, d in deltas.items()}

    def mean_leaf(d):
        wn = w.to(d.dtype).reshape((-1,) + (1,) * (d.dim() - 1))
        return torch.sum(d * wn, dim=0)

    if defense in ("trimmed_mean", "median"):
        valid = (w > 0) & strategies.finite_nodes(list(deltas.values()))
        mean_d = {k: strategies.robust_combine(d, valid, defense, trim_frac)
                  for k, d in deltas.items()}
    else:
        mean_d = {k: mean_leaf(d) for k, d in deltas.items()}
    if server_sgd is None:
        return {k: (p.to(F32) + outer_lr * mean_d[k].to(F32)).to(p.dtype)
                for k, p in params.items()}, None
    # outer momentum: SGD descends, the aggregate ascends — flip signs;
    # the optimizer updates in place, so it steps copies
    grads = {k: -d.to(F32) for k, d in mean_d.items()}
    return server_sgd.update(grads, tree_map(torch.clone, server_state),
                             {k: p.clone() for k, p in params.items()},
                             outer_lr)


def fed_train_round(loss_fn: Callable, opt, params, opt_states_nodes,
                    node_batches, lr, fed_cfg: FederatedConfig,
                    token_counts: Optional[torch.Tensor] = None,
                    participation_mask: Optional[torch.Tensor] = None,
                    mesh=None) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One synchronization iteration — the canonical local -> aggregate
    phase composition (``node_uploads`` + ``aggregate_deltas``).

    params: global model (flat dict; not written).
    opt_states_nodes: inner optimizer state with leading node axis
    (updated in place and returned).
    node_batches: dict of tensors with leading (num_nodes, I_l, ...) axes.
    token_counts: (num_nodes,) data-volume weights N_n (Alg. 2); equal
    weighting when None.
    participation_mask: (num_nodes,) 1.0/0.0 mask from the participation
    schedule — a dropped node's delta is zero-weighted and the remaining
    weights renormalize.
    mesh: a DeviceMesh (default: the ambient one). When its 'fed_node'
    axis has R > 1 ranks, ``opt_states_nodes`` and ``node_batches``
    hold this rank's block of num_nodes / R nodes (rank r: nodes r *
    num_nodes / R onwards), ``token_counts`` and the mask all nodes.
    Returns (new_params, new opt states, metrics averaged over nodes and
    steps).
    """
    n = fed_cfg.num_nodes
    mesh = mesh if mesh is not None else rules.current_mesh()
    shard = node_shard(mesh)
    if shard is not None:
        axis, ranks, rank = shard
        per = n // ranks
        held = next(iter(node_batches.values())).shape[0]
        if n % ranks or held != per:
            raise ValueError(
                f"num_nodes={n} on mesh axis '{axis}' of size {ranks}: "
                f"each rank holds num_nodes / {ranks} nodes' batches, "
                f"got {held}")
    delta_dt = resolve_delta_dtype(fed_cfg)
    deltas, new_opt_states, metrics = node_uploads(
        loss_fn, opt, params, opt_states_nodes, node_batches, lr, delta_dt)
    dev = next(iter(params.values())).device
    sizes = (torch.ones((n,), dtype=F32, device=dev) if token_counts is None
             else token_counts.to(dev, F32))
    mask = (torch.ones((n,), dtype=F32, device=dev)
            if participation_mask is None
            else participation_mask.to(dev, F32))
    w = participation.round_weights(fed_cfg.participation, sizes, mask)
    if shard is None:
        new_params, _ = aggregate_deltas(params, deltas, w, fed_cfg.outer_lr)
        return new_params, new_opt_states, {k: v.mean()
                                            for k, v in metrics.items()}
    w_local = w[rank * per:(rank + 1) * per]
    # this rank's weighted partial sums, every leaf in one flat buffer in
    # the wire dtype: one all-reduce sums the pods' partials
    flat = torch.empty(sum(p.numel() for p in params.values()),
                       dtype=delta_dt, device=dev)
    views, at = {}, 0
    for k, d in deltas.items():
        views[k] = flat[at:at + d[0].numel()].view(d.shape[1:])
        torch.sum(d * w_local.to(d.dtype).reshape(
            (-1,) + (1,) * (d.dim() - 1)), dim=0, out=views[k])
        at += d[0].numel()
    del deltas
    collectives.all_reduce(flat, mesh, axis)
    new_params = {k: (p.to(F32) + fed_cfg.outer_lr * views[k].to(F32)
                      ).to(p.dtype) for k, p in params.items()}
    names = list(metrics)
    sums = torch.stack([metrics[k].sum().to(F32) for k in names])
    collectives.all_reduce(sums, mesh, axis)
    count = metrics[names[0]].numel() // per * n       # nodes x steps
    return new_params, new_opt_states, {k: sums[i] / count
                                        for i, k in enumerate(names)}
