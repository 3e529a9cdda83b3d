"""Two-level aggregation trees: nodes -> pods -> root (the port of
``repro.core.fed.cohort.hierarchy``).

The flat combiners walk every sampled node in one pass: Eq. 6 chains
N_p x I_l scaled update unitaries sequentially, Eq. 8 sums N_p weighted
generators. The two-level tree regroups the SAME expression by pod:

* product: pod ``p`` pre-multiplies its members' update unitaries into
  a partial chain B_{p,k} per interval step (``pod_products``), then the
  cross-pod merge multiplies the pod partials in pod order
  (``merge_products``). Matrix multiplication is associative, so this
  is an exact reassociation of the Eq. 6 chain, and the sequential depth
  drops from N_p to N_p/pods + pods steps, every step one ``qnn.bmm``
  over all pods, interval steps and sublayers (the zgemm kernel under
  ``impl="pallas"``).
* average: pod ``p`` pre-sums its members' weighted generators
  (``pod_generators``); the cross-pod merge sums the pod partials
  (``merge_generators``). An exact reassociation of the Eq. 8 sum.

Which partial a combine admits comes from the strategy registry
(``strategies.partial_kind``): a combine without a registered tree form
fails loudly instead of silently aggregating flat.

Every tensor here carries the round's leading session axis S (a solo
round is the stack of one): uploads are (S, N, I_l, m, d, d) and the
pods are formed inside each session, as (S, pods, per, ...), so one
session's pods never mix with another's.

The pod tier runs spread over the mesh axis backing the 'fed_node' rule
('pod') when a mesh is given and the pod count splits across it: each
rank computes its contiguous block of pods' partials and the partials
are gathered in pod order over that axis (``sharding.collectives``),
mirroring the local phase's fan-out; the cross-pod merge then runs on
every rank alike. Otherwise (no mesh, one rank on the axis, or pods not
splitting evenly) it is the batched computation of the reference's
one-device path.

The tree forms each step's update unitary first and then applies it to
the layer's unitary, so its rounding differs from the flat chain's:
<= 1e-10 in complex128, within the kernels' fp32 budget with them.
"""
from __future__ import annotations

import torch

from repro_torch.core.fed import strategies
from repro_torch.core.fed.cohort import topology as ftopo
from repro_torch.core.quantum import qnn
from repro_torch.sharding import collectives, rules


def _chain_steps(acc, seq: torch.Tensor, impl: str) -> torch.Tensor:
    """acc <- seq[T-1] @ ... @ seq[0] @ acc, one ``qnn.bmm`` a step over
    the middle axes (seq: (T, ..., d, d)). ``acc=None`` stands for the
    identity (the reference's ``_eye_like``): the chain then starts from
    seq[0] itself, the same product without a multiplication by I."""
    for t, u in enumerate(seq):
        acc = u if (acc is None and t == 0) else qnn.bmm(u, acc, impl=impl)
    return acc


def _group(x: torch.Tensor, topo: ftopo.Topology) -> torch.Tensor:
    """(S, N, ...) member-major -> (S, pods, per, ...) pod-major, per
    session."""
    n = x.shape[1]
    per = topo.pod_size(n)
    if topo.assignment != "block":
        perm = torch.as_tensor(ftopo.pod_perm(n, topo.pods, topo.assignment),
                               device=x.device)
        x = x.index_select(1, perm)
    return x.reshape((x.shape[0], topo.pods, per) + x.shape[2:])


def _shard_axis(mesh, topo: ftopo.Topology):
    """The mesh axis to spread the pod tier over: None for the batched
    fallback (no mesh, a 1-rank axis, or pods not splitting evenly)."""
    if mesh is None:
        return None
    axis = rules.fed_fanout_axis(mesh)
    ranks = rules.axis_size(mesh, axis)
    if axis is None or ranks <= 1:
        return None
    return axis if topo.pods % ranks == 0 else None


def _pod_tier(body, grouped: torch.Tensor, mesh, topo: ftopo.Topology):
    """``body`` over the pod-major input (S, pods, ...): this rank's
    block of pods, the outputs (S, pods, ...) gathered in pod order over
    the 'pod' mesh axis when it splits them; all pods at once otherwise."""
    axis = _shard_axis(mesh, topo)
    if axis is None:
        return body(grouped)
    per = topo.pods // rules.axis_size(mesh, axis)
    lo = collectives.axis_rank(mesh, axis) * per
    return collectives.all_gather(body(grouped[:, lo:lo + per]), mesh, axis,
                                  dim=1)


# ----------------------------------------------------------- product tree
def pod_products(upd: torch.Tensor, topo: ftopo.Topology, *,
                 impl: str = "xla", mesh=None) -> torch.Tensor:
    """Per-pod partial chains of the scaled update unitaries.

    upd: (S, N_p, I_l, m, d, d), slot order = Eq. 6 node order.
    Returns (S, pods, I_l, m, d, d): B_{p,k} = u_{last(p),k} @ ... @
    u_{first(p),k}, each pod's slice of the Eq. 6 chain; every step
    multiplies all sessions, pods, interval steps and sublayers at once.
    """
    def body(g):                             # (S, pods, per, I_l, m, d, d)
        return _chain_steps(None, g.movedim(2, 0).contiguous(), impl)
    return _pod_tier(body, _group(upd, topo), mesh, topo)


def merge_products(partials: torch.Tensor, *, impl: str = "xla"
                   ) -> torch.Tensor:
    """Cross-pod combine: U_k = B_{pods-1,k} @ ... @ B_{0,k}.

    partials: (S, pods, I_l, m, d, d) -> (S, I_l, m, d, d)."""
    return _chain_steps(None, partials.movedim(1, 0).contiguous(), impl)


def tree_chain(us: torch.Tensor, upd: torch.Tensor, topo: ftopo.Topology,
               *, impl: str = "xla", mesh=None) -> torch.Tensor:
    """Hierarchical Eq. 6 application for one layer: pod partial chains,
    cross-pod merge, then the per-step round unitaries onto ``us``
    (S, m, d, d) in ascending interval-step order (k = 1 applied first),
    the exact reassociation of the flat ``(k outer, node inner)`` chain."""
    u_steps = merge_products(pod_products(upd, topo, impl=impl, mesh=mesh),
                             impl=impl)
    return _chain_steps(us, u_steps.movedim(1, 0).contiguous(), impl)


# ----------------------------------------------------------- average tree
def pod_generators(ks: torch.Tensor, weights: torch.Tensor,
                   topo: ftopo.Topology, *, mesh=None) -> torch.Tensor:
    """Per-pod partial weighted generator sums.

    ks: (S, N_p, I_l, m, d, d), weights: (S, N_p) ->
    (S, pods, I_l, m, d, d): the sum over each pod's members of w_n K_{n,k}.
    """
    w = weights.to(ks.dtype)
    w = w.reshape(w.shape + (1,) * (ks.dim() - 2))
    return _pod_tier(lambda g: torch.sum(g, dim=2), _group(ks * w, topo),
                     mesh, topo)


def merge_generators(partials: torch.Tensor) -> torch.Tensor:
    """Cross-pod combine: K̄_k = the sum over pods of the partial sums."""
    return torch.sum(partials, dim=1)


def tree_mean_generators(ks: torch.Tensor, weights: torch.Tensor,
                         topo: ftopo.Topology, *, mesh=None) -> torch.Tensor:
    """Hierarchical Eq. 8 generator mean for one layer, per session: the
    exact reassociation of ``einsum('sn,snk...->sk...', w, ks)``."""
    return merge_generators(pod_generators(ks, weights, topo, mesh=mesh))


def partial_fn(agg: strategies.Aggregation):
    """The pod-partial entry point for a combine, via the registry's
    partial-kind table (``strategies.partial_kind``)."""
    return {"unitary_chain": pod_products,
            "generator_sum": pod_generators}[strategies.partial_kind(agg)]
