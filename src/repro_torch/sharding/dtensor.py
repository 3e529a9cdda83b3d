"""DTensor plumbing for the sharded model step: what a layer needs to
run on a mesh the reference's way.

* ``replicate_like`` puts a tensor a layer makes for itself (a RoPE
  table, a pad, a mask, an ``arange``) on the mesh of its DTensor
  operands as a replicated DTensor, the same values on every rank.
* ``local`` runs a function of plain tensors on each rank's shards
  (``torch.distributed.tensor.experimental.local_map``): the hand-written
  kernels' ops, which DTensor cannot propagate itself, and the few
  computations whose DTensor form would change bits or shapes.
* ``write_at_`` writes a window into a tensor in place, into a
  DTensor's shards where its dim is sharded (a decode step's k/v into a
  cache whose sequence is sharded over 'model').
* ``whole`` gathers the shards of some dims of a DTensor (before a
  flatten DTensor cannot keep sharded, e.g. a weight's head_dim where
  the heads do not divide the model axis).
* ``split_last`` splits the last dim of a product's output into
  (heads, head_dim)-like factors, gathering it first where DTensor put
  a shard on it that the first factor cannot keep (its sharding
  propagation may choose to split a product's output columns).
* ``over_rows`` runs a function of an activation and whole weights on
  each rank's rows of the activation, where DTensor's own propagation
  would shard a small dim unevenly (RWKV6's five token-shift streams).
* ``pinned`` is a DTensor's identity whose gradient comes back on its
  placements, so a reshape before it sees a gradient it can reshape
  (DTensor may shard a product's gradient where the reshape cannot keep
  the shard, e.g. 10 heads over a model axis of 16).
* ``unshard_data`` all-gathers a weight's shards over the mesh axes of
  the active ``act_batch`` rule ('pod', 'data') before a layer uses it,
  as FSDP does, so the products keep the batch sharded (DTensor would
  otherwise gather the activations where they are the smaller operand);
  the weight's gradient comes back as a partial sum and is
  reduce-scattered onto the param (``launch.steps``). Under the decode's
  rule override (``act_batch`` None) it gathers nothing: the weights
  stay where they lie.
* ``stationary`` is a product of an activation and a weight that keeps
  the weight's shards in place (the decode's layout): the activation is
  cut to match and the partial sums are reduced, activation-sized.
* ``argmax`` is ``torch.argmax`` over a last dim that may be sharded:
  each rank's (max, first index) pairs are gathered, not the rows.
* ``write_rows_at_`` writes row r of a window at its own position
  ``pos[r]`` in place, into a DTensor's shards (a decode step's k/v at
  each slot's position into a sequence-sharded cache).
* ``contract`` is a product of an activation and a (K, N) weight on
  each rank's shards, the layout picked per mesh dim from the operands'
  placements and the gradients' placements given (DTensor's own strategy
  may gather a whole weight where the rules shard its rows).
* ``settled`` reduces a DTensor's partial sums onto a shard of one dim
  (a reduce-scatter; a replica where the dim does not divide), before a
  sharded operand meets it: a product contracted over a sharded dim
  meeting a sharded bias (torch 2.11's DTensor cannot turn the bias
  into partial sums).
* ``coord`` is this rank's linear index over some mesh dims, as DTensor
  nests shards (the first mesh dim outermost).

Nothing here runs at import time or opens a process group; a plain
tensor goes through every helper as it is.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.sharding.rules import rule_axes


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate_like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh where ``ref`` is a DTensor, else ``t`` as it is."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` with no mesh dim sharding any of tensor ``dims`` (those
    shards gathered); a plain tensor, or a DTensor with none, as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pls = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
           for p in x.placements]
    return x if pls == list(x.placements) else x.redistribute(
        x.device_mesh, pls)


def split_last(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``x.unflatten(-1, sizes)``; a DTensor whose last dim is sharded
    over mesh dims of a size that does not divide ``sizes[0]`` is
    gathered along it first (DTensor can keep the shard only on the
    first factor)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        last = x.dim() - 1
        m = 1
        for d, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                m *= x.device_mesh.size(d)
        if sizes[0] % m:
            x = whole(x, (last,))
        # its gradient back on these placements before the flatten of
        # the backward (DTensor may hand it over sharded on the inner
        # factor, which a flatten keeps only as a strided shard)
        return pinned(x.unflatten(-1, sizes))
    return x.unflatten(-1, sizes)


def over_rows(fn: Callable, x: torch.Tensor, *weights: torch.Tensor,
              rows: Sequence[int] = (0, 1)) -> torch.Tensor:
    """``fn(x, *weights)`` with x's shards of its ``rows`` dims kept
    (every other dim of x, and every weight, whole): each rank runs fn on
    its rows, the weights' gradients partial sums over the ranks that
    split the rows. A plain x runs fn as it is."""
    if not is_dtensor(x):
        return fn(x, *weights)
    from torch.distributed.tensor import Partial, Replicate, Shard
    x_pl = [p if isinstance(p, Shard) and p.dim in rows else Replicate()
            for p in x.placements]
    rep = [Replicate()] * len(x_pl)
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in x_pl]
    return local(fn, x.device_mesh, x_pl, (x_pl,) + (rep,) * len(weights),
                 (x_pl,) + (grad,) * len(weights))(x, *weights)


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient redistributed to x's placements (a plain
    tensor as it is)."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def unshard_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its shards over the mesh axes of the active
    ``act_batch`` rule gathered (a plain tensor, or one not sharded over
    them, as it is; under ``act_batch`` None, nothing is gathered)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    axes = rule_axes("act_batch")
    names = x.device_mesh.mesh_dim_names or ()
    pls = [Replicate() if n in axes else p
           for n, p in zip(names, x.placements)]
    return x if pls == list(x.placements) else x.redistribute(
        x.device_mesh, pls)


def settled(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with each mesh dim's partial sums reduced onto a shard of
    tensor ``dim`` (where the mesh dim divides it) or a replica."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    dim %= x.dim()
    pls = list(x.placements)
    for i, p in enumerate(pls):
        if isinstance(p, Partial):
            taken = any(isinstance(q, Shard) and q.dim == dim for q in pls)
            pls[i] = (Shard(dim) if not taken
                      and x.shape[dim] % mesh.size(i) == 0 else Replicate())
    return x if pls == list(x.placements) else x.redistribute(mesh, pls)


def contract(fn: Callable, x: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """``fn(x, w)`` of an activation x (..., K) and a weight w (K, N),
    DTensors on one mesh, run on each rank's shards. Per mesh dim: where
    x shards a leading dim, x keeps it (w whole there, the result sharded
    the same, w's gradient a partial sum); else where w shards its
    columns, it keeps them (x whole, the result's last dim sharded, x's
    gradient a partial sum); else where w shards its rows, it keeps them
    and x's last dim is cut to match (the result a partial sum, to be
    reduced by the caller, e.g. ``settled``; x's gradient keeps x's
    shard, w's gradient w's); else both whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.dim() - 1
    x_pl, w_pl, out_pl, gx, gw = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            x_pl.append(xp), w_pl.append(Replicate()), out_pl.append(xp)
            gx.append(xp), gw.append(Partial())
        elif wp == Shard(1):
            x_pl.append(Replicate()), w_pl.append(wp)
            out_pl.append(Shard(last)), gx.append(Partial())
            gw.append(wp)
        elif wp == Shard(0):
            x_pl.append(Shard(last)), w_pl.append(wp)
            out_pl.append(Partial()), gx.append(Shard(last))
            gw.append(wp)
        else:
            for pls in (x_pl, w_pl, out_pl, gx, gw):
                pls.append(Replicate())
    return local(fn, x.device_mesh, out_pl, (x_pl, w_pl), (gx, gw))(x, w)


def coord(mesh, dims: Sequence[int]) -> int:
    """This rank's index over mesh ``dims`` taken together, the first of
    them outermost (the order DTensor nests the shards of one tensor
    dim split over several mesh dims)."""
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def local(fn: Callable, mesh, out_placements, in_placements,
          in_grad_placements=None):
    """``fn`` of plain tensors as a function of DTensors: each input is
    redistributed to its placements and handed over as this rank's
    shard, and each output comes back as a DTensor with its placements.
    ``in_grad_placements`` are the placements of the inputs' gradients
    (``Partial()`` where ranks hold parts of a sum); by default the
    inputs'. Non-tensor arguments pass with placements None."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)


def write_at_(dst: torch.Tensor, dim: int, start: int, src: torch.Tensor
              ) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` with n = src.shape[dim], in
    place. A DTensor ``dst`` takes on each rank the part of the window
    that falls in its shard of ``dim`` (every rank holds all of it where
    ``dim`` is not sharded), ``src`` redistributed to ``dst``'s
    placements but whole along ``dim``: a slice of a sharded dim would
    be a gathered copy, and the write would be lost."""
    n = src.shape[dim]
    if not is_dtensor(dst):
        dst.narrow(dim, start, n).copy_(src)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pls = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src_l = replicate_like(dst, src).redistribute(mesh, pls).to_local()
    dst_l = dst.to_local()
    width = dst_l.shape[dim]
    lo = coord(mesh, [i for i, p in enumerate(dst.placements)
                      if p == Shard(dim)]) * width
    a, b = max(start, lo), min(start + n, lo + width)
    if a < b:
        dst_l.narrow(dim, a - lo, b - a).copy_(src_l.narrow(dim, a - start,
                                                           b - a))


def write_rows_at_(dst: torch.Tensor, pos: torch.Tensor, src: torch.Tensor
                   ) -> None:
    """``dst[r, pos[r]] = src[r, 0]`` for every row r, in place: dim 0 of
    ``dst`` the rows, dim 1 the positions, ``src`` (B, 1, ...) and ``pos``
    (B,) int. A DTensor ``dst`` takes on each rank the rows of its shard
    of dim 0 whose position falls in its shard of dim 1, ``src``
    redistributed to ``dst``'s placements but whole along dim 1 (a
    gathered copy would lose the write, as in ``write_at_``); every other
    row of the shard writes back the value it holds, so the step needs
    no host sync."""
    if not is_dtensor(dst):
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst[rows, pos] = src[:, 0]
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pls = [Replicate() if p == Shard(1) else p for p in dst.placements]
    src_l = replicate_like(dst, src).redistribute(mesh, pls).to_local()
    pos = pos.full_tensor() if is_dtensor(pos) else pos
    dst_l = dst.to_local()
    rows, width = dst_l.shape[:2]

    def first(dim):
        return coord(mesh, [i for i, p in enumerate(dst.placements)
                            if p == Shard(dim)])
    at = pos.narrow(0, first(0) * rows, rows).long() - first(1) * width
    inside = ((at >= 0) & (at < width)).view((rows,) + (1,) * (
        dst_l.dim() - 2))
    at = at.clamp(0, width - 1)
    idx = torch.arange(rows, device=dst_l.device)
    dst_l[idx, at] = torch.where(inside, src_l[:, 0], dst_l[idx, at])


def stationary(fn: Callable, eq: str, x: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
    """``fn(x, w)``, a product whose operands' and result's dims are named
    by the einsum-like ``eq`` (e.g. "bsd,dhe->bshe"), with a DTensor
    weight ``w`` kept where it lies (the decode's weight-stationary
    layout). Per mesh dim: where w shards a dim, x is cut along the same
    dim (a local cut of a replica) and the result is sharded along it,
    or, for a dim the product contracts, is a partial sum; where w is
    whole, x keeps a shard of a dim that reaches the result and is
    gathered otherwise. The partial sums are then reduced
    onto replicas: the collectives move activations, never the weight.
    Plain operands go through ``fn`` as they are."""
    if not is_dtensor(w):
        return fn(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    x = replicate_like(w, x)
    x_pl, w_pl, o_pl = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(wp, Shard):
            c = ws[wp.dim]
            x_pl.append(Shard(xs.index(c)) if c in xs else Replicate())
            w_pl.append(wp)
            o_pl.append(Shard(out.index(c)) if c in out else Partial())
        elif isinstance(xp, Shard) and xs[xp.dim] in out:
            x_pl.append(xp), w_pl.append(wp)
            o_pl.append(Shard(out.index(xs[xp.dim])))
        else:
            x_pl.append(Replicate()), w_pl.append(wp)
            o_pl.append(Replicate())
    mesh = w.device_mesh
    y = local(fn, mesh, o_pl, (x_pl, w_pl))(x, w)
    pls = [Replicate() if isinstance(p, Partial) else p
           for p in y.placements]
    return y if pls == list(y.placements) else y.redistribute(mesh, pls)


def argmax(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)``. A DTensor whose last dim is sharded is
    not gathered: each rank takes its shard's largest value and the
    global index of its first occurrence, those (rows, shards) pairs are
    all-gathered, and the first shard holding the largest value gives the
    index. Ties go to the smallest index and a NaN counts as the
    largest, as on the whole row, so the index is the same."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.dim() - 1
    pls = [Replicate() if isinstance(p, Partial) else p
           for p in x.placements]
    vdims = [d for d, p in enumerate(pls) if p == Shard(last)]

    def pairs(xl):          # (..., 1, 2): the value and its global index
        i = torch.argmax(xl, dim=-1, keepdim=True)
        lo = coord(mesh, vdims) * xl.shape[-1]
        return torch.stack([xl.gather(-1, i).double(), (i + lo).double()],
                           dim=-1)

    def pick(gl):           # (..., shards, 2) -> (...)
        j = torch.argmax(gl[..., 0], dim=-1, keepdim=True)
        return gl[..., 1].gather(-1, j)[..., 0].long()
    got = whole(local(pairs, mesh, pls, (pls,))(x), (last,))
    pls = list(got.placements)
    return local(pick, mesh, pls, (pls,))(got)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a (d_in, d_out) weight. Under the decode's rule
    override (``act_batch`` None: the activations replicated over the data
    axes, the weights not gathered) a DTensor product goes through
    ``stationary``: the weight's shards stay in place and the partial
    sums over its d_in shards are reduced, activation-sized. Elsewhere a
    weight whose rows (d_in) are sharded goes through ``contract``, each
    rank contracting its rows (DTensor's own strategy may gather the
    whole weight for the backward); other products, and plain tensors,
    ``x @ w`` as it is."""
    if not is_dtensor(w):
        return x @ w
    if not rule_axes("act_batch"):
        lead = "abcdefgh"[:x.dim() - 1]
        return stationary(torch.matmul, f"{lead}i,io->{lead}o", x, w)
    from torch.distributed.tensor import Shard
    if Shard(0) in w.placements:
        return contract(torch.matmul, replicate_like(w, x), w)
    return x @ w
