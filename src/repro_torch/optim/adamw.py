"""AdamW with a configurable state dtype (the port of
``repro.optim.adamw``), with the reference's own math, not
``torch.optim.AdamW``'s: clip by the global norm before the moments,
b2 0.95, bias correction from the int step in fp32, weight decay only on
tensors of two or more dims, the moments stored in ``state_dtype``.

``init(params) -> state``; ``update(grads, state, params, lr) ->
(params, state)``. The reference returns new arrays and its train step
donates the old ones; here params, the moments and the grads (scaled by
the clip) are updated IN PLACE under ``torch.no_grad()`` and returned,
so a full-width step holds no second copy of any of them.

Sharded: DTensor params, grads (on the params' placements) and moments
update in place on each rank's shards; the global norm's sums are the
only values that cross ranks (an all-reduce of the partial sums).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.state_dtype)

        def z(p):           # a DTensor's moments take its placements
            return torch.zeros_like(p, dtype=dt)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(z, params), v=tree_map(z, params))

    def init_abstract(self, param_specs) -> AdamWState:
        """The state's shapes and dtypes on the meta device (the dry
        run's): no memory."""
        dt = getattr(torch, self.state_dtype)
        meta = torch.device("meta")

        def z(p):
            return torch.empty(p.shape, dtype=dt, device=meta)
        return AdamWState(step=torch.empty((), dtype=torch.int32,
                                           device=meta),
                          m=tree_map(z, param_specs),
                          v=tree_map(z, param_specs))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        if self.grad_clip > 0:
            clip_(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        stepf = step.to(F32)
        bc1 = 1.0 - torch.tensor(b1, dtype=F32) ** stepf
        bc2 = 1.0 - torch.tensor(b2, dtype=F32) ** stepf
        lr = torch.as_tensor(lr, dtype=F32)

        def upd(p, g, m, v):
            g32 = g.to(F32)
            m32 = m.to(F32).mul_(b1).add_(g32 * (1 - b1))
            v32 = v.to(F32).mul_(b2).add_(g32 * (1 - b2) * g32)
            delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(self.eps))
            p32 = p.to(F32)
            if self.weight_decay > 0 and p.dim() >= 2:
                delta.add_(self.weight_decay * p32)
            p.copy_(p32.sub_(lr * delta))
            m.copy_(m32)
            v.copy_(v32)
            return p

        new = tree_map(upd, params, grads, state.m, state.v)
        return new, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / (global norm +
    1e-9)), the factor cast to each leaf's dtype; returns the norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return gnorm
