"""SGD with (Nesterov) momentum (the port of ``repro.optim.sgd``): the
federated OUTER optimizer (DiLoCo-style) and a light inner optimizer.
As ``AdamW``, ``update`` changes params and the momentum IN PLACE under
``torch.no_grad()`` and returns them."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import tree_map

F32 = torch.float32


class SGDState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    momentum: Any


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params) -> SGDState:
        step = torch.zeros((), dtype=torch.int32)
        if self.momentum == 0.0:
            return SGDState(step, None)
        return SGDState(step, tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params, lr
               ) -> Tuple[Any, SGDState]:
        step = state.step + 1
        lr = torch.as_tensor(lr, dtype=F32)
        if self.momentum == 0.0:
            def plain(p, g):
                p.copy_(p.to(F32).sub_(lr * g.to(F32)))
                return p
            return tree_map(plain, params, grads), SGDState(step, None)

        def upd(p, g, m):
            g32 = g.to(F32)
            m.mul_(self.momentum).add_(g32)
            d = g32 + self.momentum * m if self.nesterov else m
            p.copy_(p.to(F32).sub_(lr * d))
            return p

        new = tree_map(upd, params, grads, state.momentum)
        return new, SGDState(step, state.momentum)
