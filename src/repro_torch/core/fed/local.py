"""QuanFedNode for classical models: I_l local optimizer steps (the port
of ``repro.core.fed.local``).

The classical analogue of Alg. 1: instead of update unitaries e^{ieK},
a node produces the parameter DELTA after I_l local steps — Lemma 1's
first-order form, which is what the additive aggregation consumes.

The reference scans the steps functionally. Here the steps are a Python
loop, and the port's optimizers update params and their state IN PLACE
(``optim/adamw.py``): ``local_steps`` changes what it is given, and
``node_delta`` runs on its own copy of the params, so the global params
are intact when the delta is formed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.launch.steps import value_and_grad


def local_steps(loss_fn: Callable, opt, params, opt_state, batches, lr
                ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Run I_l = leading-dim(batches) local steps.

    batches: dict of tensors with a leading (I_l, ...) step axis.
    ``params`` and ``opt_state`` are updated in place by ``opt``.
    Returns (new_params, new_opt_state, metrics stacked over the steps).
    """
    n_steps = next(iter(batches.values())).shape[0]
    per = []
    for i in range(n_steps):
        _, metrics, grads = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in batches.items()})
        params, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        per.append(metrics)
    return params, opt_state, {k: torch.stack([m[k] for m in per])
                               for k in per[0]}


def node_delta(loss_fn: Callable, opt, params, opt_state, batches, lr
               ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Local steps from a copy of ``params``, returning the parameter
    delta (fp32) instead of the updated parameters — the node's
    'upload'. ``params`` is left as it was; ``opt_state`` is updated in
    place. The copy is turned into the delta leaf by leaf, so a node
    holds at most one extra copy of the params beside its delta."""
    work = {k: v.clone() for k, v in params.items()}
    pf, sf, metrics = local_steps(loss_fn, opt, work, opt_state, batches,
                                  lr)
    del work
    delta = {}
    for k in list(pf):
        delta[k] = pf.pop(k).float() - params[k].float()
    return delta, sf, metrics
