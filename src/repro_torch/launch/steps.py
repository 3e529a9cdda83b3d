"""The step builders shared by the launchers (the port of
``repro.launch.steps``). PyTorch runs eagerly, so a step is the plain
function; the mesh and sharding artifacts of the reference wait for the
mesh tooling (ROADMAP.md)."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import Model
from repro_torch.models.model import mean_metrics
from repro_torch.optim import AdamW


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   batch) -> Tuple[torch.Tensor, Dict, Dict]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)`` at ``params`` (a flat dict), the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``: the gradient is taken
    through detached aliases of the params, in their dtypes; a param the
    loss does not reach gets a zero gradient."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = loss_fn(leaves, batch)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def loss_and_grads(model: Model, params: Dict[str, torch.Tensor], batch
                   ) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``, the
    reference's ``jax.value_and_grad(model.loss_fn, has_aux=True)``.
    ``params`` are not marked: the gradient is taken through detached
    aliases of them. Whole-batch grads come in the params' dtypes; a
    batch larger than ``cfg.microbatch`` is backpropagated a microbatch
    at a time (loss / n each) into accumulators in ``cfg.accum_dtype``,
    so one microbatch's activations are live at a time; the loss and
    metrics are then the means over the microbatches, as the
    reference's ``_loss_accum`` gives them."""
    mbs = model.microbatches(batch)
    if len(mbs) == 1:
        return value_and_grad(model.loss_fn, params, batch)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    dt = getattr(torch, model.cfg.accum_dtype)
    grads = {k: torch.zeros(v.shape, dtype=dt, device=v.device)
             for k, v in params.items()}
    losses, per = [], []
    for mb in mbs:
        loss, metrics = model.loss_fn(leaves, mb)
        gs = torch.autograd.grad(loss / len(mbs), list(leaves.values()))
        for acc, g in zip(grads.values(), gs):
            acc.add_(g.to(acc.dtype))
        losses.append(loss.detach())
        per.append({k: v.detach() for k, v in metrics.items()})
    return sum(losses) / len(mbs), mean_metrics(per), grads


def make_train_step(model: Model, opt: AdamW):
    """``train_step(params, opt_state, batch, lr) -> (params, opt_state,
    metrics)``, as the reference's. The reference donates params and
    state to its jitted step; here the optimizer updates them in place
    and returns them."""
    def train_step(params, opt_state, batch, lr):
        _, metrics, grads = loss_and_grads(model, params, batch)
        new_params, new_state = opt.update(grads, opt_state, params, lr)
        return new_params, new_state, metrics
    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch, cur_len: int):
        logits, new_cache = model.decode_step(params, batch, cache, cur_len)
        # greedy next token (sampling is the server loop's business)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache
    return serve_step
