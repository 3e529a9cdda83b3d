"""The step builders shared by the launchers and the dry run (the port
of ``repro.launch.steps``). PyTorch runs eagerly, so a step is the plain
function. Each ``*_artifacts`` builder returns ``(step, args, specs)``:
the step function, its arguments as meta tensors (shapes and dtypes, no
memory) and each argument's partition spec on ``mesh`` by the logical
axis rules (``sharding.rules.spec_for``), where the reference returns
its jitted step with the shardings bound in."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.shapes import BATCH_AXES, batch_specs
from repro_torch.models import Model
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model import mean_metrics
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding.rules import spec_for

META = torch.device("meta")


def param_shardings(model: Model, mesh):
    """(meta params, their specs)."""
    specs, axes = model.abstract_params(), model.param_axes()
    return specs, {k: spec_for(v.shape, axes[k], mesh)
                   for k, v in specs.items()}


def batch_shardings(batch: Dict[str, torch.Tensor], mesh):
    return {k: spec_for(v.shape, BATCH_AXES[k], mesh)
            for k, v in batch.items()}


def cache_shardings(model: Model, cache, mesh):
    axes = model.cache_axes()
    return {k: spec_for(v.shape, axes[k], mesh) for k, v in cache.items()}


def opt_shardings(opt_state: AdamWState, params_shardings, mesh):
    """AdamW m/v mirror the param shardings; step is replicated."""
    return AdamWState(step=(),
                      m={k: params_shardings[k] for k in opt_state.m},
                      v={k: params_shardings[k] for k in opt_state.v})


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


# ----------------------------------------------------------- dry run
def train_step_artifacts(cfg: ModelConfig, shape: InputShape, mesh):
    model = Model(cfg)
    opt = AdamW(state_dtype=cfg.opt_state_dtype)
    p_specs, p_shard = param_shardings(model, mesh)
    o_specs = opt.init_abstract(p_specs)
    batch = batch_specs(cfg, shape)
    lr = torch.empty((), dtype=torch.float32, device=META)
    return (make_train_step(model, opt), (p_specs, o_specs, batch, lr),
            (p_shard, opt_shardings(o_specs, p_shard, mesh),
             batch_shardings(batch, mesh), ()))


def prefill_artifacts(cfg: ModelConfig, shape: InputShape, mesh):
    model = Model(cfg)
    p_specs, p_shard = param_shardings(model, mesh)
    batch = batch_specs(cfg, shape)
    return (make_prefill_step(model), (p_specs, batch),
            (p_shard, batch_shardings(batch, mesh)))


def serve_step_artifacts(cfg: ModelConfig, shape: InputShape, mesh):
    model = Model(cfg)
    p_specs, p_shard = param_shardings(model, mesh)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=META)
    batch = batch_specs(cfg, shape)
    cur = torch.empty((), dtype=torch.int32, device=META)
    return (make_serve_step(model), (p_specs, cache, batch, cur),
            (p_shard, cache_shardings(model, cache, mesh),
             batch_shardings(batch, mesh), ()))


def artifacts_for(cfg: ModelConfig, shape: InputShape, mesh):
    if shape.kind == "train":
        return train_step_artifacts(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_artifacts(cfg, shape, mesh)
    if shape.kind == "decode":
        return serve_step_artifacts(cfg, shape, mesh)
    raise ValueError(shape.kind)
