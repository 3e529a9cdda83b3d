"""The step builders shared by the launchers and the dry run (the port
of ``repro.launch.steps``). PyTorch runs eagerly, so a step is the plain
function. Each ``*_artifacts`` builder returns ``(step, args, specs)``:
the step function, its arguments as meta tensors (shapes and dtypes, no
memory) and each argument's partition spec on ``mesh`` by the logical
axis rules (``sharding.rules.spec_for``), where the reference returns
its jitted step with the shardings bound in.

Sharded steps: ``shard`` / ``shard_tree`` turn tensors into DTensors
placed by ``sharding_for`` on a ``DeviceMesh`` (real, or torch's fake
backend; fake or real tensors), and ``sharded_artifacts`` gives the
same steps with their params, optimizer state, batch and cache so
placed. A step given DTensor params runs under their mesh (``with
mesh:``), so the layers' ``constrain`` pins the activations as the
reference's do, and the grads come back on the params' placements."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.shapes import BATCH_AXES, batch_specs
from repro_torch.models import Model
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model import mean_metrics
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.rules import current_mesh, sharding_for, spec_for

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


def on_mesh(tree: Dict[str, torch.Tensor]):
    """The mesh context of a tree's DTensors (``with mesh:``), where one
    is not open already; a null context for plain tensors."""
    for v in tree.values():
        if sdt.is_dtensor(v):
            if current_mesh() is None:
                return v.device_mesh
            break
    return contextlib.nullcontext()


def _to_param_placements(grads, params):
    """Each DTensor grad redistributed to its param's placements (the
    reduce-scatter / all-reduce of a data-parallel step); plain grads as
    they are."""
    return {k: (g.redistribute(params[k].device_mesh, params[k].placements)
                if sdt.is_dtensor(g) else g) for k, g in grads.items()}


def shard(x: torch.Tensor, names, mesh) -> torch.Tensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``sharding_for(x.shape, names, mesh)``: each rank keeps a
    copy of its shard, cut as DTensor cuts it (the first mesh dim
    outermost), with no communication (the copy: an update of the
    DTensor in place leaves ``x`` as it was). Fake tensors too."""
    from torch.distributed.tensor import DTensor, Shard
    pls = sharding_for(x.shape, names, mesh)
    loc = x
    for d, pl in enumerate(pls):
        if isinstance(pl, Shard):
            loc = loc.chunk(mesh.size(d), dim=pl.dim)[mesh.get_local_rank(d)]
    return DTensor.from_local(loc.clone(memory_format=torch.contiguous_format),
                              mesh, pls, run_check=False, shape=x.shape,
                              stride=x.stride())


def shard_tree(tree: Dict[str, torch.Tensor], axes: Dict[str, Tuple], mesh
               ) -> Dict[str, torch.Tensor]:
    """``shard`` over a flat dict, each tensor by its logical axes."""
    return {k: shard(v, axes[k], mesh) for k, v in tree.items()}


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   batch) -> Tuple[torch.Tensor, Dict, Dict]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)`` at ``params`` (a flat dict), the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``: the gradient is taken
    through detached aliases of the params, in their dtypes; a param the
    loss does not reach gets a zero gradient."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with on_mesh(params):
        loss, metrics = loss_fn(leaves, batch)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), gs)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _to_param_placements(grads, params))


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
    grads = {k: torch.zeros_like(v, dtype=dt) for k, v in params.items()}
    losses, per = [], []
    with on_mesh(params):
        for mb in mbs:
            loss, metrics = model.loss_fn(leaves, mb)
            gs = torch.autograd.grad(loss / len(mbs), list(leaves.values()))
            for (k, acc), g in zip(grads.items(), gs):
                if sdt.is_dtensor(g):
                    g = g.redistribute(acc.device_mesh, acc.placements)
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
        with on_mesh(params):
            return model.prefill(params, batch)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch, cur_len: int):
        with on_mesh(params):
            logits, new_cache = model.decode_step(params, batch, cache,
                                                  cur_len)
            # greedy next token (sampling is the server loop's business):
            # each vocab shard's (max, first index), not the rows, are
            # gathered; the logits returned stay sharded
            next_tok = sdt.argmax(logits).to(torch.int32)
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


def sharded_artifacts(cfg: ModelConfig, shape: InputShape, mesh, *,
                      device="cpu", seed=None):
    """``(step, args)`` of ``artifacts_for``'s step with its arguments as
    DTensors on the ``DeviceMesh`` ``mesh``: params, optimizer moments
    (the params' placements), batch and cache placed by the rules, the
    scalars plain. ``seed`` None builds empty tensors of the arguments'
    shapes and dtypes on ``device`` (made under ``FakeTensorMode`` they
    hold no memory: the traced dry run); a seed draws the model's init
    and a batch from it, the same on every rank."""
    from repro_torch.configs.shapes import concrete_batch
    model = Model(cfg)
    step, args, _ = artifacts_for(cfg, shape, mesh)
    dev = torch.device(device)

    def real(tree):
        return {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                for k, v in tree.items()}
    params = (model.init(seed=seed, device=dev) if seed is not None
              else real(args[0]))
    params = shard_tree(params, model.param_axes(), mesh)
    if seed is None:
        batch = real(batch_specs(cfg, shape))
    else:
        batch = concrete_batch(cfg, shape.global_batch, shape.seq_len,
                               torch.Generator().manual_seed(seed),
                               kind=shape.kind, device=dev)
    batch = shard_tree(batch, BATCH_AXES, mesh)
    if shape.kind == "train":
        opt = AdamW(state_dtype=cfg.opt_state_dtype)
        return step, (params, opt.init(params), batch, 1e-3)
    if shape.kind == "prefill":
        return step, (params, batch)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=dev)
    cache = shard_tree(cache, model.cache_axes(), mesh)
    return step, (params, cache, batch, shape.seq_len // 2)


def artifacts_for(cfg: ModelConfig, shape: InputShape, mesh):
    if shape.kind == "train":
        return train_step_artifacts(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_artifacts(cfg, shape, mesh)
    if shape.kind == "decode":
        return serve_step_artifacts(cfg, shape, mesh)
    raise ValueError(shape.kind)
