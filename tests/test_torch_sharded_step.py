"""The port's sharded model step on four CPU ranks against the
one-process step.

Four ``gloo`` ranks (``tests/torch_ranks.py``) form a 2x2 ('data',
'model') mesh. Params, batch and cache become DTensors placed by the
logical-axis rules (``launch.steps.shard_tree``) and run the same step
functions as the one-process port: the train step (loss, every grad,
every param after one AdamW step), the prefill (last logits and every
cache entry) and one decode step (logits and the updated cache) each
within 1e-5 relative (fp32: the norm of the difference over the
norm of the one-process tensor) of the one-process step on the same
tensors. The AdamW step is held on the one-process grads (sharded as
the params are): at step 1 it moves each param by lr * g / (|g| +
eps), about lr * sign(g), so a grad at its rounding noise flips a step
of 2 lr; the grads themselves are held on their own. The kernels' plain versions run on
the CPU; the sharding, the collectives DTensor inserts and the layers'
``constrain`` are what is under test.

The configs are ``reduced()`` ones:

* ``qwen-heads``: Qwen1.5-4B, 4 heads and 4 kv heads, which the model
  axis (2) divides: tensor parallelism over heads.
* ``qwen-cp``: Qwen1.5-4B, 3 heads and 3 kv heads, which it does not:
  the query sequence sharded over 'model' (context parallelism), each
  shard's rows at their ``q_offset``, and the decode cache's sequence
  sharded over 'model'.
* ``recurrentgemma``: RecurrentGemma-2B (one kv head, the cache's
  sequence sharded), with microbatches of 2 rows.
* ``rwkv``: RWKV6-7B, its zero-initialised mixing, decay and bonus
  tensors redrawn so the whole block is exercised.
* ``moe``: Llama-4-Scout's MoE block (4 experts, top-1, a shared
  expert): each rank routes, dispatches and combines its own tokens
  into the expert buffers' tiles (experts over 'model', capacity over
  'data').
* ``moe-mb``: the same with microbatches of 2 rows, each with its own
  capacity, load-balance and z-loss.

The MoE layer alone (``DISPATCH``: reduced Llama-4-Scout, top-1 with a
shared expert, and reduced Arctic, top-2 with a dense residual) runs in
the same ranks with its routing skewed (the tokens share a direction
that one expert's router column favours, so that expert overflows): each
rank's ``keep``, ``slot`` and expert-buffer tile are
the one-process values sliced at its coordinates, bit for bit, and the
capacity cutoff of an expert falls inside the second data shard's
tokens while the first shard's assignments to it are kept; the output,
both aux losses and every gradient (x's and the params') within 1e-5
of one process.

Row r of every batch has its first 3r labels masked, so the rows hold
16, 13, 10 and 7 valid labels: the mean over microbatches of their
token means, and the MoE aux losses, depend on which rows share a
microbatch. Microbatch i must hold global rows [2i, 2i + 2), as the
reference's ``_loss_accum`` groups them, on every mesh (rows cut
within each data shard would pair rows 0 and 2).

Every case runs at ``well_conditioned`` weights: the init takes the
stack axis as fan-in (the reference's, ROADMAP Standing notes), which
at n_cycles = 1 draws every stacked matrix at std 1; through three
RecurrentGemma layers the rounding of any two summation orders then
grows to 0.37 of the logits' scale (measured here, the one-process port
against itself on a 2x2 mesh), where at std 1/sqrt(d_in) the sharded
step stays within 1e-5.

The Qwen and MoE cases start from the JAX reference's init (numpy,
through ``convert``), and their sharded steps are also held against
the JAX reference's on the same numpy params and batch: the loss within
1e-5 relative and every grad within 1e-4 (``tests/test_torch_train.py``'s
gates), the prefill's last logits and cache and the decode step's
logits within the whole-model gate, 1e-3 (ROADMAP Standing notes).
There the sharded attention's context-parallel branch, the sharded
cache write, the MoE's fixed-shape dispatch and the vocab-sharded label
gather meet a reference that is not the port.

The decode runs the reference's way on the mesh: weight-stationary
under the rule overrides, the cache's sequence sharded over 'model' for
``qwen-cp`` and ``recurrentgemma`` (their kv heads do not divide it),
each rank attending its own keys and the softmax's partials combined by
log-sum-exp. For those two the batcher's step (``make_slot_step``) also
decodes with a (B,) ``cur_len``, each row at its own position (``CUR``,
in both 'model' halves of the cache, so each rank writes some rows and
attends keys for only some): its logits and every cache entry within
1e-5 of one process, and within 1e-3 of the JAX reference's batcher
decode (``serving.scheduler._forward_decode`` and ``_logits`` with
positions ``CUR[:, None]``) on the same numpy params and cache. And the
``ContinuousBatcher`` with the ``recurrentgemma`` params as DTensors
(its cache sharded, the argmax over vocab shards) serves three requests
through four slots with the one-process batcher's tokens.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

TOL = 1e-5
LOSS_TOL, GRAD_TOL, MODEL_TOL = 1e-5, 1e-4, 1e-3   # against the reference
B, S, MAX_LEN, LR = 4, 16, 24, 1e-3
# each row's decode position: distinct, in both 'model' halves of the
# cache ([0, 12) and [12, 24)); row 1's keys all lie in the first half
CUR = (16, 5, 21, 12)
ROW_CASES = ("qwen-cp", "recurrentgemma")
# (prompt length, budget) of the requests through the sharded batcher
REQUESTS = ((4, 3), (3, 4), (5, 2))

RANKS = """
from repro_torch.configs.shapes import BATCH_AXES
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.serving import ContinuousBatcher, Request, scheduler

def full(tree):
    return {k: v.full_tensor() for k, v in tree.items()}

mesh = host_mesh((2, 2), ("data", "model"))
cases = torch.load(f"{OUT}/cases.pt", weights_only=False)
out = {}
for name, c in cases.items():
    cfg = c["cfg"]
    model = Model(cfg)
    axes = model.param_axes()
    params = steps.shard_tree(c["params"], axes, mesh)
    batch = steps.shard_tree(c["batch"], BATCH_AXES, mesh)
    loss, metrics, grads = steps.loss_and_grads(model, params, batch)
    grads_full = full(grads)
    opt = AdamW(state_dtype=cfg.opt_state_dtype)
    new, _ = opt.update(steps.shard_tree(c["grads"], axes, mesh),
                        opt.init(params), params, LR)
    logits, cache = steps.make_prefill_step(model)(
        steps.shard_tree(c["params"], axes, mesh),
        steps.shard_tree(c["prefill"], BATCH_AXES, mesh))
    dcache = steps.shard_tree(c["cache"], model.cache_axes(), mesh)
    _, dlogits, dcache = steps.make_serve_step(model)(
        steps.shard_tree(c["params"], axes, mesh), dcache,
        steps.shard_tree(c["token"], BATCH_AXES, mesh), S)
    res = {"loss": loss.full_tensor(), "grads": grads_full,
           "params": full(new), "logits": logits.full_tensor(),
           "cache": full(cache), "dlogits": dlogits.full_tensor(),
           "dcache": full(dcache)}
    if "rows" in c:
        rcache = steps.shard_tree(c["cache"], model.cache_axes(), mesh)
        rtok, rlogits, _, rcache = scheduler.make_slot_step(model)(
            steps.shard_tree(c["params"], axes, mesh), rcache,
            c["token"]["tokens"], c["rows"], [True] * len(c["rows"]))
        res.update(rtok=rtok, rlogits=rlogits.full_tensor(),
                   rcache=full(rcache))
    if "requests" in c:
        bt = ContinuousBatcher(model, steps.shard_tree(c["params"], axes,
                                                       mesh),
                               n_slots=4, max_len=MAX_LEN, device="cpu")
        for uid, (prompt, budget) in enumerate(c["requests"]):
            bt.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=budget))
        bt.run_until_drained()
        res["served"] = {u: r.generated for u, r in bt.completed.items()}
    out[name] = res
if RANK == 0:
    torch.save(out, f"{OUT}/sharded.pt")

from repro_torch.models.layers import moe
EMBED = ("act_batch", "act_seq", "act_embed")
layers = {}
for name, c in torch.load(f"{OUT}/dispatch.pt", weights_only=False).items():
    cfg = c["cfg"]
    p = {k: steps.shard(v, c["axes"][k], mesh).detach().requires_grad_()
         for k, v in c["params"].items()}
    x = steps.shard(c["x"], EMBED, mesh).detach().requires_grad_()
    b, s, d = x.shape
    buf, routed, _ = moe.sharded_dispatch(x.reshape(b * s, d), p["router"],
                                          cfg)
    y, aux = moe.moe_ffn(p, x, cfg)
    loss = ((y * steps.shard(c["ct"], EMBED, mesh)).sum()
            + aux["load_balance"] + aux["router_z"])
    loss.backward()
    layers[name] = {
        "coord": (mesh.get_local_rank(0), mesh.get_local_rank(1)),
        "keep": routed["keep"], "slot": routed["slot"],
        "tile": buf.to_local().detach(), "y": y.full_tensor().detach(),
        "aux": {k: v.full_tensor().detach() for k, v in aux.items()},
        "grads": {"x": x.grad.full_tensor(),
                  **{k: v.grad.full_tensor() for k, v in p.items()}}}
torch.save(layers, f"{OUT}/dispatch{RANK}.pt")
mesh_lib.close()
"""


def rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def well_conditioned(params):
    """Stacked matrices (n_cycles, d_in, ...) rescaled from the init's
    std 1/sqrt(n_cycles) to the unstacked layer's 1/sqrt(d_in)."""
    return {k: (v * (v.shape[0] / v.shape[1]) ** 0.5
                if k.startswith("stack/") and v.dim() >= 3 else v)
            for k, v in params.items()}


def redrawn(params, seed):
    """The zero-initialised RWKV tensors drawn anew (decay logits across
    the clip, mixing in [0, 1], LoRA outputs and the bonus at 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, val in params.items():
        name = key.rsplit("/", 1)[-1]
        if name == "w0":
            val = torch.rand(val.shape, generator=gen) * 7.0 - 6.0
        elif name.startswith("mu"):
            val = torch.rand(val.shape, generator=gen)
        elif name in ("w_lora_b", "ts_lora_b", "u"):
            val = 0.1 * torch.randn(val.shape, generator=gen)
        out[key] = val
    return out


CASES = {
    "qwen-heads": ("qwen1.5-4b", {"n_heads": 4, "n_kv_heads": 4}),
    "qwen-cp": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 3}),
    "recurrentgemma": ("recurrentgemma-2b", {"microbatch": 2}),
    "rwkv": ("rwkv6-7b", {}),
    "moe": ("llama4-scout-17b-a16e", {}),
    "moe-mb": ("llama4-scout-17b-a16e", {"microbatch": 2}),
}
AGAINST_JAX = ("qwen-heads", "qwen-cp", "moe", "moe-mb")
# the MoE layer alone: (arch, the expert its router favours)
DISPATCH = {"llama4-top1": ("llama4-scout-17b-a16e", 0),
            "arctic-top2": ("arctic-480b", 2)}
SKEW = 1.0


def configs():
    return {name: get_config(arch).reduced(**over)
            for name, (arch, over) in CASES.items()}


def jax_params(name, seed):
    """The reference's init of a reduced config (numpy), its stacked
    matrices ``well_conditioned``."""
    arch, over = CASES[name]
    jcfg = jget_config(arch).reduced(**over)
    jp = {k: torch.as_tensor(np.array(v, np.float32)) for k, v in
          JModel(jcfg).init(jax.random.PRNGKey(seed)).items()}
    return jcfg, {k: v.numpy() for k, v in well_conditioned(jp).items()}


def make_cases():
    """The cases the ranks run, each with its one-process results, and
    the JAX reference's runs as (name, function) pairs still to call
    (the fixture calls them while the ranks run)."""
    cases, pending = {}, []
    for i, (name, cfg) in enumerate(configs().items()):
        model = Model(cfg)
        if name in AGAINST_JAX:
            jcfg, jp = jax_params(name, i)
            params = convert.model_params_to_torch(jp, cfg, device="cpu")
        else:
            params = well_conditioned(model.init(seed=i, device="cpu"))
        if name == "rwkv":
            params = redrawn(params, i)
        rng = np.random.default_rng(i)
        tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        for r in range(B):
            labels[r, :3 * r] = -1
        batch = {"tokens": torch.as_tensor(tokens[:, :S]),
                 "labels": torch.as_tensor(labels)}
        _, cache = model.prefill(params, {"tokens": batch["tokens"]})
        cases[name] = {
            "cfg": cfg, "params": params, "batch": batch,
            "prefill": {"tokens": batch["tokens"]},
            "cache": model.extend_cache(cache, MAX_LEN),
            "token": {"tokens": torch.as_tensor(tokens[:, S:])}}
        cases[name]["want"] = one_process(cases[name])
        cases[name]["grads"] = cases[name]["want"]["grads"]
        if cfg.microbatch:
            # the grouping a cut within each of the 2 data shards makes:
            # microbatches of global rows (0, 2) and (1, 3)
            cut = {k: v[[0, 2, 1, 3]] for k, v in batch.items()}
            cases[name]["want"]["loss_shard_cut"] = model.loss_fn(
                params, cut)[0].detach()
        if name in AGAINST_JAX:
            pending.append((name, functools.partial(
                reference, jcfg, jp, cfg, tokens, labels)))
        if name in ROW_CASES:
            c = cases[name]
            c["rows"] = torch.tensor(CUR, dtype=torch.int32)
            c["want"].update(rows_one_process(c), cache_in=c["cache"])
            if name not in AGAINST_JAX:
                jcfg = jget_config(CASES[name][0]).reduced(**CASES[name][1])
                jp = convert.model_params_to_numpy(params)
            pending.append((name, functools.partial(
                reference_rows, jcfg, jp, c["cache"], tokens[:, S:])))
        if name == "recurrentgemma":
            c = cases[name]
            c["requests"] = [
                (rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
                for n, m in REQUESTS]
            c["want"]["served"] = serve(model, params, c["requests"])
    return cases, pending


def dispatch_cases():
    """The MoE layer cases (``DISPATCH``) at well-conditioned weights
    (std 1/sqrt(d_in)), the routing skewed towards one expert, each with
    its one-process routing, buffers, output, aux losses and gradients
    (of the output against a seeded cotangent plus both aux losses)."""
    from repro_torch.models import params as pp
    from repro_torch.models.layers import moe
    cases = {}
    for i, (name, (arch, hot)) in enumerate(DISPATCH.items()):
        cfg = get_config(arch).reduced()
        ini = pp.Initializer(torch.float32, seed=i, device="cpu")
        moe.init_moe(ini, "moe", cfg)
        axes = {k[len("moe/"):]: v for k, v in ini.axes.items()}
        gen = torch.Generator().manual_seed(100 + i)
        params = {k: (torch.randn(v.shape, generator=gen) / v.shape[-2] ** 0.5
                      if v.dim() > 1 else v)
                  for k, v in pp.subtree(ini.params, "moe").items()}
        # the tokens share a direction u that the hot expert's column
        # favours, so it is in most tokens' top-k
        u = torch.randn(cfg.d_model, generator=gen)
        u = u / u.norm()
        params["router"][:, hot] += SKEW * u
        x = torch.randn(B, S, cfg.d_model, generator=gen) + SKEW * u
        ct = torch.randn(B, S, cfg.d_model, generator=gen)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xl = x.clone().requires_grad_()
        xf = x.reshape(B * S, -1)
        buf, _, keep, slot, _ = moe.dispatch(xf, params["router"], cfg)
        idx = moe.route({"router": params["router"]}, xf, cfg)[1]
        y, aux = moe.moe_ffn(leaves, xl, cfg)
        ((y * ct).sum() + aux["load_balance"] + aux["router_z"]).backward()
        cases[name] = {
            "cfg": cfg, "axes": axes, "params": params, "x": x, "ct": ct,
            "want": {"keep": keep, "slot": slot, "buf": buf, "idx": idx,
                     "y": y.detach(),
                     "aux": {k: v.detach() for k, v in aux.items()},
                     "grads": {"x": xl.grad, **{k: v.grad for k, v in
                                                leaves.items()}}}}
    return cases


def rows_one_process(c):
    """The batcher's step over every slot at the rows' own positions
    ``CUR``, in this process."""
    from repro_torch.serving import scheduler
    cache = {k: v.clone() for k, v in c["cache"].items()}
    tok, logits, _, cache = scheduler.make_slot_step(Model(c["cfg"]))(
        c["params"], cache, c["token"]["tokens"], c["rows"],
        [True] * len(CUR))
    return {"rtok": tok, "rlogits": logits, "rcache": cache}


def reference_rows(jcfg, jp, cache, token):
    """The JAX reference's batcher decode (``_forward_decode`` with
    positions ``CUR[:, None]``, then ``_logits``) of ``token`` (B, 1)
    against ``cache`` (the port's, as numpy): its logits and cache
    (jitted, as ``reference``)."""
    from repro.serving import scheduler as jsched
    jm = JModel(jcfg)
    cur = jnp.asarray(np.array(CUR, np.int32))
    jc = {k: jnp.asarray(v) for k, v in
          convert.model_params_to_numpy(cache).items()}
    jpj = {k: jnp.asarray(v) for k, v in jp.items()}

    @jax.jit
    def decode(p, tok, cache):
        x, cache, _ = jsched._forward_decode(jm, p, tok, cache, cur[:, None],
                                             cur)
        return jsched._logits(jm, p, x), cache
    jlogits, jcache = decode(jpj, jnp.asarray(token), jc)
    return {"rlogits": torch.as_tensor(np.asarray(jlogits)),
            "rcache": {k: torch.as_tensor(np.asarray(v))
                       for k, v in jcache.items()}}


def serve(model, params, requests):
    """The one-process batcher's tokens for ``requests`` through four
    slots."""
    from repro_torch.serving import ContinuousBatcher, Request
    bt = ContinuousBatcher(model, params, n_slots=4, max_len=MAX_LEN,
                           device="cpu")
    for uid, (prompt, budget) in enumerate(requests):
        bt.submit(Request(uid=uid, prompt=prompt, max_new_tokens=budget))
    bt.run_until_drained()
    return {u: r.generated for u, r in bt.completed.items()}


def reference(jcfg, jp, cfg, tokens, labels):
    """The JAX reference's loss and grads, prefill (last logits, cache)
    and one decode step at position S, on numpy inputs; its prefill
    cache's k/v padded to MAX_LEN for the decode, as ``extend_cache``
    pads the port's. Each function is jitted: op by op, JAX compiles
    every primitive on its own, several times the whole program's
    compile."""
    jm = JModel(jcfg)
    jpj = {k: jnp.asarray(v) for k, v in jp.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn,
                                                    has_aux=True))(
        jpj, {"tokens": tokens[:, :S], "labels": labels})
    jlogits, jcache = jax.jit(jm.prefill)(jpj, {"tokens": tokens[:, :S]})
    jc = {}
    for key, v in jcache.items():
        v = np.asarray(v)
        if key.endswith("/k") or key.endswith("/v"):
            pad = [(0, 0)] * v.ndim
            pad[v.ndim - 3] = (0, MAX_LEN - S)
            v = np.pad(v, pad)
        jc[key] = jnp.asarray(v)
    jdlogits, _ = jax.jit(jm.decode_step)(jpj, {"tokens": tokens[:, S:]},
                                          jc, jnp.int32(S))
    grads = convert.model_params_to_torch(
        {k: np.asarray(v, np.float32) for k, v in jgrads.items()}, cfg,
        device="cpu")
    return {"loss": float(jloss), "grads": grads,
            "logits": torch.as_tensor(np.asarray(jlogits)),
            "cache": {k: torch.as_tensor(np.asarray(v))
                      for k, v in jcache.items()},
            "dlogits": torch.as_tensor(np.asarray(jdlogits))}


def one_process(c):
    """The same three steps on plain tensors in this process."""
    cfg = c["cfg"]
    model = Model(cfg)
    clone = {k: v.clone() for k, v in c["params"].items()}
    loss, _, grads = steps.loss_and_grads(model, clone, c["batch"])
    grads = {k: g.clone() for k, g in grads.items()}
    opt = AdamW(state_dtype=cfg.opt_state_dtype)
    new, _ = opt.update({k: g.clone() for k, g in grads.items()},
                        opt.init(clone), clone, LR)
    logits, cache = steps.make_prefill_step(model)(c["params"], c["prefill"])
    dcache = {k: v.clone() for k, v in c["cache"].items()}
    _, dlogits, dcache = steps.make_serve_step(model)(
        c["params"], dcache, c["token"], S)
    return {"loss": loss, "grads": grads, "params": new, "logits": logits,
            "cache": cache, "dlogits": dlogits, "dcache": dcache}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_ranks import start_ranks, wait_ranks
    torch.manual_seed(0)
    tmp = tmp_path_factory.mktemp("sharded")
    cases, pending = make_cases()
    torch.save({k: {kk: vv for kk, vv in c.items() if kk != "want"}
                for k, c in cases.items()}, tmp / "cases.pt")
    disp = dispatch_cases()
    torch.save({k: {kk: vv for kk, vv in c.items() if kk != "want"}
                for k, c in disp.items()}, tmp / "dispatch.pt")
    ranks = start_ranks(f"LR, S, MAX_LEN = {LR!r}, {S}, {MAX_LEN}\n" + RANKS,
                        4, tmp)
    try:
        ref = {}
        for name, run in pending:
            ref.setdefault(name, {}).update(run())
    finally:
        wait_ranks(ranks, timeout=420)
    got = torch.load(tmp / "sharded.pt", weights_only=False)
    got["dispatch"] = [torch.load(tmp / f"dispatch{r}.pt", weights_only=False)
                       for r in range(4)]
    want = {k: c["want"] for k, c in cases.items()}
    want["dispatch"] = {k: dict(c["want"], cfg=c["cfg"])
                        for k, c in disp.items()}
    return ref, got, want


NAMES = tuple(configs())


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_step_equals_one_process(runs, name):
    _, got, want = runs
    want, g = want[name], got[name]
    assert rel(g["loss"], want["loss"]) <= TOL
    assert sorted(g["grads"]) == sorted(want["grads"])
    for part in ("grads", "params"):
        devs = {k: rel(g[part][k], want[part][k]) for k in want[part]}
        worst = max(devs, key=devs.get)
        assert devs[worst] <= TOL, (part, worst, devs[worst])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_and_decode_equal_one_process(runs, name):
    _, got, want = runs
    want, g = want[name], got[name]
    for part in ("logits", "dlogits"):
        assert rel(g[part], want[part]) <= TOL, part
    for part in ("cache", "dcache"):
        assert sorted(g[part]) == sorted(want[part])
        for k in want[part]:
            assert rel(g[part][k], want[part][k]) <= TOL, (part, k)


def test_sharded_loss_equals_the_reference_loss(runs):
    ref, got, _ = runs
    jloss = ref["qwen-heads"]["loss"]
    assert abs(float(got["qwen-heads"]["loss"]) - jloss) <= TOL * abs(jloss)


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_sharded_step_equals_the_reference(runs, name):
    ref, got, _ = runs
    want, g = ref[name], got[name]
    assert abs(float(g["loss"]) - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    assert sorted(g["grads"]) == sorted(want["grads"])
    devs = {k: rel(g["grads"][k], want["grads"][k]) for k in want["grads"]}
    worst = max(devs, key=devs.get)
    assert devs[worst] <= GRAD_TOL, (worst, devs[worst])
    for part in ("logits", "dlogits"):
        assert rel(g[part], want[part]) <= MODEL_TOL, part
    assert sorted(g["cache"]) == sorted(want["cache"])
    for k in want["cache"]:
        assert rel(g["cache"][k], want["cache"][k]) <= MODEL_TOL, k


@pytest.mark.parametrize("name", ROW_CASES)
def test_sharded_per_row_decode_equals_one_process(runs, name):
    """The batcher's step on the mesh, each row at its own position in
    the sequence-sharded cache: the greedy tokens, the logits and every
    cache entry (the k/v rows written on the ranks that hold them)."""
    _, got, want = runs
    want, g = want[name], got[name]
    assert torch.equal(g["rtok"], want["rtok"])
    assert rel(g["rlogits"], want["rlogits"]) <= TOL
    assert sorted(g["rcache"]) == sorted(want["rcache"])
    for k in want["rcache"]:
        assert rel(g["rcache"][k], want["rcache"][k]) <= TOL, k
    # each row's k/v written at its own position, and nowhere else
    key = next(k for k in want["rcache"] if k.endswith("/k"))
    moved = (want["rcache"][key] != want["cache_in"][key]).any(-1)
    moved = moved.any(-1).any(0) if key.startswith("stack/") else \
        moved.any(-1)
    assert [sorted(torch.nonzero(r).flatten().tolist()) for r in moved] == \
        [[p] for p in CUR]


@pytest.mark.parametrize("name", ROW_CASES)
def test_sharded_per_row_decode_equals_the_reference_batchers(runs, name):
    ref, got, _ = runs
    want, g = ref[name], got[name]
    assert rel(g["rlogits"], want["rlogits"]) <= MODEL_TOL
    assert sorted(g["rcache"]) == sorted(want["rcache"])
    for k in want["rcache"]:
        assert rel(g["rcache"][k], want["rcache"][k]) <= MODEL_TOL, k


def test_sharded_batcher_serves_the_one_process_tokens(runs):
    _, got, want = runs
    served = got["recurrentgemma"]["served"]
    assert served == want["recurrentgemma"]["served"]
    assert sorted(served) == [0, 1, 2]
    assert [len(served[u]) for u in sorted(served)] == [m for _, m in REQUESTS]


def test_microbatches_hold_the_reference_rows(runs):
    """The masked rows make the grouping visible: the sharded loss of
    the microbatched configs is the mean over global row pairs (0, 1)
    and (2, 3), and the pairs a cut within each data shard makes, (0, 2)
    and (1, 3), give a loss far outside the gate."""
    _, got, want = runs
    for name in ("recurrentgemma", "moe-mb"):
        assert configs()[name].microbatch == 2
        assert rel(got[name]["loss"], want[name]["loss"]) <= TOL, name
        assert rel(want[name]["loss_shard_cut"], want[name]["loss"]) > \
            100 * TOL, name


def test_the_cp_width_shards_queries_and_the_heads_width_heads():
    """Which attention branch each Qwen width takes on the 2x2 mesh."""
    cfgs = configs()
    assert cfgs["qwen-heads"].n_heads % 2 == 0
    assert cfgs["qwen-cp"].n_heads % 2 == 1
    assert cfgs["qwen-cp"].n_kv_heads % 2 == 1


@pytest.mark.parametrize("name", tuple(DISPATCH))
def test_sharded_dispatch_equals_one_process_bit_for_bit(runs, name):
    """Every rank's keep and slot are the one-process values of its
    token block's assignments, and its expert-buffer tile the
    one-process buffers at its (experts, capacity) coordinates."""
    _, got, want = runs
    want = want["dispatch"][name]
    e, cap, _ = want["buf"].shape
    k = want["cfg"].top_k
    for ranks in got["dispatch"]:
        g = ranks[name]
        data, model = g["coord"]
        n = B * S // 2 * k                 # a data shard's assignments
        assert torch.equal(g["keep"], want["keep"][data * n:(data + 1) * n])
        assert torch.equal(g["slot"], want["slot"][data * n:(data + 1) * n])
        el, cl = e // 2, cap // 2
        assert g["tile"].shape == (el, cl, want["buf"].shape[2])
        assert torch.equal(g["tile"], want["buf"][model * el:(model + 1) * el,
                                                  data * cl:(data + 1) * cl])


@pytest.mark.parametrize("name", tuple(DISPATCH))
def test_dispatch_cases_cut_an_expert_inside_the_second_shard(runs, name):
    """The skewed router overflows an expert whose capacity cutoff falls
    inside the second data shard's assignments (some kept, some
    dropped) while the first shard's assignments to it are kept."""
    _, _, want = runs
    want = want["dispatch"][name]
    idx, keep = want["idx"].reshape(-1), want["keep"]
    half = keep.numel() // 2
    cut = [x for x in range(want["buf"].shape[0])
           if keep[:half][idx[:half] == x].any()
           and keep[half:][idx[half:] == x].any()
           and not keep[half:][idx[half:] == x].all()]
    assert cut


@pytest.mark.parametrize("name", tuple(DISPATCH))
def test_sharded_moe_layer_equals_one_process(runs, name):
    """The combine, both aux losses and every gradient within 1e-5."""
    _, got, want = runs
    want = want["dispatch"][name]
    for ranks in got["dispatch"]:
        g = ranks[name]
        assert rel(g["y"], want["y"]) <= TOL
        for key in ("load_balance", "router_z"):
            assert rel(g["aux"][key], want["aux"][key]) <= TOL, key
        assert sorted(g["grads"]) == sorted(want["grads"])
        for key in want["grads"]:
            assert rel(g["grads"][key], want["grads"][key]) <= TOL, key
