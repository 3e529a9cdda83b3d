"""The port's training slice against the JAX reference (CPU, fp32, the
kernels' plain versions): the loss and its gradients, microbatching and
remat, AdamW / SGD / the schedules / the unitary optimizer, the data
stream, the attention backward's plain version and the scan's adjoint,
and ``launch/train.py``.

Inputs are the same numpy arrays on both sides (params through
``convert``). Models are ``reduced()`` RecurrentGemma-2B and RWKV6-7B
(fp32, 3 layers); the RWKV tensors that the reference's init leaves at
zero are redrawn in numpy (as tests/test_torch_rwkv.py does), so every
gradient is exercised.

Tolerances. The loss within 1e-5 relative; each gradient within 1e-4
of its own max abs. The gradients are compared at weights whose stacked
matrices are drawn at the std of the same layer unstacked
(``well_conditioned``): the reference's init takes the stack axis as
fan-in (``repro/models/params.py:50``; std 1 at n_cycles = 1, ROADMAP
Standing notes), which saturates the attention softmax (scores ~ 1e2)
and puts the RG-LRU gates in the sigmoid's tail. There both packages'
fp32 gradients are dominated by rounding: measured at the reference's
own init (seeds 0-2, reduced RecurrentGemma-2B), wq/wk 4.7e-2 and
2.2e-2 of their scale, w_a 3.3e-3, while the loss still agrees to
5e-7. At the well-conditioned weights every gradient of both archs
agrees within 3.1e-5 of its scale (seeds 0-2). The loss is also held
at the reference's own init. Optimizer steps agree within 1e-6
relative: both packages round the same fp32 operations.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import qnn_232 as jqnn_232  # noqa: E402
from repro.core.fed import server_opt as jserver_opt  # noqa: E402
from repro.data import token_batches as jtoken_batches  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import losses as jlosses  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.optim import unitary as junitary  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, qnn_232  # noqa: E402
from repro_torch.core.fed import channel, server_opt  # noqa: E402
from repro_torch.core.quantum import channel_noise  # noqa: E402
from repro_torch.data import BigramTask, token_batches  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import gla_chunked as kgla  # noqa: E402
from repro_torch.kernels import rglru_scan as krg  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import losses  # noqa: E402
from repro_torch.optim import (SGD, AdamW, adamw, schedules, sgd,  # noqa: E402
                               unitary)

ARCHS = ("recurrentgemma-2b", "rwkv6-7b")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4     # see the module docstring
OPT_TOL = 1e-6
B, S = 2, 24


def rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def redraw_rwkv(params, seed):
    """The reference init's zero RWKV tensors drawn anew (w0 across the
    decay clip, LoRA outputs and u at a real scale, mixing in [0, 1])."""
    rng = np.random.default_rng(seed)
    draws = {"w0": lambda s: rng.uniform(-13.0, 5.0, s),
             "w_lora_b": lambda s: rng.normal(0.0, 0.1, s),
             "ts_lora_b": lambda s: rng.normal(0.0, 0.1, s),
             "u": lambda s: rng.normal(0.0, 0.5, s)}
    for name in ("mu", "mu_base", "mu_k", "mu_r"):
        draws[name] = lambda s: rng.uniform(0.0, 1.0, s)
    out = {}
    for key, val in params.items():
        val = np.asarray(val)
        name = key.rsplit("/", 1)[-1]
        if name in draws:
            val = draws[name](val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


def well_conditioned(params):
    """Stacked matrices (n_cycles, d_in, ...) rescaled from the
    reference init's std 1/sqrt(n_cycles) to the unstacked layer's
    1/sqrt(d_in)."""
    return {k: (v * np.sqrt(v.shape[0] / v.shape[1]) if
                k.startswith("stack/") and v.ndim >= 3 else v
                ).astype(np.float32) for k, v in params.items()}


def cfg_pair(arch, **over):
    return (get_config(arch).reduced(n_layers=3, **over),
            jget_config(arch).reduced(n_layers=3, **over))


def model_inputs(arch, jcfg, batch=B, seq=S, seed=0):
    """Reference-init params (RWKV's zero tensors redrawn) and a batch
    with a few labels masked, all numpy."""
    params = {k: np.asarray(v, np.float32) for k, v in
              JModel(jcfg).init(jax.random.PRNGKey(seed)).items()}
    if arch == "rwkv6-7b":
        params = redraw_rwkv(params, seed + 1)
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[rng.random((batch, seq)) < 0.2] = -1
    return params, {"tokens": tokens, "labels": labels}


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    cfg, jcfg = cfg_pair(arch)
    params, batch = model_inputs(arch, jcfg)
    jmodel = JModel(jcfg)
    # the reference's own init: the loss
    jloss0, _ = jmodel.loss_fn({k: jnp.asarray(v) for k, v in params.items()},
                               batch)
    loss0, _ = Model(cfg).loss_fn(
        convert.model_params_to_torch(params, cfg, device="cpu"),
        port_batch(batch))
    assert abs(float(loss0) - float(jloss0)) <= LOSS_TOL * abs(float(jloss0))
    # well-conditioned weights: the loss and every gradient
    params = well_conditioned(params)
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, batch)
    tp = convert.model_params_to_torch(params, cfg, device="cpu")
    loss, met, grads = loss_and_grads(Model(cfg), tp, port_batch(batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert float(met["n_tokens"]) == float(jmet["n_tokens"])
    assert rel(met["ce"], jmet["ce"]) <= LOSS_TOL
    assert sorted(grads) == sorted(jgrads)
    devs = {k: rel(grads[k], jgrads[k]) for k in grads}
    worst = max(devs, key=devs.get)
    assert devs[worst] <= GRAD_TOL, (worst, devs[worst])


def test_microbatched_gradients_equal_the_whole_batch():
    """cfg.microbatch = 2 on a batch of 4: a backward per microbatch
    scaled by 1/2, accumulated in fp32, gives the whole batch's
    gradients, and its loss is the reference's ``_loss_accum`` (the mean
    of the microbatch losses)."""
    arch = "recurrentgemma-2b"
    cfg, jcfg = cfg_pair(arch)
    params, batch = model_inputs(arch, jcfg, batch=4, seed=3)
    params = well_conditioned(params)
    # every label counts, so each microbatch has as many tokens as the
    # other and the mean of their means is the whole batch's mean
    batch["labels"] = np.abs(batch["labels"])
    tp = convert.model_params_to_torch(params, cfg, device="cpu")
    whole_loss, _, whole = loss_and_grads(Model(cfg), tp, port_batch(batch))
    mcfg = dataclasses.replace(cfg, microbatch=2)
    loss, met, grads = loss_and_grads(Model(mcfg), tp, port_batch(batch))
    assert all(g.dtype == torch.float32 for g in grads.values())
    jloss, jmet = JModel(dataclasses.replace(jcfg, microbatch=2)).loss_fn(
        {k: jnp.asarray(v) for k, v in params.items()}, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert rel(met["ce"], jmet["ce"]) <= LOSS_TOL
    assert abs(float(loss) - float(whole_loss)) <= 1e-6 * float(loss)
    for k, w in whole.items():
        assert rel(grads[k], w) <= 1e-5, k


def test_loss_fn_over_microbatches_matches_the_reference():
    """``Model.loss_fn`` on a batch of 4 with cfg.microbatch = 2 (its
    ``_loss_accum`` branch, differentiated as one expression) against
    the reference's ``loss_fn`` under ``jax.value_and_grad``: the loss
    and every gradient, some labels masked."""
    arch = "recurrentgemma-2b"
    cfg, jcfg = cfg_pair(arch, microbatch=2)
    params, batch = model_inputs(arch, jcfg, batch=4, seed=5)
    params = well_conditioned(params)
    (jloss, jmet), jgrads = jax.value_and_grad(
        JModel(jcfg).loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, batch)
    tp = {k: v.requires_grad_() for k, v in
          convert.model_params_to_torch(params, cfg, device="cpu").items()}
    loss, met = Model(cfg).loss_fn(tp, port_batch(batch))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert rel(met["ce"], jmet["ce"]) <= LOSS_TOL
    assert float(met["n_tokens"]) == float(jmet["n_tokens"])
    devs = {k: rel(grads[k], jgrads[k]) for k in grads}
    worst = max(devs, key=devs.get)
    assert devs[worst] <= GRAD_TOL, (worst, devs[worst])


def test_remat_on_and_off_give_the_same_gradients():
    arch = "recurrentgemma-2b"
    cfg, jcfg = cfg_pair(arch)
    params, batch = model_inputs(arch, jcfg, seed=4)
    tp = convert.model_params_to_torch(params, cfg, device="cpu")
    loss0, _, g0 = loss_and_grads(Model(cfg), tp, port_batch(batch))
    loss1, _, g1 = loss_and_grads(
        Model(dataclasses.replace(cfg, remat=True)), tp, port_batch(batch))
    assert float(loss0) == float(loss1)
    for k in g0:
        assert rel(g1[k], g0[k]) <= 1e-6, k


def _count(name, fn):
    def counted(*args, **kw):
        build.LAUNCHES[name] += 1
        return fn(*args, **kw)
    return counted


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_functions_backpropagate_like_the_plain_route(
        monkeypatch, arch):
    """The card's route on the CPU, with each kernel replaced by its plain
    version (counted): ``_FlashAttentionFn`` (forward with its LSE, then
    the backward from the forward's output and LSE), ``_LruScanFn`` (the
    reverse scan), ``_GlaChunkedFn`` (RWKV6's wkv and its backward, at
    chunk 16: S = 32) and the remat cycle give the plain route's loss and
    gradients, with the card's launch counts: the forward kernels twice
    (remat), the backward and the reverse scan once each. The backward
    gets the recompute's LSE. The GLA backward is the step form, which
    differs from autodiff of the chunked form by that form's rounding
    (tests/test_torch_gla_grad.py), well within 1e-5 here."""
    cfg, jcfg = cfg_pair(arch, remat=True)
    params, batch = model_inputs(arch, jcfg, seed=5,
                                 seq=32 if arch == "rwkv6-7b" else S)
    params = well_conditioned(params)
    tp = convert.model_params_to_torch(params, cfg, device="cpu")
    want_loss, _, want = loss_and_grads(Model(cfg, impl="xla"), tp,
                                        port_batch(batch))
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    lses = []

    def forward(q, k, v, **kw):
        out, lse = ref.attention_ref(q, k, v, **kw)
        lses.append(lse)
        return out, lse

    def backward(q, k, v, out, dout, *, lse, **kw):
        assert lse is lses[-1] and lse.shape == q.shape[:2]
        return ref.attention_bwd_ref(q, k, v, out, dout, lse=lse, **kw)
    monkeypatch.setattr(kfa, "flash_attention",
                        _count("flash_attention", forward))
    monkeypatch.setattr(kfa, "flash_attention_bwd",
                        _count("flash_attention_bwd", backward))
    monkeypatch.setattr(krg, "rglru_scan",
                        _count("rglru_scan", ref.rglru_scan_ref))
    monkeypatch.setattr(kgla, "gla_chunked", _count(
        "gla_chunked", lambda *x, chunk: ref.gla_chunked_ref(*x, chunk)))
    monkeypatch.setattr(kgla, "gla_chunked_bwd", _count(
        "gla_chunked_bwd",
        lambda *x, chunk: ref.gla_chunked_bwd_ref(*x, chunk)))
    build.reset_launches()
    loss, _, grads = loss_and_grads(Model(cfg), tp, port_batch(batch))
    expected = ({"flash_attention": 2, "flash_attention_bwd": 1,
                 "rglru_scan": 6} if arch == "recurrentgemma-2b" else
                {"gla_chunked": 2 * cfg.n_layers,
                 "gla_chunked_bwd": cfg.n_layers})
    assert dict(build.LAUNCHES) == expected
    build.reset_launches()
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    for k, w in want.items():
        assert rel(grads[k], w) <= 1e-5, k


def test_gla_kernel_route_never_takes_the_plain_version(monkeypatch):
    """RWKV6's wkv on the card's route reaches the kernel's wrapper with or
    without autograd recording, and never falls back to the plain one:
    the wrapper refuses CPU tensors."""
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    r = torch.randn(1, 16, 2, 8, requires_grad=True)
    w = torch.rand(1, 16, 2, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.gla_chunked(r, r, r, w, torch.zeros(2, 8), chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel"):
        ops.gla_chunked(r, r, r, w, torch.zeros(2, 8), chunk=16)


def test_cross_entropy_masks_negative_labels():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(-2, 11, (3, 7)).astype(np.int32)
    js, jn = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    s, n = losses.cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels))
    assert float(n) == float(jn) == float((labels >= 0).sum())
    assert abs(float(s) - float(js)) <= 1e-6 * abs(float(js))


# -------------------------------------------------------------- optimizers
def opt_inputs(seed, grad_scale=1.0):
    """A dict of fp32 params (2-D, 3-D and 1-D: decay applies to the
    first two only), grads and AdamW moments."""
    rng = np.random.default_rng(seed)
    shapes = {"a/w": (5, 7), "b/w": (2, 3, 4), "c/norm": (9,)}

    def draw(scale=1.0, positive=False):
        out = {k: rng.standard_normal(s).astype(np.float32) * scale
               for k, s in shapes.items()}
        return {k: np.abs(v) for k, v in out.items()} if positive else out
    return (draw(), draw(grad_scale), draw(0.1), draw(0.01, positive=True))


def t_tree(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_step_matches_the_reference(grad_scale):
    """One AdamW step from the same params, grads and moments at step 3;
    the larger grads have a global norm above the clip of 1."""
    p, g, m, v = opt_inputs(7, grad_scale)
    jopt = JAdamW(weight_decay=0.1)
    jstate = jadamw.AdamWState(step=jnp.asarray(3, jnp.int32),
                               m={k: jnp.asarray(x) for k, x in m.items()},
                               v={k: jnp.asarray(x) for k, x in v.items()})
    jp, js = jopt.update({k: jnp.asarray(x) for k, x in g.items()}, jstate,
                         {k: jnp.asarray(x) for k, x in p.items()}, 3e-3)
    state = convert.adamw_state_to_torch(jstate, device="cpu")
    grads = t_tree(g)
    gnorm = float(adamw.global_norm(grads))
    assert abs(gnorm - float(jadamw.global_norm(g))) <= 1e-6 * gnorm
    assert (gnorm > 1.0) == (grad_scale > 1.0)
    tp, ts = AdamW(weight_decay=0.1).update(grads, state, t_tree(p), 3e-3)
    assert int(ts.step) == int(js.step) == 4
    back = convert.adamw_state_to_numpy(ts)
    for k in p:
        assert rel(tp[k], jp[k]) <= OPT_TOL, k
        assert rel(back[1][k], js.m[k]) <= OPT_TOL, k
        assert rel(back[2][k], js.v[k]) <= OPT_TOL, k
    # the clip scales the grads in place: their norm is now at most 1
    assert float(adamw.global_norm(grads)) <= max(1.0, gnorm) * (1 + 1e-6)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_steps_match_the_reference(momentum, nesterov):
    p, g, m, _ = opt_inputs(8)
    jopt = JSGD(momentum=momentum, nesterov=nesterov)
    opt = SGD(momentum=momentum, nesterov=nesterov)
    jp = {k: jnp.asarray(x) for k, x in p.items()}
    jstate, state = jopt.init(jp), opt.init(t_tree(p))
    if momentum:
        jstate = jstate._replace(momentum={k: jnp.asarray(x)
                                           for k, x in m.items()})
        state = state._replace(momentum=t_tree(m))
    tp = t_tree(p)
    for _ in range(2):              # the second step reads the momentum
        jp, jstate = jopt.update({k: jnp.asarray(x) for k, x in g.items()},
                                 jstate, jp, 0.05)
        tp, state = opt.update(t_tree(g), state, tp, 0.05)
    assert int(state.step) == int(jstate.step) == 2
    for k in p:
        assert rel(tp[k], jp[k]) <= OPT_TOL, k
        if momentum:
            assert rel(state.momentum[k], jstate.momentum[k]) <= OPT_TOL, k
        else:
            assert state.momentum is None and jstate.momentum is None


def test_adamw_converges_and_survives_huge_grads():
    """The reference's own optimizer cases (tests/test_checkpoint_data_
    optim.py): a quadratic converges; a clipped 1e6 gradient stays
    finite."""
    opt = AdamW(weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(300):
        params, state = opt.update({"w": 2 * params["w"]}, state, params,
                                   0.05)
    assert float(params["w"].abs().max()) < 1e-2
    p1, _ = AdamW(weight_decay=0.0).update(
        {"w": torch.full((3,), 1e6)}, AdamW().init({"w": torch.zeros(3)}),
        {"w": torch.zeros(3)}, 0.1)
    assert bool(torch.isfinite(p1["w"]).all())


@pytest.mark.parametrize("name,args", [
    ("constant", (0.5,)), ("linear_warmup_cosine", (1.0, 10, 100)),
    ("linear_warmup_cosine", (3e-3, 0, 5)), ("inverse_sqrt", (2e-3, 8))])
def test_schedules_match_the_reference(name, args):
    fn, jfn = getattr(schedules, name)(*args), getattr(jschedules, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got, want = fn(step), jfn(step)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * max(abs(float(want)),
                                                           1e-30), step


def test_unitary_optimizer_matches_the_reference(x64):
    from repro.core.quantum import qnn as jqnn
    params = [np.asarray(u) for u in
              jqnn.init_params(jax.random.PRNGKey(0), (2, 3, 2))]
    drifted = [u + 1e-3 for u in params]
    tp = convert.params_to_torch(drifted, device="cpu")
    err, jerr = unitary.unitarity_error(tp), junitary.unitarity_error(
        [jnp.asarray(u) for u in drifted])
    assert abs(float(err) - float(jerr)) <= 1e-12 and float(err) > 1e-4
    fixed, jfixed = unitary.reunitarize(tp), junitary.reunitarize(
        [jnp.asarray(u) for u in drifted])
    assert float(unitary.unitarity_error(fixed)) < 1e-12
    for a, b in zip(fixed, jfixed):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-10
    rng = np.random.default_rng(9)
    ks = []
    for u in params:
        x = rng.standard_normal(u.shape) + 1j * rng.standard_normal(u.shape)
        ks.append(x + np.conj(np.swapaxes(x, -1, -2)))
    got = unitary.apply(convert.params_to_torch(params, device="cpu"),
                        convert.params_to_torch(ks, device="cpu"), 0.1)
    want = junitary.apply([jnp.asarray(u) for u in params],
                          [jnp.asarray(k) for k in ks], 0.1)
    for a, b in zip(got, want):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-10


def test_make_sgd_matches_the_reference():
    for name in server_opt.SERVER_OPTS:
        got, want = server_opt.make_sgd(name, 0.7), \
            jserver_opt.make_sgd(name, 0.7)
        if want is None:
            assert got is None
        else:
            assert isinstance(got, sgd.SGD)
            assert (got.momentum, got.nesterov) == (want.momentum,
                                                    want.nesterov)
    with pytest.raises(ValueError, match="unknown server_opt"):
        server_opt.make_sgd("adam", 0.9)


# ------------------------------------------------------ quantum leftovers
def test_channel_noise_shim_reexports():
    names = ("HermitianNoiseChannel", "QuantizationChannel",
             "hermitian_noise", "make_channel", "perturb_updates")
    for name in names:
        assert getattr(channel_noise, name) is getattr(channel, name)


def test_qnn_232_strategy_overrides_match_the_reference():
    try:
        for mod in (qnn_232, jqnn_232):
            mod.set_strategy_overrides(aggregation="average",
                                       participation="weighted")
            with pytest.raises((KeyError, ValueError)):
                mod.set_strategy_overrides(aggregation="nope")
        got = qnn_232.config(interval_length=2)
        want = jqnn_232.config(interval_length=2)
        assert got._asdict() == want._asdict()
        assert got.aggregation == "average"
        assert qnn_232.config(aggregation="product").aggregation == "product"
    finally:
        qnn_232._OVERRIDES.clear()
        jqnn_232._OVERRIDES.clear()
    assert qnn_232.config() == qnn_232.CONFIG


def test_noise_robustness_example_runs_on_the_cpu():
    """``examples/torch_noise_robustness.py`` (the JAX example's runs
    through the port's ``qnn_232.config``, ``make_federated_dataset``
    and ``federated.train``) at 2 rounds: a clean-test fidelity in
    [0, 1] for each noise ratio."""
    import importlib.util
    import warnings
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_noise_robustness.py"
    spec = importlib.util.spec_from_file_location("torch_noise_rob", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = mod.main(["--device", "cpu", "--iters", "2"])
    assert sorted(out) == [0.0, 0.3, 0.7]
    assert all(0.0 <= f <= 1.0 + 1e-6 for f in out.values())


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ARCHS)
def test_token_batches_are_the_references_bit_for_bit(arch):
    cfg, jcfg = get_config(arch), jget_config(arch).reduced()
    ours = token_batches(cfg.reduced(), 3, 17, seed=5, device="cpu")
    theirs = jtoken_batches(jcfg, 3, 17, seed=5)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    task = BigramTask(50, seed=1)
    assert task.successors.shape == (50, 4)


# ------------------------------------------- the kernels' backward algebra
@pytest.mark.parametrize("bh,bk,sq,sk,causal,window", [
    (4, 2, 33, 33, True, 0), (6, 2, 40, 40, True, 7),
    (3, 3, 19, 19, False, 5), (2, 1, 30, 9, True, 4),
    (4, 1, 70, 70, False, 0)])
def test_attention_backward_reference_matches_autograd(bh, bk, sq, sk, causal,
                                                       window):
    """``ref.attention_bwd_ref`` (LSE, D from the output, P recomputed)
    against autograd of ``ref.attention_ref``: causal, windowed, G > 1,
    ragged S, rows with no allowed key (Sq > Sk + window - 1)."""
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn((bh, sq, 16), generator=g, requires_grad=True)
    k = torch.randn((bk, sk, 16), generator=g, requires_grad=True)
    v = torch.randn((bk, sk, 16), generator=g, requires_grad=True)
    kw = dict(causal=causal, window=window)
    o = ref.attention_ref(q, k, v, **kw)
    do = torch.randn(o.shape, generator=g)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                o.detach(), do, **kw)
    for name, a, b in zip("qkv", got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    if window and sq > sk + window - 1:
        assert not got[0][:, sk + window - 1:].abs().max()


@pytest.mark.parametrize("bh,bk,sq,sk,causal,window", [
    (4, 2, 33, 33, True, 0), (6, 2, 40, 40, True, 7),
    (3, 3, 19, 19, False, 5), (2, 1, 30, 9, True, 0),
    (4, 1, 70, 70, False, 0)])
def test_attention_backward_with_the_lse_matches_jax_vjp(bh, bk, sq, sk,
                                                         causal, window):
    """``ref.attention_bwd_ref`` given the LSE of ``ref.attention_ref(...,
    return_lse=True)`` (what the CUDA backward takes from the forward)
    against ``jax.vjp`` of the reference's ``repro.kernels.ref
    .attention_ref`` on the same fp32 arrays (k, v repeated to every query
    head; dk, dv summed back over the group), within 1e-5 of each
    gradient's scale: causal, windowed, GQA, Sq > Sk."""
    rng = np.random.default_rng(bh + sq + sk + window)
    q, do = (rng.standard_normal((bh, sq, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((bk, sk, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    out, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.attention_bwd_ref(tq, tk, tv, out, tdo, lse=lse, **kw)
    g = bh // bk
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **kw),
                     jnp.asarray(q), jnp.repeat(k, g, axis=0),
                     jnp.repeat(v, g, axis=0))
    jdq, jdk, jdv = (np.asarray(x) for x in vjp(jnp.asarray(do)))
    want = (jdq, jdk.reshape(bk, g, sk, 16).sum(1),
            jdv.reshape(bk, g, sk, 16).sum(1))
    for name, a, b in zip("qkv", got, want):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * float(
            np.abs(b).max()), name


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 64, 3)])
def test_scan_adjoint_algebra_matches_autograd(shape):
    """``_LruScanFn`` with the plain scan passed in: the reversed scan of
    the shifted gates gives autograd's da and db of the plain scan."""
    g = torch.Generator().manual_seed(shape[1])
    a = torch.rand(shape, generator=g).requires_grad_()
    b = torch.randn(shape, generator=g).requires_grad_()
    gy = torch.randn(shape, generator=g)
    got = torch.autograd.grad(ops._LruScanFn.apply(a, b, ref.rglru_scan_ref),
                              (a, b), gy)
    want = torch.autograd.grad(ref.rglru_scan_ref(a, b), (a, b), gy)
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


# ---------------------------------------------------------------- driver
@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_and_meets_the_references_trajectory(arch,
                                                               monkeypatch):
    """``python -m repro_torch.launch.train --device cpu --scale smoke``
    for 3 steps; with the reference's initial params (its init draws
    from a JAX key, the port's from torch) both drivers see the same
    token stream and optimizer, so their final losses meet."""
    argv = ["--arch", arch, "--scale", "smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--log-every", "1", "--seed", "1"]
    loss = train.main(argv + ["--device", "cpu"])
    assert np.isfinite(loss)
    if arch != "recurrentgemma-2b":
        return            # one reference trajectory keeps the file short
    jcfg = jget_config(arch).reduced()
    jparams = {k: np.asarray(v) for k, v in
               JModel(jcfg).init(jax.random.PRNGKey(1)).items()}
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device="cuda":
                        convert.model_params_to_torch(jparams, self.cfg,
                                                      device=device))
    loss = train.main(argv + ["--device", "cpu"])
    want = jtrain.main(argv)
    assert abs(loss - want) <= 1e-4 * abs(want), (loss, want)


def test_train_step_updates_params_in_place():
    cfg = get_config("recurrentgemma-2b").reduced()
    model, opt = Model(cfg), AdamW()
    params = model.init(seed=0, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    batch = next(token_batches(cfg, 2, 16, seed=0, device="cpu"))
    new, state, metrics = make_train_step(model, opt)(params, state, batch,
                                                      1e-3)
    assert all(new[k] is params[k] for k in params)
    assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(before[k], params[k]) for k in params)
    assert not any(v.requires_grad for v in params.values())
