"""The port's RWKV6 serving path against the JAX reference (CPU, fp32,
the kernel's plain version).

Layers get the same numpy inputs and params on both sides and agree to
1e-5 of the output's scale. The whole model runs on
``get_config("rwkv6-7b").reduced()`` (2 layers, d_model 256, 4 heads of
64). The reference's init leaves the decay, bonus and mixing tensors at
zero (``u``, ``w0``, ``w_lora_b``, ``mu``, ``mu_base``, ``ts_lora_b``,
``mu_k``, ``mu_r``): w is then exp(-1) everywhere, the bonus is 0 and the
token shift does nothing. So most cases redraw those tensors in numpy
(``redraw``) and give them to both packages: w then varies over tokens
and channels and reaches both ends of the clip, and u is nonzero. One
case of each keeps the reference's own init.

Whole-model tolerance, 1e-4 of the scale: only summation order differs;
measured up to 3.7e-5 over three seeds (the wkv state, a sum over
every token, is the largest), with stacked weights drawn at std
1/sqrt(n_cycles) = 0.71 as the reference's init does (ROADMAP Queue 3).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import rwkv as jrwkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import norms  # noqa: E402
from repro_torch.models.layers import rwkv  # noqa: E402

ARCH = "rwkv6-7b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4     # see the module docstring
T = 64
N_DECODE = 4


def rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def t(x):
    return torch.as_tensor(np.array(x))


def redraw(params, seed):
    """The reference's zero-initialised RWKV tensors drawn anew: w0 so
    that the decay logit spans and passes the clip [-12, 4], the LoRA
    outputs and u at a real scale, the mixing coefficients in [0, 1]."""
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
            assert not val.any(), key      # the reference leaves it at 0
            val = draws[name](val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH).reduced(), jget_config(ARCH).reduced()


def layer_params(init_fn, jcfg, pfx, init):
    """One unstacked layer's params, drawn by the reference (redrawn or
    not) and carried to the port: (jax dict, torch dict)."""
    ini = jpp.Initializer(jnp.float32, key=jax.random.PRNGKey(3))
    init_fn(ini, pfx, jcfg)
    p = jpp.subtree(ini.params, pfx)
    if init == "redrawn":
        p = redraw(p, 4)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: t(v) for k, v in p.items()})


# ---------------------------------------------------------------- layers
def test_groupnorm_heads_uses_the_population_variance():
    rng = np.random.default_rng(0)
    x = 3.0 * rng.standard_normal((2, 7, 256)).astype(np.float32) + 1.0
    scale = rng.standard_normal(256).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    got = norms.groupnorm_heads(t(scale), t(bias), t(x), 4)
    want = jnorms.groupnorm_heads(jnp.asarray(scale), jnp.asarray(bias),
                                  jnp.asarray(x), 4)
    assert rel(got, want) <= LAYER_TOL
    # torch's default (unbiased) variance is another function
    xh = t(x).reshape(2, 7, 4, 64)
    unbiased = ((xh - xh.mean(-1, keepdim=True))
                / torch.sqrt(xh.var(-1, keepdim=True) + 1e-5)).reshape(2, 7, 256)
    assert rel(unbiased * t(scale) + t(bias), want) > 1e-3


def test_redrawn_params_span_the_decay_range(cfgs, monkeypatch):
    """With the redraw, w reaches both clip ends (the 1e-20 clamp of
    log w is live, and decays round to 1 in bf16); at the reference's
    init it is exp(-1) everywhere."""
    cfg, jcfg = cfgs
    x = np.random.default_rng(1).standard_normal((2, 48, 256)).astype(
        np.float32)
    for init, check in (("redrawn", lambda w: float(w.min()) < 1e-20
                         and float(w.max()) > 0.999
                         and float(w.max()) < 1.0
                         and float(w.max().bfloat16()) == 1.0),
                        ("reference", lambda w: torch.allclose(
                            w, torch.full_like(w, float(np.exp(-1.0)))))):
        _, tp = layer_params(jrwkv.init_rwkv_time_mix, jcfg, "tm", init)
        seen = []
        orig = ref.gla_chunked_ref

        def recording(r, k, v, w, u, chunk):
            seen.append(w)
            return orig(r, k, v, w, u, chunk)
        monkeypatch.setattr(ref, "gla_chunked_ref", recording)
        rwkv.rwkv_time_mix(tp, t(x), cfg)
        monkeypatch.undo()
        (w,) = seen
        assert w.dtype == torch.float32 and w.shape == (2, 48, 4, 64)
        assert check(w), init


@pytest.mark.parametrize("s", [48, 37])
@pytest.mark.parametrize("init", ["redrawn", "reference"])
def test_time_mix_prefill(cfgs, s, init):
    """y, the shift state and the wkv state; S = 37 is not a multiple of
    the chunk (16), so the chunk is 1."""
    cfg, jcfg = cfgs
    jp, tp = layer_params(jrwkv.init_rwkv_time_mix, jcfg, "tm", init)
    x = np.random.default_rng(s).standard_normal((2, s, 256)).astype(
        np.float32)
    y, (shift, wkv) = rwkv.rwkv_time_mix(tp, t(x), cfg)
    jy, (jshift, jwkv) = jrwkv.rwkv_time_mix(jp, jnp.asarray(x), jcfg)
    assert rel(y, jy) <= LAYER_TOL
    assert rel(shift, jshift) == 0.0
    assert wkv.dtype == torch.float32 and wkv.shape == (2, 4, 64, 64)
    assert rel(wkv, jwkv) <= LAYER_TOL


@pytest.mark.parametrize("init", ["redrawn", "reference"])
def test_time_mix_decode_step(cfgs, init):
    cfg, jcfg = cfgs
    jp, tp = layer_params(jrwkv.init_rwkv_time_mix, jcfg, "tm", init)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, 256)).astype(np.float32)
    shift0 = rng.standard_normal((2, 256)).astype(np.float32)
    wkv0 = rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
    y, (shift, wkv) = rwkv.rwkv_time_mix(tp, t(x), cfg, shift_state=t(shift0),
                                         wkv_state=t(wkv0))
    jy, (jshift, jwkv) = jrwkv.rwkv_time_mix(
        jp, jnp.asarray(x), jcfg, shift_state=jnp.asarray(shift0),
        wkv_state=jnp.asarray(wkv0))
    assert rel(y, jy) <= LAYER_TOL
    assert rel(shift, jshift) == 0.0
    assert rel(wkv, jwkv) <= LAYER_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix(cfgs, with_state):
    cfg, jcfg = cfgs
    jp, tp = layer_params(jrwkv.init_rwkv_channel_mix, jcfg, "cm", "redrawn")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 256)).astype(np.float32)
    prev = rng.standard_normal((2, 256)).astype(np.float32)
    y, shift = rwkv.rwkv_channel_mix(tp, t(x), cfg,
                                     shift_state=t(prev) if with_state
                                     else None)
    jy, jshift = jrwkv.rwkv_channel_mix(
        jp, jnp.asarray(x), jcfg,
        shift_state=jnp.asarray(prev) if with_state else None)
    assert rel(y, jy) <= LAYER_TOL
    assert rel(shift, jshift) == 0.0


# ---------------------------------------------------------------- model
def _setup(init, seed=0, **overrides):
    cfg, jcfg = (get_config(ARCH).reduced(**overrides),
                 jget_config(ARCH).reduced(**overrides))
    jm, m = JModel(jcfg), Model(cfg)
    jp = {k: np.asarray(v) for k, v in
          jm.init(jax.random.PRNGKey(seed)).items()}
    if init == "redrawn":
        jp = redraw(jp, seed + 1)
    tp = convert.model_params_to_torch(jp, cfg, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, T + N_DECODE)).astype(np.int32)
    return cfg, jm, m, jp, tp, toks


@pytest.fixture(scope="module", params=["redrawn", "reference"])
def model_case(request):
    return _setup(request.param)


def test_param_paths_shapes_and_count_match_the_reference(model_case):
    cfg, jm, m, jp, tp, _ = model_case
    specs, _ = jm.abstract_params()
    mine = m.abstract_params()
    assert sorted(mine) == sorted(specs) == sorted(tp)
    # 22 per block (ln1, 15 time-mix, ln2, 5 channel-mix) + the token
    # embedding, the untied head and the final norm
    assert len([k for k in mine if "/rwkv/" in k]) == 22 and len(mine) == 25
    assert not any("/mlp/" in k for k in mine)
    for k, spec in specs.items():
        assert tuple(mine[k].shape) == tuple(spec.shape), k
        assert mine[k].device.type == "meta"
    assert m.num_params() == jm.num_params()


def test_forward_train_logits(model_case):
    cfg, jm, m, jp, tp, toks = model_case
    logits, aux = m.forward_train(tp, {"tokens": t(toks[:, :T])})
    jlogits, _ = jm.forward_train(jp, {"tokens": jnp.asarray(toks[:, :T])})
    assert logits.shape == (2, T, cfg.vocab_size) and aux == {}
    assert rel(logits, jlogits) <= MODEL_TOL


def _prefill(model_case, n):
    cfg, jm, m, jp, tp, toks = model_case
    logits, cache = make_prefill_step(m)(tp, {"tokens": t(toks[:, :n])})
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :n])})
    return logits, cache, jlogits, jcache


@pytest.fixture(scope="module")
def prefilled(model_case):
    return _prefill(model_case, T)


@pytest.mark.parametrize("n", [T, 30])
def test_prefill_logits_and_cache_entries(model_case, prefilled, n):
    """S = 64 runs the chunk of 16; S = 30 is not a multiple of it and
    runs the chunk of 1."""
    logits, cache, jlogits, jcache = (prefilled if n == T
                                      else _prefill(model_case, n))
    assert logits.shape == (2, model_case[0].vocab_size)
    assert rel(logits, jlogits) <= MODEL_TOL
    assert sorted(cache) == sorted(jcache) == [
        "stack/0/shift_cm", "stack/0/shift_tm", "stack/0/wkv"]
    for key in jcache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
        assert cache[key].dtype == torch.float32, key
        assert rel(cache[key], jcache[key]) <= MODEL_TOL, key


def test_decode_steps_after_prefill(model_case, prefilled):
    cfg, jm, m, jp, tp, toks = model_case
    _, cache, _, jc = prefilled
    cache = m.extend_cache(cache, T + N_DECODE)
    jstep = jax.jit(jm.decode_step)
    serve_step = make_serve_step(m)
    for i in range(N_DECODE):
        cur = T + i
        tok = toks[:, cur:cur + 1]
        next_tok, logits, cache = serve_step(tp, cache, {"tokens": t(tok)},
                                             cur)
        jlogits, jc = jstep(jp, {"tokens": jnp.asarray(tok)}, jc,
                            jnp.int32(cur))
        assert rel(logits, jlogits) <= MODEL_TOL, i
        assert torch.equal(next_tok, torch.argmax(logits, -1).int())
    for key in jc:
        assert rel(cache[key], jc[key]) <= MODEL_TOL, key


def test_decode_matches_forward():
    """The port's token-by-token decode reproduces its own full forward
    at the reference's own gate (tests/test_decode_consistency.py, with
    gla_chunk=4), with the redrawn params."""
    cfg, _, m, _, tp, toks = _setup("redrawn", seed=2, gla_chunk=4)
    n = 16
    full, _ = m.forward_train(tp, {"tokens": t(toks[:, :n])})
    cache = m.init_cache(2, n, device="cpu")
    steps = []
    for i in range(n):
        logits, cache = m.decode_step(tp, {"tokens": t(toks[:, i:i + 1])},
                                      cache, i)
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


def test_extend_cache_keeps_the_recurrent_state(prefilled):
    """No RWKV key is a k/v cache (``.../wkv`` does not end in ``/v``):
    extend_cache copies the three states as they are."""
    _, cache, _, _ = prefilled
    m = Model(get_config(ARCH).reduced())
    ext = m.extend_cache(cache, T + 100)
    assert sorted(ext) == sorted(cache)
    for key, val in cache.items():
        assert ext[key].shape == val.shape and torch.equal(ext[key], val)
        assert ext[key].data_ptr() != val.data_ptr()


# ---------------------------------------------------------------- configs
def test_full_config():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JREG[ARCH])
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        JREG[ARCH].reduced())
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.gla_chunk) == (32, 4096, 64, 64, 14336,
                                               65536, 16)
    assert cfg.torch_dtype == torch.bfloat16
    assert Model(cfg).num_params() == 7_576_752_128


def test_serve_cli_on_the_cpu(capsys):
    gen = serve.main(["--arch", ARCH, "--device", "cpu"])
    assert gen.shape == (4, 16)
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b-smoke" in out and "device=cpu" in out
