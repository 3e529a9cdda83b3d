"""The port's RecurrentGemma serving path against the JAX reference (CPU,
fp32, the kernels' plain versions).

Layers get the same numpy inputs and converted params on both sides and
agree to 1e-5 of the output's scale. The whole model runs on
``get_config("recurrentgemma-2b").reduced()`` with T = 96 tokens (past
its window of 64) and on ``.reduced(n_layers=5)``, whose two remainder
layers exercise the unstacked ``rem/`` params and caches.

Whole-model tolerance, 1e-3 of the scale: only summation order differs,
but the reference's init draws stacked weights with the stack axis as
fan-in (``repro/models/params.py:50``; n_cycles = 1 at the reduced
config, so std 1), which puts the RG-LRU gate pre-activations near
|z| ~ 2e3. In the sigmoid's tail r ~ e^z, so an fp32 rounding
difference of ~1e-7 |z| in z becomes a ~1e-4 relative difference in the
gate sqrt(1 - a^2) ~ sqrt(r): measured 1.3e-4 to 2.0e-4 of the logits'
scale over three seeds. The layer tests, at unstacked init (fan-in d),
have no such amplification and hold 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import embeddings as jemb  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import rglru as jrglru  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import concrete_batch  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import params as pp  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.models.layers import embeddings as emb  # noqa: E402
from repro_torch.models.layers import mlp as mlp_lib  # noqa: E402
from repro_torch.models.layers import norms  # noqa: E402
from repro_torch.models.layers import rglru  # noqa: E402

ARCH = "recurrentgemma-2b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-3     # see the module docstring
T = 96
N_DECODE = 8


def rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def t(x):
    return torch.as_tensor(np.array(x))


def layer_params(init_fn, cfg, jcfg, pfx):
    """One unstacked layer's params, drawn by the reference and carried
    to the port: (jax dict, torch dict), both without the prefix."""
    ini = jpp.Initializer(jnp.float32, key=jax.random.PRNGKey(3))
    init_fn(ini, pfx, jcfg)
    jp = jpp.subtree(ini.params, pfx)
    return jp, {k: t(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH).reduced(), jget_config(ARCH).reduced()


# ---------------------------------------------------------------- layers
def test_rmsnorm(cfgs):
    rng = np.random.default_rng(0)
    x = 3.0 * rng.standard_normal((2, 7, 256)).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    got = norms.rmsnorm(t(scale), t(x), 1e-6)
    assert rel(got, jnorms.rmsnorm(jnp.asarray(scale), jnp.asarray(x),
                                   1e-6)) <= LAYER_TOL


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 11)).astype(np.int32)
    got = emb.apply_rope(t(x), t(pos), theta)
    assert rel(got, jemb.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    theta)) <= LAYER_TOL


def test_embed_and_unembed(cfgs):
    cfg, jcfg = cfgs
    ini = jpp.Initializer(jnp.float32, key=jax.random.PRNGKey(4))
    jemb.init_embeddings(ini, jcfg)
    tp = {k: t(v) for k, v in ini.params.items()}
    toks = np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32)
    x = emb.embed_tokens(tp, t(toks), cfg)
    jx = jemb.embed_tokens(ini.params, jnp.asarray(toks), jcfg)
    assert rel(x, jx) <= LAYER_TOL
    logits = emb.unembed(tp, x, cfg)
    assert logits.dtype == torch.float32
    assert rel(logits, jemb.unembed(ini.params, jx, jcfg)) <= LAYER_TOL


def test_mlp_gelu_is_the_tanh_approximation(cfgs):
    cfg, jcfg = cfgs
    assert cfg.act == "gelu"
    jp, tp = layer_params(jmlp.init_mlp, cfg, jcfg, "mlp")
    x = np.random.default_rng(5).standard_normal((2, 9, 256)).astype(
        np.float32)
    got = mlp_lib.mlp(tp, t(x), cfg)
    assert rel(got, jmlp.mlp(jp, jnp.asarray(x), jcfg)) <= LAYER_TOL
    # torch's default (exact) gelu is a different function
    z = torch.linspace(-4, 4, 101)
    assert float((mlp_lib.gelu(z) - torch.nn.functional.gelu(z)).abs().max()) \
        > 1e-4
    assert rel(mlp_lib.gelu(z), jax.nn.gelu(jnp.asarray(z.numpy()))) <= 1e-6


@pytest.mark.parametrize("window", [0, 16])
def test_self_attention_prefill(cfgs, window):
    cfg, jcfg = cfgs
    jp, tp = layer_params(jattn.init_attention, cfg, jcfg, "attn")
    x = np.random.default_rng(6).standard_normal((2, 40, 256)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    y, kv = attn.self_attention(tp, t(x), cfg, positions=t(pos),
                                window=window)
    jy, _ = jattn.self_attention(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos), window=window)
    assert rel(y, jy) <= LAYER_TOL
    assert kv["k"].shape == (2, 40, cfg.n_kv_heads, cfg.head_dim)


def test_self_attention_decode(cfgs):
    cfg, jcfg = cfgs
    jp, tp = layer_params(jattn.init_attention, cfg, jcfg, "attn")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, 256)).astype(np.float32)
    ck = rng.standard_normal((2, 24, 1, 64)).astype(np.float32)
    cv = rng.standard_normal((2, 24, 1, 64)).astype(np.float32)
    pos = np.full((2, 1), 17, np.int32)
    cache = {"k": t(ck).clone(), "v": t(cv).clone()}
    y, new = attn.self_attention(tp, t(x), cfg, positions=t(pos), window=8,
                                 cache=cache, cur_len=17)
    jy, jnew = jattn.self_attention(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), window=8,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cur_len=jnp.int32(17))
    assert rel(y, jy) <= LAYER_TOL
    assert new is cache                     # written in place
    for k in ("k", "v"):
        assert rel(new[k], jnew[k]) <= LAYER_TOL


def _rec(cfgs, s, seed):
    cfg, jcfg = cfgs
    jp, tp = layer_params(jrglru.init_recurrent_block, cfg, jcfg, "rec")
    x = np.random.default_rng(seed).standard_normal((2, s, 256)).astype(
        np.float32)
    return cfg, jcfg, jp, tp, x


def test_recurrent_block_prefill(cfgs):
    cfg, jcfg, jp, tp, x = _rec(cfgs, 50, 8)
    y, (conv, h) = rglru.recurrent_block(tp, t(x), cfg)
    jy, (jconv, jh) = jrglru.recurrent_block(jp, jnp.asarray(x), jcfg)
    assert rel(y, jy) <= LAYER_TOL
    assert rel(conv, jconv) <= LAYER_TOL
    assert h.dtype == torch.float32 and rel(h, jh) <= LAYER_TOL


def test_recurrent_block_decode(cfgs):
    cfg, jcfg, jp, tp, x = _rec(cfgs, 1, 9)
    rng = np.random.default_rng(10)
    conv0 = rng.standard_normal((2, 3, 256)).astype(np.float32)
    h0 = rng.standard_normal((2, 256)).astype(np.float32)
    y, (conv, h) = rglru.recurrent_block(tp, t(x), cfg,
                                         state=(t(conv0), t(h0)))
    jy, (jconv, jh) = jrglru.recurrent_block(
        jp, jnp.asarray(x), jcfg, state=(jnp.asarray(conv0),
                                         jnp.asarray(h0)))
    assert rel(y, jy) <= LAYER_TOL
    assert rel(conv, jconv) <= LAYER_TOL
    assert rel(h, jh) <= LAYER_TOL


def test_recurrent_block_continues_from_a_state(cfgs):
    """A sequence after a carried state (h0 with S > 1): the scan from
    zero plus the cumulative decay of h0."""
    cfg, jcfg, jp, tp, x = _rec(cfgs, 12, 11)
    rng = np.random.default_rng(12)
    conv0 = rng.standard_normal((2, 3, 256)).astype(np.float32)
    h0 = rng.standard_normal((2, 256)).astype(np.float32)
    y, (_, h) = rglru.recurrent_block(tp, t(x), cfg, state=(t(conv0), t(h0)))
    jy, (_, jh) = jrglru.recurrent_block(
        jp, jnp.asarray(x), jcfg, state=(jnp.asarray(conv0),
                                         jnp.asarray(h0)))
    assert rel(y, jy) <= LAYER_TOL
    assert rel(h, jh) <= LAYER_TOL


# ---------------------------------------------------------------- model
def _setup(n_layers):
    cfg = get_config(ARCH).reduced(**({"n_layers": n_layers}
                                      if n_layers else {}))
    jcfg = jget_config(ARCH).reduced(**({"n_layers": n_layers}
                                        if n_layers else {}))
    jm, m = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.model_params_to_torch(
        {k: np.asarray(v) for k, v in jp.items()}, cfg, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, T + N_DECODE)).astype(np.int32)
    return cfg, jm, m, jp, tp, toks


@pytest.fixture(scope="module", params=[None, 5], ids=["reduced", "rem"])
def model_case(request):
    return _setup(request.param)


def test_layout_has_stack_and_rem(model_case):
    cfg, _, _, _, tp, _ = model_case
    assert cfg.n_cycles == 1
    assert any(k.startswith("rem/") for k in tp) == (cfg.n_rem > 0)


def test_forward_train_logits(model_case):
    cfg, jm, m, jp, tp, toks = model_case
    batch = {"tokens": toks[:, :T]}
    logits, aux = m.forward_train(tp, {"tokens": t(batch["tokens"])})
    jlogits, _ = jm.forward_train(jp, {"tokens": jnp.asarray(batch["tokens"])})
    assert logits.shape == (2, T, cfg.vocab_size) and aux == {}
    assert logits.dtype == torch.float32
    assert rel(logits, jlogits) <= MODEL_TOL


@pytest.fixture(scope="module")
def prefilled(model_case):
    cfg, jm, m, jp, tp, toks = model_case
    logits, cache = make_prefill_step(m)(tp, {"tokens": t(toks[:, :T])})
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T])})
    return logits, cache, jlogits, jcache


def test_prefill_logits(model_case, prefilled):
    logits, _, jlogits, _ = prefilled
    assert logits.shape == (2, model_case[0].vocab_size)
    assert rel(logits, jlogits) <= MODEL_TOL


def test_prefill_cache_entries(model_case, prefilled):
    _, cache, _, jcache = prefilled
    assert sorted(cache) == sorted(jcache)
    for key in jcache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
        assert cache[key].dtype == {"float32": torch.float32}[
            str(jcache[key].dtype)], key
        assert rel(cache[key], jcache[key]) <= MODEL_TOL, key


def test_decode_steps_after_prefill(model_case, prefilled):
    """Prefill T tokens, move the cache into a T + 8 decode cache, then 8
    decode steps; the reference gets the same cache (k/v padded in numpy)
    and the same tokens."""
    cfg, jm, m, jp, tp, toks = model_case
    _, cache, _, jcache = prefilled
    max_len = T + N_DECODE
    cache = m.extend_cache(cache, max_len)
    jc = {}
    for key, v in jcache.items():
        v = np.asarray(v)
        if key.endswith("/k") or key.endswith("/v"):
            pad = [(0, 0)] * v.ndim
            pad[v.ndim - 3] = (0, N_DECODE)
            v = np.pad(v, pad)
        jc[key] = jnp.asarray(v)
    jstep = jax.jit(jm.decode_step)
    serve = make_serve_step(m)
    for i in range(N_DECODE):
        cur = T + i
        tok = toks[:, cur:cur + 1]
        next_tok, logits, cache = serve(tp, cache, {"tokens": t(tok)}, cur)
        jlogits, jc = jstep(jp, {"tokens": jnp.asarray(tok)}, jc,
                            jnp.int32(cur))
        assert rel(logits, jlogits) <= MODEL_TOL, i
        assert next_tok.dtype == torch.int32
        assert torch.equal(next_tok, torch.argmax(logits, -1).int())
    for key in jc:
        assert rel(cache[key], jc[key]) <= MODEL_TOL, key


def test_decode_matches_forward(model_case):
    """The port's token-by-token decode reproduces its own full forward,
    at the reference's own gate (tests/test_decode_consistency.py)."""
    cfg, _, m, _, tp, toks = model_case
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


# ---------------------------------------------------------------- params
def test_param_paths_shapes_and_count_match_the_reference(model_case):
    cfg, jm, m, jp, tp, _ = model_case
    specs, _ = jm.abstract_params()
    mine = m.abstract_params()
    assert sorted(mine) == sorted(specs)
    for k, spec in specs.items():
        assert tuple(mine[k].shape) == tuple(spec.shape), k
        assert mine[k].device.type == "meta"
    assert m.num_params() == jm.num_params()


def test_full_config_size():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.d_rnn, cfg.vocab_size, cfg.window) == (
        26, 2560, 10, 1, 256, 7680, 2560, 256000, 2048)
    assert (cfg.n_cycles, cfg.n_rem) == (8, 2)
    assert Model(cfg).num_params() == JModel(jget_config(ARCH)).num_params() \
        == 2_894_574_080


def test_init_kinds_and_scales():
    cfg = get_config(ARCH).reduced()
    params = Model(cfg).init(seed=1, device="cpu")
    again = Model(cfg).init(seed=1, device="cpu")
    other = Model(cfg).init(seed=2, device="cpu")
    for k in params:
        assert torch.equal(params[k], again[k]), k
    assert not torch.equal(params["embed/tokens"], other["embed/tokens"])
    assert torch.equal(params["final_norm"], torch.ones(256))
    assert torch.equal(params["stack/0/rec/rec/b_a"], torch.zeros(1, 256))
    lam = params["stack/0/rec/rec/lam"]
    assert float(lam.min()) >= 0.0 and float(lam.max()) < 1.0
    # normal init: std 1/sqrt(fan_in), fan_in = shape[0] as in the
    # reference (the stack axis for stacked weights), or a given scale
    assert abs(float(params["embed/tokens"].std()) - 256 ** -0.5) < 0.003
    assert abs(float(params["stack/0/rec/mlp/w_in"].std()) - 1.0) < 0.02
    rem = Model(get_config(ARCH).reduced(n_layers=5)).init(device="cpu")
    assert abs(float(rem["rem/0/rec/mlp/w_in"].std()) - 256 ** -0.5) < 0.002


# ---------------------------------------------------------------- convert
def test_convert_round_trips_every_key(model_case):
    cfg, _, _, jp, tp, _ = model_case
    back = convert.model_params_to_numpy(tp)
    assert sorted(back) == sorted(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_convert_bfloat16_and_checks():
    jcfg = jget_config(ARCH).reduced(param_dtype="bfloat16")
    cfg = get_config(ARCH).reduced(param_dtype="bfloat16")
    jp = {k: np.asarray(v) for k, v in
          JModel(jcfg).init(jax.random.PRNGKey(1)).items()}
    tp = convert.model_params_to_torch(jp, cfg, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    back = convert.model_params_to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32))
    with pytest.raises(KeyError, match="missing"):
        convert.model_params_to_torch(
            {k: v for k, v in jp.items() if k != "final_norm"}, cfg, "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        convert.model_params_to_torch(dict(jp, extra=jp["final_norm"]), cfg,
                                      "cpu")
    bad = dict(jp, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_to_torch(bad, cfg, "cpu")


# ---------------------------------------------------------------- configs
def test_config_registry():
    """The port's registry is the reference's, config for config (and
    each ``reduced()`` too)."""
    from repro_torch import configs
    from repro.configs import REGISTRY as JREG
    from repro.configs import get_config as jget
    assert sorted(configs.REGISTRY) == sorted(JREG)
    for name, jcfg in JREG.items():
        mine = configs.get_config(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(
            jget(name).reduced()), name
        assert Model(mine).num_params() == JModel(jcfg).num_params(), name
    cfg = configs.get_config(ARCH)
    assert cfg.torch_dtype == torch.bfloat16
    assert cfg.reduced().torch_dtype == torch.float32
    assert dataclasses.asdict(cfg.reduced(n_layers=5)) == dataclasses.asdict(
        JREG[ARCH].reduced(n_layers=5))
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    shape = configs.INPUT_SHAPES["prefill_32k"]
    assert configs.variant_for_shape(cfg, shape).microbatch == 0
    assert configs.supports_shape(cfg, configs.INPUT_SHAPES["long_500k"])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_concrete_batch(kind):
    cfg = get_config(ARCH).reduced()
    b = concrete_batch(cfg, 3, 10, torch.Generator().manual_seed(0),
                       kind=kind, device="cpu")
    again = concrete_batch(cfg, 3, 10, torch.Generator().manual_seed(0),
                           kind=kind, device="cpu")
    s = 1 if kind == "decode" else 10
    assert b["tokens"].shape == (3, s) and b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert ("labels" in b) == (kind == "train")
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_unported_paths_raise():
    """What the port refuses: an unknown block kind, the score softcap on
    the kernel route (the attention kernel has none), per-slot decode
    positions that are not one a row (a (B,) ``cur_len`` is the serving
    scheduler's path, tests/test_torch_serving.py), an unknown impl, and
    a param whose axes do not match its shape."""
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="block kind"):
        Model(dataclasses.replace(cfg, block_pattern=("ssm",))).init(
            device="cpu")
    with pytest.raises(ValueError, match="softcap"):
        attn.self_attention({}, torch.zeros(1, 2, 256),
                            dataclasses.replace(cfg, logit_softcap=30.0),
                            positions=torch.zeros(1, 2, dtype=torch.int32))
    p = Model(cfg).init(device="cpu")
    cache = Model(cfg).init_cache(2, 4, device="cpu")
    with pytest.raises(ValueError, match="per-row cur_len"):
        Model(cfg).decode_step(p, {"tokens": torch.zeros(
            (2, 1), dtype=torch.int32)}, cache, torch.tensor([1]))
    with pytest.raises(ValueError, match="impl"):
        Model(cfg, impl="triton")
    with pytest.raises(ValueError):
        pp.Initializer(torch.float32).make("x", (2, 3), ("a",))
