"""The seven architectures that run through the ``moe`` kind, M-RoPE,
cross-attention and embedding inputs (arctic-480b, command-r-35b,
gemma3-27b, llama3-405b, llama4-scout-17b-a16e, musicgen-large,
qwen2-vl-72b) against the JAX reference on the CPU, each at its
``reduced()`` config (fp32, d_model 256, 4 heads of 64, 2-6 layers), and
the layers those features add.

Inputs are numpy arrays on both sides: the reference's init (key 0) is
carried to the port by ``repro_torch.convert``, and the batch is the
reference's ``concrete_batch`` (key 1, B = 2, T = 80 tokens: past
gemma3's reduced window of 64).

Tolerances, each relative to the scale (max abs) of the reference's
value:

- a layer (``apply_mrope``, self-attention under M-RoPE or the softcap,
  cross-attention, ``cross_kv``): 1e-5;
- the whole model's logits and prefill cache: 1e-3, the tolerance
  tests/test_torch_model.py holds RecurrentGemma to. Only the order of
  the sums differs, but the reference init's stack-axis fan-in puts the
  stacked weights at std 1/sqrt(n_cycles), so the activations grow
  through the layers and each layer's rounding with them: measured
  1.1e-5 to 3.8e-4 of the logits' scale over the seven (musicgen's 48
  reduced to 2 layers of cross-attention the largest);
- the loss and the aux losses, means over every token: 1e-5, tighter
  (measured at most 3.6e-7);
- the MoE routing: the same experts and the same dropped assignments in
  every layer, compared before the logits.

Decode against the forward, a train step, the microbatched loss, the
CLIs and the unstacked params' conversion are in
tests/test_torch_archs_serving.py (a second file, so that parallel
test workers share the two).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import concrete_batch as jconcrete_batch  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import embeddings as jemb  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.models.losses import total_loss as jtotal_loss  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.models.layers import embeddings as emb  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402

ARCHS = ["arctic-480b", "command-r-35b", "gemma3-27b", "llama3-405b",
         "llama4-scout-17b-a16e", "musicgen-large", "qwen2-vl-72b"]
LAYER_TOL = 1e-5
MODEL_TOL = 1e-3     # see the module docstring
LOSS_TOL = 1e-5
B, T = 2, 80


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def t(x):
    return torch.as_tensor(np.array(x))


def port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def setup(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jm, m = JModel(jcfg), Model(cfg)
    jp = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    tp = convert.model_params_to_torch(jp, cfg, device="cpu")
    batch = {k: np.asarray(v) for k, v in jconcrete_batch(
        jcfg, B, T, jax.random.PRNGKey(1), kind="train").items()}
    return arch, cfg, jcfg, jm, m, jp, tp, batch


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return setup(request.param)


def inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


# ---------------------------------------------------------------- params
def test_param_paths_shapes_and_count_match_the_reference(case):
    _, cfg, _, jm, m, _, _, _ = case
    specs, _ = jm.abstract_params()
    mine = m.abstract_params()
    assert sorted(mine) == sorted(specs)
    for k, spec in specs.items():
        assert tuple(mine[k].shape) == tuple(spec.shape), k
    assert m.num_params() == jm.num_params()
    # the port's own init: the same paths, seeded
    own = m.init(seed=0, device="cpu")
    assert sorted(own) == sorted(specs)


def test_convert_round_trips_every_key(case):
    _, _, _, _, _, jp, tp, _ = case
    back = convert.model_params_to_numpy(tp)
    assert sorted(back) == sorted(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_config(a).n_experts])
def test_moe_layers_route_as_the_reference(arch, monkeypatch):
    """Each MoE layer's input on the port's forward, routed by the port
    and by the reference's lines (moe.py:64-86): the same experts and the
    same kept assignments."""
    _, cfg, jcfg, _, m, _, tp, batch = setup(arch)
    seen = []
    orig = moe.moe_ffn

    def spy(p, x, cfg):
        seen.append((p, x.detach()))
        return orig(p, x, cfg)
    monkeypatch.setattr(moe, "moe_ffn", spy)
    m.forward_train(tp, port_batch(inputs(batch)))
    assert len(seen) == cfg.n_layers
    for p, x in seen:
        xf = x.reshape(-1, x.shape[-1])
        _, idx, _ = moe.route(p, xf, cfg)
        jxf = jnp.asarray(xf.numpy())
        logits = jnp.einsum("td,de->te", jxf, jnp.asarray(p["router"]))
        _, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        keep, _ = moe.slots(idx, moe.capacity(cfg, xf.shape[0]),
                            cfg.n_experts)
        flat = np.asarray(jidx).reshape(-1)
        oh = np.eye(cfg.n_experts, dtype=np.int64)[flat]
        pos = ((np.cumsum(oh, 0) - oh) * oh).sum(-1)
        np.testing.assert_array_equal(
            keep.numpy(), pos < jmoe.capacity(jcfg, xf.shape[0]))


def test_forward_train_logits_aux_and_loss(case):
    arch, cfg, _, jm, m, jp, tp, batch = case
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = m.forward_train(tp, port_batch(inputs(batch)))
    jlogits, jaux = jm.forward_train(jp, inputs(jb))
    assert logits.shape == (B, T, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert rel(logits, jlogits) <= MODEL_TOL
    assert sorted(aux) == sorted(jaux)
    assert bool(aux) == (cfg.n_experts > 0)
    for k in aux:
        assert rel(aux[k], jaux[k]) <= LOSS_TOL, k
    loss, metrics = m.loss_fn(tp, port_batch(batch))
    # the reference's loss_fn without a microbatch is total_loss of its
    # forward_train; taken from the forward above
    jloss, jmetrics = jtotal_loss(jlogits, jb["labels"], jaux, jm.cfg)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert rel(metrics[k], jmetrics[k]) <= LOSS_TOL, k


def test_prefill_logits_and_cache(case):
    _, cfg, _, jm, m, jp, tp, batch = case
    logits, cache = m.prefill(tp, port_batch(inputs(batch)))
    jlogits, jcache = jm.prefill(jp, {k: jnp.asarray(v) for k, v in
                                      inputs(batch).items()})
    assert logits.shape == (B, cfg.vocab_size)
    assert rel(logits, jlogits) <= MODEL_TOL
    assert sorted(cache) == sorted(jcache)
    assert any(k.endswith("/xk") for k in cache) == cfg.cross_attn
    for key in jcache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
        assert rel(cache[key], jcache[key]) <= MODEL_TOL, key


# ---------------------------------------------------------------- layers
def jitted(fn, **static):
    """The reference function jitted with ``static`` bound (an eager call
    of these layers takes seconds of op-by-op dispatch)."""
    return jax.jit(functools.partial(fn, **static))


def layer_params(init_fn, jcfg, pfx, **kw):
    ini = jpp.Initializer(jnp.float32, key=jax.random.PRNGKey(3))
    init_fn(ini, pfx, jcfg, **kw)
    jp = jpp.subtree(ini.params, pfx)
    return jp, {k: t(v) for k, v in jp.items()}


@pytest.mark.parametrize("sections,theta", [((8, 12, 12), 1e6),
                                            ((16, 8, 8), 1e4)])
def test_apply_mrope(sections, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 11)).astype(np.int32)
    got = emb.apply_mrope(t(x), t(pos), sections, theta)
    # eager: jitted, XLA's fused cos / sin of angles to 5000 rad differ
    # from the eager ones by ~2e-5
    want = jemb.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                            theta)
    assert rel(got, want) <= LAYER_TOL
    # equal streams give RoPE
    same = np.broadcast_to(pos[0], pos.shape)
    assert rel(emb.apply_mrope(t(x), t(same), sections, theta),
               emb.apply_rope(t(x), t(pos[0]), theta)) <= LAYER_TOL
    with pytest.raises(ValueError, match="sections"):
        emb.apply_mrope(t(x), t(pos), (8, 8, 8), theta)


@pytest.fixture(scope="module")
def qwen2vl():
    return (get_config("qwen2-vl-72b").reduced(),
            jget_config("qwen2-vl-72b").reduced())


def test_self_attention_mrope_prefill_and_decode(qwen2vl):
    cfg, jcfg = qwen2vl
    jp, tp = layer_params(jattn.init_attention, jcfg, "attn")
    jp = dict(jp, bq=jnp.full_like(jp["bq"], 0.1))   # nonzero qkv biases
    tp = dict(tp, bq=torch.full_like(tp["bq"], 0.1))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    mpos = rng.integers(0, 40, (3, 2, 20)).astype(np.int32)
    y, kv = attn.self_attention(tp, t(x), cfg, positions=t(pos),
                                mrope_positions=t(mpos))
    jsa = jitted(jattn.self_attention, cfg=jcfg)
    jy, _ = jsa(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                mrope_positions=jnp.asarray(mpos))
    assert rel(y, jy) <= LAYER_TOL
    ck = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    cv = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    cache = {"k": t(ck).clone(), "v": t(cv).clone()}
    dpos = np.full((2, 1), 17, np.int32)
    dm = rng.integers(0, 40, (3, 2, 1)).astype(np.int32)
    y, new = attn.self_attention(tp, t(x[:, :1]), cfg, positions=t(dpos),
                                 cache=cache, cur_len=17,
                                 mrope_positions=t(dm))
    jy, jnew = jsa(
        jp, jnp.asarray(x[:, :1]), positions=jnp.asarray(dpos),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cur_len=jnp.int32(17), mrope_positions=jnp.asarray(dm))
    assert rel(y, jy) <= LAYER_TOL
    for k in ("k", "v"):
        assert rel(new[k], jnew[k]) <= LAYER_TOL


@pytest.mark.parametrize("q_chunk,window", [(0, 0), (8, 0), (0, 6)])
def test_plain_route_softcap(q_chunk, window):
    """The score softcap c·tanh(s/c) on the plain route (impl="xla"),
    prefill (whole or chunked) and decode, against the reference; the
    kernel route refuses it."""
    over = dict(logit_softcap=2.0, q_chunk=q_chunk)
    cfg = get_config("gemma3-27b").reduced(**over)
    jcfg = jget_config("gemma3-27b").reduced(**over)
    jp, tp = layer_params(jattn.init_attention, jcfg, "attn")
    rng = np.random.default_rng(3)
    x = 3.0 * rng.standard_normal((2, 24, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    y, _ = attn.self_attention(tp, t(x), cfg, positions=t(pos),
                               window=window, impl="xla")
    jsa = jitted(jattn.self_attention, cfg=jcfg, window=window)
    jy, _ = jsa(jp, jnp.asarray(x), positions=jnp.asarray(pos))
    assert rel(y, jy) <= LAYER_TOL
    nocap = dataclasses.replace(cfg, logit_softcap=0.0)
    y0, _ = attn.self_attention(tp, t(x), nocap, positions=t(pos),
                                window=window, impl="xla")
    assert rel(y0, jy) > 1e-3                      # the cap changes it
    ck = rng.standard_normal((2, 30, 4, 64)).astype(np.float32)
    dpos = np.full((2, 1), 12, np.int32)
    cache = {"k": t(ck).clone(), "v": t(ck).clone()}
    y, _ = attn.self_attention(tp, t(x[:, :1]), cfg, positions=t(dpos),
                               window=window, cache=cache, cur_len=12,
                               impl="xla")
    jy, _ = jsa(
        jp, jnp.asarray(x[:, :1]), positions=jnp.asarray(dpos),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(ck)},
        cur_len=jnp.int32(12))
    assert rel(y, jy) <= LAYER_TOL
    with pytest.raises(ValueError, match="softcap"):
        attn.self_attention(tp, t(x), cfg, positions=t(pos), window=window)
    with pytest.raises(ValueError, match="softcap"):
        Model(cfg).forward_train(
            Model(cfg).init(device="cpu"),
            {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


@pytest.mark.parametrize("s", [1, 20])
def test_cross_attention_and_cross_kv(s):
    """musicgen's cross-attention: no qkv biases, every query sees every
    conditioning key; train/prefill through ops.attention (causal=False,
    Sk = cond_len), decode plain."""
    cfg = get_config("musicgen-large").reduced()
    jcfg = jget_config("musicgen-large").reduced()
    jp, tp = layer_params(jattn.init_attention, jcfg, "xattn", cross=True)
    assert sorted(tp) == ["wk", "wo", "wq", "wv"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, 256)).astype(np.float32)
    cond = 0.5 * rng.standard_normal((2, cfg.cond_len, 256)).astype(
        np.float32)
    xk, xv = attn.cross_kv(tp, t(cond), cfg)
    jxk, jxv = jitted(jattn.cross_kv, cfg=jcfg)(jp, jnp.asarray(cond))
    assert xk.shape == (2, cfg.cond_len, cfg.n_kv_heads, cfg.head_dim)
    assert rel(xk, jxk) <= LAYER_TOL and rel(xv, jxv) <= LAYER_TOL
    want = jitted(jattn.cross_attention, cfg=jcfg)(jp, jnp.asarray(x), jxk,
                                                   jxv)
    for decode in (False, True):
        got = attn.cross_attention(tp, t(x), xk, xv, cfg, decode=decode)
        assert rel(got, want) <= LAYER_TOL, decode
