"""The port's continuous-batching serving (``repro_torch.serving``: the
per-slot decode path, ``ContinuousBatcher``, ``sample``) on the CPU,
alone and against the JAX reference.

Sizes: each token-input arch's ``reduced()`` config (fp32; qwen1.5-4b at
2 layers, recurrentgemma-2b at 4 so that a ``rem/`` entry exists), 2-4
slots, prompts of 3-40 tokens. Tolerances, each relative to the scale
(max abs) of the reference's value:

- the attention layer with a (B,) ``cur_len``: output and cache 1e-5,
  against the reference's layer and against B one-row int calls;
- the batcher against the reference's ``ContinuousBatcher`` on the same
  params (``convert.model_params_to_torch``), prompts and slots:
  generated tokens and ``steps_run`` equal, every final cache entry
  1e-5 (at ``conditioned`` weights: stacked matrices at std
  1/sqrt(d_in), as tests/test_torch_train.py's ``well_conditioned``).
  The reference's batcher is run with its claimed slots' recurrent
  entries zeroed, as the port's batcher does (the reference resets only
  the slot's position; ``test_the_reference_batcher_carries_state_into_
  a_reused_slot`` shows what that does);
- idle slots' cache entries after a step: bit for bit;
- ``sample``: greedy equal to the reference's; the support of 4096 draws
  equal to the reference's over 4096 keys where every kept token has
  probability >= 1%; the draws' frequencies within the chi-square
  quantile at 1 - 1e-6 of the filtered softmax.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving import scheduler as sched  # noqa: E402
from repro_torch.serving.sampling import sample  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the harness's per-step logits (one copy, in chip_smoke.py)
_SMOKE = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

# the token-input archs at their reduced() size (overrides beside)
TOKEN_ARCHS = (("qwen1.5-4b", {"n_layers": 2}),
               ("recurrentgemma-2b", {"n_layers": 4}),
               ("rwkv6-7b", {}),
               ("gemma3-27b", {}),
               ("llama4-scout-17b-a16e", {}),
               ("arctic-480b", {}))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models are tiny (hundreds of small ops a
    step), and several test processes each running a pool of threads over
    the same cores makes every op wait for the others' threads."""
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


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-4b").reduced(n_layers=2)
    model = Model(cfg)
    return cfg, model, model.init(0, device="cpu")


def greedy_reference(model, params, prompt, n_new, max_len=64):
    """Sequential single-sequence greedy decode through the int-position
    decode path (the oracle the batcher must match)."""
    cache = model.init_cache(1, max_len, device="cpu")
    for t, p in enumerate(prompt):
        logits, cache = model.decode_step(
            params, {"tokens": torch.tensor([[int(p)]])}, cache, t)
    out = [int(torch.argmax(logits[0]))]
    t = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(
            params, {"tokens": torch.tensor([[out[-1]]])}, cache, t)
        out.append(int(torch.argmax(logits[0])))
        t += 1
    return out


# ------------------------------------- tests/test_serving.py on the port
def test_batcher_matches_sequential(qwen):
    cfg, model, params = qwen
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 3, 7)]
    n_new = 6
    batcher = ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                device="cpu")
    for uid, p in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new))
    batcher.run_until_drained()
    assert set(batcher.completed) == {0, 1, 2}
    for uid, p in enumerate(prompts):
        expect = greedy_reference(model, params, p, n_new)
        got = batcher.completed[uid].generated[:n_new]
        assert got == expect, (uid, got, expect)


def test_slot_reuse_overlapping_lifetimes(qwen):
    """3 requests through 2 slots: the freed slot must be reclaimed
    before the other finishes (continuous batching, not drain-batching).
    """
    cfg, model, params = qwen
    rng = np.random.default_rng(1)
    reqs = [Request(uid=0, prompt=rng.integers(0, 64, 3).astype(np.int32),
                    max_new_tokens=2),
            Request(uid=1, prompt=rng.integers(0, 64, 3).astype(np.int32),
                    max_new_tokens=12),
            Request(uid=2, prompt=rng.integers(0, 64, 3).astype(np.int32),
                    max_new_tokens=5)]
    b = ContinuousBatcher(model, params, n_slots=2, max_len=64, device="cpu")
    for r in reqs:
        b.submit(r)
    overlapped = False
    for _ in range(100):
        b.step()
        in_flight = {r.uid for r in b.slots if r is not None}
        if 2 in in_flight and 1 in in_flight:
            overlapped = True
        if not b.queue and all(s is None for s in b.slots):
            break
    assert overlapped
    assert set(b.completed) == {0, 1, 2}
    assert len(b.completed[1].generated) == 12


def test_eos_terminates_early(qwen):
    cfg, model, params = qwen
    rng = np.random.default_rng(2)
    p = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    first = greedy_reference(model, params, p, 1)[0]
    b = ContinuousBatcher(model, params, n_slots=1, max_len=64, device="cpu")
    b.submit(Request(uid=0, prompt=p, max_new_tokens=50, eos_id=first))
    b.run_until_drained()
    gen = b.completed[0].generated
    assert gen[gen.index(first):][0] == first
    assert len(gen) < 50


def test_sampling_strategies():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]] * 3)
    g = torch.Generator().manual_seed(0)
    assert sample(logits, g).tolist() == [1, 1, 1]
    toks = sample(logits.repeat(100, 1), g, temperature=1.0, top_k=2)
    assert set(toks.tolist()) <= {1, 2}
    toks = sample(logits.repeat(50, 1), g, temperature=1.0, top_p=0.1)
    assert set(toks.tolist()) == {1}


# -------------------------------------------- the per-slot decode layer
def layer_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h, dh), "wk": (d, k, dh), "wv": (d, k, dh),
              "wo": (h, dh, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h, dh), bk=(k, dh), bv=(k, dh))
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("arch,kind", [("qwen1.5-4b", "attn"),
                                       ("gemma3-27b", "local")])
def test_per_slot_self_attention_matches_the_reference(arch, kind):
    """A (B,) cur_len: each row's k/v at its own index, RoPE at its own
    position, the mask (and gemma3's window of 64) its own; against the
    reference's layer and against B one-row int-cur_len calls."""
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    window = cfg.window if kind == "local" else 0
    b, max_len = 4, 96
    rng = np.random.default_rng(3)
    p = layer_params(cfg, 4)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, max_len, cfg.n_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    cur = np.array([3, 70, 64, 0], np.int32)

    want, wcache = jattn.self_attention(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x), jcfg,
        positions=jnp.asarray(cur[:, None]), window=window,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cur_len=jnp.asarray(cur))
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    tcur = torch.from_numpy(cur)
    got, gcache = attn.self_attention(
        tp, torch.from_numpy(x), cfg, positions=tcur[:, None].int(),
        window=window, cache=cache, cur_len=tcur, impl="xla")
    assert rel(got, want) <= 1e-5
    for key in ("k", "v"):
        assert rel(gcache[key], wcache[key]) <= 1e-5

    for r in range(b):
        row_cache = {"k": torch.from_numpy(ck[r:r + 1].copy()),
                     "v": torch.from_numpy(cv[r:r + 1].copy())}
        one, one_cache = attn.self_attention(
            tp, torch.from_numpy(x[r:r + 1]), cfg,
            positions=torch.tensor([[int(cur[r])]], dtype=torch.int32),
            window=window, cache=row_cache, cur_len=int(cur[r]), impl="xla")
        assert rel(got[r], one[0]) <= 1e-5
        for key in ("k", "v"):
            assert rel(gcache[key][r], one_cache[key][0]) <= 1e-5


def test_decode_refuses_a_per_slot_cur_len_of_the_wrong_shape(qwen):
    cfg, model, params = qwen
    cache = model.init_cache(2, 16, device="cpu")
    with pytest.raises(ValueError, match="per-row cur_len"):
        model.decode_step(params, {"tokens": torch.zeros((2, 1),
                                                         dtype=torch.int64)},
                          cache, torch.zeros(3, dtype=torch.int32))


# ----------------------------------------------------- idle slots frozen
@pytest.mark.parametrize("arch,over", [("qwen1.5-4b", {"n_layers": 2}),
                                       ("gemma3-27b", {}),
                                       ("recurrentgemma-2b", {"n_layers": 4}),
                                       ("rwkv6-7b", {})])
def test_a_step_leaves_idle_slots_bit_for_bit(arch, over):
    """One slot active, three idle at their own positions, every cache
    entry (k/v of attn and local, conv/h, shift_tm/shift_cm/wkv; stack/
    and rem/) filled with random values: after the step each idle slot's
    rows are the same bits, the active slot's have moved. Without the
    snapshot (the control) the idle rows of the recurrent entries move."""
    cfg = get_config(arch).reduced(**over)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(5)

    def filled():
        cache = model.init_cache(4, 32, device="cpu")
        for v in cache.values():
            v.copy_(torch.randn(v.shape, generator=g).to(v.dtype))
        return cache

    cur = torch.tensor([3, 10, 0, 20], dtype=torch.int32)
    tokens = torch.tensor([[1], [2], [3], [4]], dtype=torch.int32)
    active = np.array([False, True, False, False])
    step = sched.make_slot_step(model)
    kinds = set()
    for freeze in (True, False):
        cache = filled()
        before = {k: v.clone() for k, v in cache.items()}
        if freeze:
            _, _, new_cur, cache = step(params, cache, tokens, cur, active)
            assert new_cur.tolist() == [3, 11, 0, 20]
        else:
            orig = sched.snapshot_idle
            sched.snapshot_idle = lambda *a: []
            try:
                step(params, cache, tokens, cur, active)
            finally:
                sched.snapshot_idle = orig
        for key, v in cache.items():
            new = sched._slot_major(key, v)
            old = sched._slot_major(key, before[key])
            kind = key.rsplit("/", 1)[-1]
            kinds.add((key.split("/")[0], kind))
            if freeze:
                for i in (0, 2, 3):
                    assert torch.equal(new[i], old[i]), (key, i)
                assert not torch.equal(new[1], old[1]), key
            elif kind in sched.RECURRENT_KEYS:
                assert not torch.equal(new[0], old[0]), key
    want = {"qwen1.5-4b": {"k", "v"}, "gemma3-27b": {"k", "v"},
            "recurrentgemma-2b": {"k", "v", "conv", "h"},
            "rwkv6-7b": {"shift_tm", "shift_cm", "wkv"}}[arch]
    assert {k for _, k in kinds} == want
    if arch == "recurrentgemma-2b":
        assert ("rem", "conv") in kinds and ("stack", "k") in kinds


# ------------------------------------------ the batcher vs the reference
class _ResettingSlots(list):
    """The reference batcher's slot list, zeroing a claimed slot's
    recurrent entries as the port's batcher does."""

    def __init__(self, owner, n):
        super().__init__([None] * n)
        self.owner = owner

    def __setitem__(self, i, req):
        super().__setitem__(i, req)
        if req is None:
            return
        cache = self.owner.cache
        for key, v in cache.items():
            if key.rsplit("/", 1)[-1] in sched.RECURRENT_KEYS:
                at = (slice(None), i) if key.startswith("stack/") else i
                cache[key] = v.at[at].set(0)


def reference_batcher(jmodel, jparams, n_slots, max_len, reset=True):
    b = jsched.ContinuousBatcher(jmodel, jparams, n_slots=n_slots,
                                 max_len=max_len)
    if reset:
        b.slots = _ResettingSlots(b, n_slots)
    return b


def conditioned(params):
    """Stacked matrices rescaled from the reference init's std
    1/sqrt(n_cycles) to the unstacked layer's 1/sqrt(d_in): at the
    reference init deep stacks amplify fp32 rounding (the final caches of
    the two batchers differ by up to ~6e-4 of their scale there, with
    equal tokens)."""
    return {k: (v * np.sqrt(v.shape[0] / v.shape[1]) if
                k.startswith("stack/") and v.ndim >= 3 else v
                ).astype(np.float32) for k, v in params.items()}


def both_models(arch, over, condition=False):
    """The reference's model and init (optionally ``conditioned``), and
    the port's model on the same arrays."""
    jcfg = jget_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jmodel = JModel(jcfg)
    arrays = {k: np.asarray(v) for k, v in
              jmodel.init(jax.random.PRNGKey(0)).items()}
    if condition:
        arrays = conditioned(arrays)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    params = convert.model_params_to_torch(arrays, cfg, device="cpu")
    return jmodel, jparams, Model(cfg), params


def drive(batcher, prompts, budgets, request=None):
    request = request or Request
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        batcher.submit(request(uid=uid, prompt=p, max_new_tokens=n))
    batcher.run_until_drained()
    return {uid: r.generated for uid, r in batcher.completed.items()}


@pytest.mark.parametrize("arch,over", TOKEN_ARCHS,
                         ids=[a for a, _ in TOKEN_ARCHS])
def test_batcher_matches_the_reference_batcher(arch, over):
    """4 requests through 2 slots, max_len 96; one of 40 prompt tokens and
    a budget of 30 runs past the reduced window of 64 (gemma3,
    recurrentgemma). At ``conditioned`` weights."""
    jmodel, jparams, model, params = both_models(arch, over, condition=True)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in (5, 3, 40, 7)]
    budgets = (6, 6, 30, 6)
    ref = reference_batcher(jmodel, jparams, 2, 96)
    want = drive(ref, prompts, budgets, jsched.Request)
    port = ContinuousBatcher(model, params, n_slots=2, max_len=96,
                             device="cpu")
    got = drive(port, prompts, budgets)
    assert got == want
    assert port.steps_run == ref.steps_run
    assert len(got[2]) == 30
    assert sorted(port.cache) == sorted(ref.cache)
    for key in port.cache:
        assert rel(port.cache[key], np.asarray(ref.cache[key])) <= 1e-5, key


@pytest.mark.parametrize("arch,over", TOKEN_ARCHS[:2],
                         ids=[a for a, _ in TOKEN_ARCHS[:2]])
def test_a_slot_freed_at_the_caches_end_keeps_the_batcher_serving(arch,
                                                                   over):
    """A prompt of max_len - 1 tokens ends its request at the cache's end
    (cur = max_len) while the other slot still decodes: the next ticks
    run with that slot idle, and the batcher gives the reference's tokens,
    steps and (at ``conditioned`` weights) caches within 1e-5."""
    jmodel, jparams, model, params = both_models(arch, over, condition=True)
    max_len = 16
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).astype(np.int32)
               for n in (max_len - 1, 3)]
    budgets = (4, 10)
    ref = reference_batcher(jmodel, jparams, 2, max_len)
    want = drive(ref, prompts, budgets, jsched.Request)
    port = ContinuousBatcher(model, params, n_slots=2, max_len=max_len,
                             device="cpu")
    got = drive(port, prompts, budgets)
    assert got == want
    assert [len(got[0]), len(got[1])] == [2, 10]
    assert port.steps_run == ref.steps_run
    for key in port.cache:
        assert rel(port.cache[key], np.asarray(ref.cache[key])) <= 1e-5, key


def test_the_reference_batcher_carries_state_into_a_reused_slot():
    """The reference resets only a claimed slot's position, so a request
    that reuses a slot of a recurrent arch starts from the previous
    request's state and its tokens differ from its solo run's; the port's
    batcher zeroes the slot and gives the solo tokens."""
    arch, over = "recurrentgemma-2b", {"n_layers": 4}
    jmodel, jparams, model, params = both_models(arch, over)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 3, 7)]
    budgets = (6, 6, 6)
    ref = drive(reference_batcher(jmodel, jparams, 2, 64, reset=False),
                prompts, budgets, jsched.Request)
    ref_solo = drive(reference_batcher(jmodel, jparams, 2, 64, reset=False),
                     prompts[2:], budgets[2:], jsched.Request)[0]
    assert ref[2] != ref_solo
    port = drive(ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                   device="cpu"), prompts, budgets)
    assert port[2] == ref_solo
    assert port[0] == ref[0] and port[1] == ref[1]


def test_the_batcher_keeps_each_steps_logits(qwen):
    """The batcher's step logits, as ``chip_smoke.keep_logits`` collects
    them for each request: those of its prompt steps and its decode
    steps, len(prompt) + len(generated) - 1 rows, each equal to the
    int-position decode of the same tokens (at ``conditioned``
    weights)."""
    cfg, model, params = qwen
    params = {k: torch.from_numpy(v) for k, v in conditioned(
        {k: v.numpy() for k, v in params.items()}).items()}
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 6, 2)]
    b = ContinuousBatcher(model, params, n_slots=2, max_len=32, device="cpu")
    kept = chip_smoke.keep_logits(b)
    drive(b, prompts, (3, 5, 4))
    for uid, p in enumerate(prompts):
        seq = list(p) + b.completed[uid].generated[:-1]
        assert len(kept[uid]) == len(seq)
        cache = model.init_cache(1, 32, device="cpu")
        for t, tok in enumerate(seq):
            logits, cache = model.decode_step(
                params, {"tokens": torch.tensor([[int(tok)]])}, cache, t)
            assert rel(kept[uid][t], logits[0]) <= 1e-5


def test_the_batcher_refuses_embedding_inputs_other_devices_and_bad_prompts(
        qwen):
    for arch in ("musicgen-large", "qwen2-vl-72b"):
        cfg = get_config(arch).reduced()
        m = Model(cfg)
        with pytest.raises(ValueError, match="token prompts"):
            ContinuousBatcher(m, m.init(0, device="cpu"), device="cpu")
    cfg, model, params = qwen
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="is on meta"):
        ContinuousBatcher(model, meta, device="cpu")
    b = ContinuousBatcher(model, params, n_slots=1, max_len=8, device="cpu")
    for n in (0, 8):
        with pytest.raises(ValueError, match="prompt of"):
            b.submit(Request(uid=0, prompt=np.zeros(n, np.int32)))
    b.submit(Request(uid=1, prompt=np.arange(7, dtype=np.int32),
                     max_new_tokens=5))
    b.run_until_drained()
    assert len(b.completed[1].generated) == 2       # cur reached max_len - 1
    with pytest.raises(RuntimeError, match="drain"):
        b.submit(Request(uid=2, prompt=np.arange(3, dtype=np.int32),
                         max_new_tokens=20))
        b.run_until_drained(max_ticks=2)


# ---------------------------------------------------------------- sample
def test_greedy_sample_equals_the_reference():
    logits = np.random.default_rng(7).standard_normal((16, 300)).astype(
        np.float32)
    want = np.asarray(jsampling.sample(jnp.asarray(logits),
                                       jax.random.PRNGKey(0)))
    got = sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


def test_top_k_keeps_ties_with_the_kth_value():
    logits = torch.tensor([[0.0, 5.0, 3.0, 3.0, 1.0]]).repeat(4096, 1)
    toks = sample(logits, torch.Generator().manual_seed(1), temperature=1.0,
                  top_k=2)
    assert set(toks.tolist()) == {1, 2, 3}
    want = jsampling.sample(jnp.asarray(logits.numpy()),
                            jax.random.PRNGKey(1), temperature=1.0, top_k=2)
    assert set(np.asarray(want).tolist()) == {1, 2, 3}


PROBS = np.array([0.3, 0.25, 0.2, 0.1, 0.08, 0.04, 0.02, 0.006, 0.004])


def filtered_probs(logits, temperature, top_k, top_p):
    """The reference's filter in numpy (float64), then the softmax."""
    z = logits.astype(np.float64) / temperature
    if top_k:
        z = np.where(z < np.sort(z)[-top_k], -np.inf, z)
    if top_p:
        s = np.sort(z)[::-1]
        e = np.exp(s - s.max())
        cum = np.cumsum(e / e.sum())
        z = np.where(z < s[np.sum(cum < top_p)], -np.inf, z)
    e = np.exp(z - z.max())
    return e / e.sum()


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 6, 0.0),
                                                     (1.0, 0, 0.9),
                                                     (0.7, 4, 0.8)])
def test_sample_support_and_frequencies(temperature, top_k, top_p):
    """Logits where every kept token has probability >= 1%: the support
    of 4096 draws equals the reference's over 4096 keys and the filtered
    softmax's; the frequencies pass a chi-square test at 1 - 1e-6."""
    from scipy import stats
    logits = np.log(PROBS).astype(np.float32)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    p = filtered_probs(logits, temperature, top_k, top_p)
    kept = set(np.flatnonzero(p > 0).tolist())
    assert p[p > 0].min() >= 0.01
    n = 4096
    rows = np.tile(logits, (n, 1))
    got = sample(torch.from_numpy(rows), torch.Generator().manual_seed(2),
                 **kw).numpy()
    want = np.asarray(jsampling.sample(jnp.asarray(rows),
                                       jax.random.PRNGKey(2), **kw))
    assert set(got.tolist()) == set(want.tolist()) == kept
    idx = sorted(kept)
    counts = np.bincount(got, minlength=len(PROBS))[idx]
    expect = n * p[idx]
    chi2 = float(np.sum((counts - expect) ** 2 / expect))
    assert chi2 <= stats.chi2.ppf(1 - 1e-6, len(idx) - 1), chi2


# -------------------------------------------------------------- examples
def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_continuous_batching_example_runs_on_the_cpu(capsys):
    load_example("torch_continuous_batching").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 5 requests through 2 slots" in out
    assert out.count("req ") == 5


def test_serve_decode_example_runs_on_the_cpu(capsys):
    gen = load_example("torch_serve_decode").main(["--device", "cpu"])
    assert tuple(gen.shape) == (2, 12)
    assert "arch=gemma3-27b-smoke" in capsys.readouterr().out
