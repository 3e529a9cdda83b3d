"""The port's classical federation (``repro_torch.core.fed``: ``local``,
``fed_step``, ``api.ClassicalSubstrate``; ``data.partition``;
``launch/fed_train.py``) and its architecture, Qwen1.5-4B, against the
JAX reference on the CPU.

Sizes: reduced Qwen1.5-4B (fp32, d_model 256, 4 heads of 64, qkv
biases), 1-2 layers, S = 16. Inputs are numpy arrays on both sides
(params through ``repro_torch.convert``).

Tolerances, each relative to the scale (max abs) of the reference's
value:

- the model: a layer's output and the prefill cache 1e-5; the whole
  model's logits and every gradient 1e-5, at weights whose stacked
  matrices are drawn at the unstacked layer's std and whose biases are
  nonzero (``conditioned``; at the reference init's stack-axis fan-in
  the softmax saturates and fp32 gradients are rounding noise, see
  tests/test_torch_train.py);
- partitions and token counts: equal, element for element;
- ``aggregate_deltas`` on injected deltas: 1e-6 for fp32 deltas under
  every defense and the server optimizers; a bf16 wire within one bf16
  ulp of the reference's result (the port weights each node's delta in
  bf16 before the sum, as the reference does, and ``torch.sum`` adds the
  bf16 products in fp32 and rounds once);
- ``node_uploads`` and a session against the reference's: SGD (an exact
  trajectory: AdamW's first step is lr * sign(g) where |g| >> eps, so an
  element whose gradient is near eps may flip on a last bit) under
  ``participation="full"`` (the port's cohorts are its own otherwise),
  1e-5 of each leaf's scale (a delta, a difference of fp32 params,
  also carries a few ulp of the params' scale: 2^-21 of it); under
  AdamW the eval losses, 1e-4.

The reference's own classical gates (tests/test_fed_classical.py, the
classical cases of tests/test_fed_api.py and tests/test_fed_schedulers.py)
run on the port with their assertions.
"""
import dataclasses
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.fed import api as japi  # noqa: E402
from repro.core.fed import fed_step as jfed_step  # noqa: E402
from repro.core.fed import server_opt as jserver_opt  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import token_batches as jtoken_batches  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import concrete_batch  # noqa: E402
from repro_torch.core.fed import (FederatedConfig, api,  # noqa: E402
                                  fed_train_round, participation,
                                  replicate_for_pods, server_opt)
from repro_torch.core.fed import fed_step  # noqa: E402
from repro_torch.core.fed.api import phases  # noqa: E402
from repro_torch.core.fed.local import local_steps  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.data import partition, token_batches  # noqa: E402
from repro_torch.launch import fed_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.optim import SGD, AdamW  # noqa: E402
from repro_torch.optim.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "qwen1.5-4b"
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TOL = 1e-5
AGG_TOL = 1e-6
LOSS_TOL = 1e-4
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: their models are tiny
    (thousands of small ops a round), and several test processes each
    running a pool of threads over the same cores makes every op wait
    for the others' threads."""
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


def conditioned(params, seed=0):
    """Stacked matrices at the unstacked layer's std 1/sqrt(d_in) and the
    zero-init qkv biases drawn at 0.1, numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, np.float32)
        if k.startswith("stack/") and v.ndim >= 3:
            v = v * np.sqrt(v.shape[0] / v.shape[1])
        if k.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def cfg_pair(n_layers=2, **over):
    return (get_config(ARCH).reduced(n_layers=n_layers, **over),
            jget_config(ARCH).reduced(n_layers=n_layers, **over))


def port_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def make_setup(interval=2, nodes=2, b=B, s=S):
    """The port's side of tests/test_fed_classical.py's setup: reduced
    Qwen1.5-4B at 2 layers, the port's init, node batches (nodes, I_l,
    b, s) from a seeded generator."""
    cfg = get_config(ARCH).reduced(n_layers=2)
    m = Model(cfg)
    params = m.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    node_batches = {}
    for i in range(nodes):
        steps = [concrete_batch(cfg, b, s, gen, device="cpu")
                 for _ in range(interval)]
        for k in steps[0]:
            node_batches.setdefault(k, []).append(
                torch.stack([x[k] for x in steps]))
    node_batches = {k: torch.stack(v) for k, v in node_batches.items()}
    return m, params, m.loss_fn, node_batches


def step_batch(node_batches, i, j):
    return {k: v[i, j] for k, v in node_batches.items()}


def grad_of(loss_fn, params, batch):
    return value_and_grad(loss_fn, params, batch)[2]


# ------------------------------------------------------------- the model
def test_qwen_config_is_the_reference():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced(n_layers=1)) == \
        dataclasses.asdict(jcfg.reduced(n_layers=1))
    assert Model(cfg).num_params() == JModel(jcfg).num_params()
    names = set(Model(cfg.reduced(n_layers=1)).abstract_params())
    assert {"stack/0/attn/attn/bq", "stack/0/attn/attn/bk",
            "stack/0/attn/attn/bv"} <= names
    assert names == set(JModel(jcfg.reduced(n_layers=1)).init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_attention_layer_with_biases_matches_reference(q_chunk):
    cfg, jcfg = cfg_pair(q_chunk=q_chunk)
    rng = np.random.default_rng(3)
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(0, d ** -0.5, (d, h, dh)),
         "wk": rng.normal(0, d ** -0.5, (d, k, dh)),
         "wv": rng.normal(0, d ** -0.5, (d, k, dh)),
         "wo": rng.normal(0, (h * dh) ** -0.5, (h, dh, d)),
         "bq": rng.normal(0, 0.3, (h, dh)), "bk": rng.normal(0, 0.3, (k, dh)),
         "bv": rng.normal(0, 0.3, (k, dh))}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, _ = jattn.self_attention({n: jnp.asarray(v) for n, v in p.items()},
                                   jnp.asarray(x), jcfg,
                                   positions=jnp.asarray(pos))
    got, kv = attn.self_attention({n: torch.as_tensor(v) for n, v in p.items()},
                                  torch.as_tensor(x), cfg,
                                  positions=torch.as_tensor(pos), impl="xla")
    assert rel(got, want) <= TOL
    # the gradient through the chunked plain route against the reference's
    xt = torch.as_tensor(x).requires_grad_()
    out, _ = attn.self_attention({n: torch.as_tensor(v) for n, v in p.items()},
                                 xt, cfg, positions=torch.as_tensor(pos),
                                 impl="xla")
    g = torch.autograd.grad(out.square().sum(), xt)[0]
    jg = jax.grad(lambda xx: jnp.sum(jattn.self_attention(
        {n: jnp.asarray(v) for n, v in p.items()}, xx, jcfg,
        positions=jnp.asarray(pos))[0] ** 2))(jnp.asarray(x))
    assert rel(g, jg) <= TOL


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_qwen_logits_gradients_and_cache_match_reference(q_chunk):
    cfg, jcfg = cfg_pair(q_chunk=q_chunk)
    params = conditioned(JModel(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S), np.int32)}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jmodel, model = JModel(jcfg), Model(cfg, impl="xla")
    tparams = convert.model_params_to_torch(params, cfg, device="cpu")
    tb = port_batch(batch)
    jlogits, _ = jmodel.forward_train(jparams, batch)
    logits, _ = model.forward_train(tparams, tb)
    assert rel(logits, jlogits) <= TOL
    jg = jax.grad(lambda p: jmodel.loss_fn(p, batch)[0])(jparams)
    loss, _, g = value_and_grad(model.loss_fn, tparams, tb)
    assert abs(float(loss) - float(jmodel.loss_fn(jparams, batch)[0])) \
        <= TOL * abs(float(loss))
    for k in jg:
        assert rel(g[k], jg[k]) <= TOL, k
    # the prefill cache carries the biased, roped k and v
    jl, jcache = jmodel.prefill(jparams, {"tokens": batch["tokens"]})
    tl, cache = model.prefill(tparams, {"tokens": tb["tokens"]})
    assert rel(tl, jl) <= TOL
    assert set(cache) == set(jcache)
    for k in jcache:
        assert rel(cache[k], jcache[k]) <= TOL, k


# ---------------------------------------------------------- partitioning
@pytest.mark.parametrize("iid", [False, True], ids=["non_iid", "iid"])
@pytest.mark.parametrize("node_seqs", [None, (1, 3, 2, 5)],
                         ids=["equal", "unequal"])
def test_partitions_and_token_counts_equal_the_reference(iid, node_seqs):
    cfg, jcfg = cfg_pair()
    jpool = next(jtoken_batches(jcfg, 12, S, seed=4))
    pool = next(token_batches(cfg, 12, S, seed=4, device="cpu"))
    for k in jpool:
        np.testing.assert_array_equal(pool[k].numpy(), np.asarray(jpool[k]))
    if iid:
        want = jpartition.partition_iid(jpool, 4, seed=7, node_seqs=node_seqs)
        got = partition.partition_iid(pool, 4, seed=7, node_seqs=node_seqs)
    else:
        want = jpartition.partition_non_iid(jpool, 4, node_seqs=node_seqs)
        got = partition.partition_non_iid(pool, 4, node_seqs=node_seqs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        partition.node_token_counts(got).numpy(),
        np.asarray(jpartition.node_token_counts(want)))


def test_partition_carries_mrope_positions():
    pos = torch.arange(S, dtype=torch.int32)[None].expand(6, S)
    batch = {"labels": torch.arange(6 * S, dtype=torch.int32).reshape(6, S),
             "mrope_positions": torch.stack([pos, pos + 1, pos + 2])}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    got = partition.partition_non_iid(batch, 3, node_seqs=(1, 2, 3))
    want = jpartition.partition_non_iid(jbatch, 3, node_seqs=(1, 2, 3))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ----------------------------------- tests/test_fed_classical.py, ported
def test_interval1_equals_sync_dataparallel():
    m, params, loss_fn, node_batches = make_setup(interval=1, nodes=2)
    opt = SGD()
    fed_cfg = FederatedConfig(num_nodes=2, interval_length=1)
    opt_nodes = replicate_for_pods(opt.init(params), 2)
    new_p, _, _ = fed_train_round(loss_fn, opt, params, opt_nodes,
                                  node_batches, 0.1, fed_cfg)
    g0 = grad_of(loss_fn, params, step_batch(node_batches, 0, 0))
    g1 = grad_of(loss_fn, params, step_batch(node_batches, 1, 0))
    for k in params:
        ref = params[k] - 0.1 * 0.5 * (g0[k] + g1[k])
        torch.testing.assert_close(new_p[k], ref, atol=2e-5, rtol=0)


def test_interval_trades_sync_for_local_work():
    m, params, loss_fn, node_batches = make_setup(interval=4, nodes=2)
    opt = SGD()
    eval_batch = step_batch(node_batches, 0, 0)
    with torch.no_grad():
        l0 = float(loss_fn(params, eval_batch)[0])
    fed_cfg4 = FederatedConfig(num_nodes=2, interval_length=4)
    p4, _, _ = fed_train_round(loss_fn, opt, params,
                               replicate_for_pods(opt.init(params), 2),
                               node_batches, 0.05, fed_cfg4)
    fed_cfg1 = FederatedConfig(num_nodes=2, interval_length=1)
    p1 = params
    opt_nodes = replicate_for_pods(opt.init(params), 2)
    for j in range(4):
        b = {k: v[:, j:j + 1] for k, v in node_batches.items()}
        p1, opt_nodes, _ = fed_train_round(loss_fn, opt, p1, opt_nodes, b,
                                           0.05, fed_cfg1)
    with torch.no_grad():
        l4 = float(loss_fn(p4, eval_batch)[0])
        l1 = float(loss_fn(p1, eval_batch)[0])
    assert l4 < l0 - 0.1 and l1 < l0 - 0.1
    assert abs(l4 - l1) < 0.2, (l4, l1)


@pytest.mark.parametrize("how", ["token_counts", "dropout_mask"])
def test_zero_weight_node_contributes_nothing(how):
    """test_weighted_aggregation and
    test_dropout_participation_mask_drops_node: a zero-weighted or masked
    node contributes nothing, the survivor's weight renormalizes to 1."""
    m, params, loss_fn, node_batches = make_setup(interval=1, nodes=2)
    opt = SGD()
    if how == "token_counts":
        fed_cfg = FederatedConfig(num_nodes=2, interval_length=1)
        kw = dict(token_counts=torch.tensor([4.0, 0.0]))
    else:
        fed_cfg = FederatedConfig(num_nodes=2, interval_length=1,
                                  participation="dropout", dropout_rate=0.5)
        kw = dict(participation_mask=torch.tensor([1.0, 0.0]))
    new_p, _, _ = fed_train_round(loss_fn, opt, params,
                                  replicate_for_pods(opt.init(params), 2),
                                  node_batches, 0.1, fed_cfg, **kw)
    g0 = grad_of(loss_fn, params, step_batch(node_batches, 0, 0))
    for k in params:
        torch.testing.assert_close(new_p[k], params[k] - 0.1 * g0[k],
                                   atol=2e-5, rtol=0)


def test_fed_training_learns_with_adamw():
    m, params, loss_fn, node_batches = make_setup(interval=2, nodes=2)
    opt = AdamW(weight_decay=0.0)
    fed_cfg = FederatedConfig(num_nodes=2, interval_length=2)
    opt_nodes = replicate_for_pods(opt.init(params), 2)
    eval_batch = step_batch(node_batches, 0, 0)
    with torch.no_grad():
        l0 = float(loss_fn(params, eval_batch)[0])
    p = params
    for _ in range(5):
        p, opt_nodes, _ = fed_train_round(loss_fn, opt, p, opt_nodes,
                                          node_batches, 3e-3, fed_cfg)
    with torch.no_grad():
        assert float(loss_fn(p, eval_batch)[0]) < l0
    assert opt_nodes.step.tolist() == [10, 10]


def test_classical_schedules_end_to_end():
    m, params, loss_fn, node_batches = make_setup(interval=2, nodes=2)
    opt = SGD()
    sizes = torch.tensor([10.0, 30.0])
    p = params
    for seed, schedule in ((0, "dropout"), (1, "weighted")):
        fed_cfg = FederatedConfig(num_nodes=2, interval_length=2,
                                  participation=schedule, dropout_rate=0.5)
        sel, mask = participation.sample_nodes(
            torch.Generator().manual_seed(seed), 2, 2, device="cpu",
            schedule=schedule, node_sizes=sizes,
            dropout_rate=fed_cfg.dropout_rate)
        batches = {k: v[sel] for k, v in node_batches.items()}
        p, _, metrics = fed_train_round(
            loss_fn, opt, p, replicate_for_pods(opt.init(p), 2), batches,
            0.05, fed_cfg, token_counts=sizes[sel], participation_mask=mask)
        assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(v).all()) for v in p.values())


def test_classical_rejects_product_aggregation():
    m, params, loss_fn, node_batches = make_setup(interval=1, nodes=2)
    opt = SGD()
    fed_cfg = FederatedConfig(num_nodes=2, interval_length=1,
                              aggregation="product")
    with pytest.raises(ValueError, match="quantum-only"):
        fed_train_round(loss_fn, opt, params,
                        replicate_for_pods(opt.init(params), 2),
                        node_batches, 0.1, fed_cfg)


def test_classical_served_wire_dtype():
    m, params, loss_fn, node_batches = make_setup(interval=1, nodes=2)
    opt = SGD()
    outs = {}
    for agg in ("average", "served"):
        fed_cfg = FederatedConfig(num_nodes=2, interval_length=1,
                                  aggregation=agg)
        outs[agg], _, _ = fed_train_round(
            loss_fn, opt, params, replicate_for_pods(opt.init(params), 2),
            node_batches, 0.1, fed_cfg)
    assert fed_step.resolve_delta_dtype(
        FederatedConfig(aggregation="served")) == torch.bfloat16
    for k in params:
        torch.testing.assert_close(outs["average"][k], outs["served"][k],
                                   atol=5e-3, rtol=0)


def test_local_steps_loop():
    m, params, loss_fn, node_batches = make_setup(interval=3, nodes=1)
    opt = SGD()
    batches = {k: v[0] for k, v in node_batches.items()}
    pf, sf, metrics = local_steps(loss_fn, opt, params, opt.init(params),
                                  batches, 0.05)
    assert metrics["loss"].shape == (3,)
    assert int(sf.step) == 3
    assert float(metrics["loss"][-1]) < float(metrics["loss"][0]) + 0.5


# ------------------------------------------- the round against the reference
def reference_round_inputs(n_layers=1, nodes=2, interval=2, seed=0):
    """Reference-init params (conditioned), and node batches (nodes, I_l,
    B, S) from the reference's token stream, numpy."""
    cfg, jcfg = cfg_pair(n_layers=n_layers)
    params = conditioned(JModel(jcfg).init(jax.random.PRNGKey(seed)))
    pool = next(jtoken_batches(jcfg, nodes * interval * B, S, seed=seed))
    batches = {k: np.asarray(v).reshape(nodes, interval, B, S)
               for k, v in pool.items()}
    return cfg, jcfg, params, batches


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_node_uploads_match_reference_and_leave_params_intact(wire):
    cfg, jcfg, params, batches = reference_round_inputs()
    jmodel, model = JModel(jcfg), Model(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = JSGD()
    jst = jax.vmap(lambda _: jopt.init(jparams))(jnp.arange(2))
    jd, _, jm = jfed_step.node_uploads(
        lambda p, b: jmodel.loss_fn(p, b), jopt, jparams, jst,
        {k: jnp.asarray(v) for k, v in batches.items()}, 0.1,
        jnp.dtype(wire))
    tparams = convert.model_params_to_torch(params, cfg, device="cpu")
    before = {k: v.clone() for k, v in tparams.items()}
    opt = SGD()
    d, st, m = fed_step.node_uploads(
        model.loss_fn, opt, tparams, replicate_for_pods(opt.init(tparams), 2),
        port_batch(batches), 0.1, getattr(torch, wire))
    assert st.step.tolist() == [2, 2]
    assert m["loss"].shape == (2, 2)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=TOL)
    for k in jd:
        # a delta is a difference of fp32 params: beside TOL of its own
        # scale it carries a few ulp of the params' scale (~1 here, the
        # delta ~1e-3); the bf16 wire rounds it once more (2^-8)
        want = np.asarray(jd[k], np.float32)
        assert d[k].dtype == getattr(torch, wire)
        bound = ((TOL if wire == "float32" else 2.0 ** -8 + TOL)
                 * np.abs(want).max() + 2.0 ** -21 * np.abs(params[k]).max())
        assert np.abs(d[k].float().numpy() - want).max() <= bound, k
    for k in tparams:
        assert torch.equal(tparams[k], before[k]), k


def test_a_node_never_writes_the_global_params():
    """Two nodes with the same batches must upload the same delta, bit
    for bit, and the global params must be unchanged after the round: a
    node stepping the global params in place (the port's optimizers
    update in place) would start the second node elsewhere."""
    cfg, _, params, batches = reference_round_inputs()
    batches = {k: np.repeat(v[:1], 2, axis=0) for k, v in batches.items()}
    tparams = convert.model_params_to_torch(params, cfg, device="cpu")
    before = {k: v.clone() for k, v in tparams.items()}
    for opt in (SGD(), AdamW(weight_decay=0.1)):
        d, st, _ = fed_step.node_uploads(
            Model(cfg).loss_fn, opt, tparams,
            replicate_for_pods(opt.init(tparams), 2), port_batch(batches),
            1e-2, torch.float32)
        for k in d:
            assert torch.equal(d[k][0], d[k][1]), k
            assert float(d[k].abs().max()) > 0, k
        for a, b in zip(tree_leaves(st), tree_leaves(st)):
            assert torch.equal(a[0], b[1])
        for k in tparams:
            assert torch.equal(tparams[k], before[k]), k


def injected_deltas(dtype, poison=False):
    rng = np.random.default_rng(5)
    d = {"w": rng.normal(0, 1, (5, 3, 4)), "b": rng.normal(0, 1, (5, 4))}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    if poison:
        d["w"][3] = -50.0
        d["b"][4, 1] = np.nan
    p = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
         "b": rng.normal(0, 1, (4,)).astype(np.float32)}
    w = np.array([0.1, 0.3, 0.2, 0.25, 0.15], np.float32)
    jd = {k: jnp.asarray(v).astype(dtype) for k, v in d.items()}
    td = {k: torch.as_tensor(v).to(getattr(torch, dtype))
          for k, v in d.items()}
    return p, w, jd, td


@pytest.mark.parametrize("defense,sopt", [
    (None, "none"), ("clip", "none"), ("trimmed_mean", "none"),
    ("median", "none"), (None, "momentum"), ("clip", "nesterov")])
def test_aggregate_deltas_matches_reference(defense, sopt):
    p, w, jd, td = injected_deltas("float32", poison=defense is not None)
    kw = dict(defense=defense, trim_frac=0.25, clip_norm=2.0)
    jsgd = jserver_opt.make_sgd(sopt, 0.9)
    sgd = server_opt.make_sgd(sopt, 0.9)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jstate = None if jsgd is None else jsgd.init(jp)
    state = None if sgd is None else sgd.init(tp)
    for _ in range(2):                      # the momentum's second step too
        jp, jstate = jfed_step.aggregate_deltas(
            jp, jd, jnp.asarray(w), 0.7, server_sgd=jsgd,
            server_state=jstate, **kw)
        kept = {k: v.clone() for k, v in tp.items()}
        tp, state = fed_step.aggregate_deltas(
            tp, td, torch.as_tensor(w), 0.7, server_sgd=sgd,
            server_state=state, **kw)
        for k in jp:
            assert rel(tp[k], jp[k]) <= AGG_TOL, (k, rel(tp[k], jp[k]))
        assert all(not torch.equal(tp[k], kept[k]) for k in tp)
    if defense is not None:
        assert all(bool(torch.isfinite(v).all()) for v in tp.values())
    with pytest.raises(ValueError, match="defense"):
        fed_step.aggregate_deltas(tp, td, torch.as_tensor(w), 1.0,
                                  defense="krum")


def test_defended_aggregate_deltas_on_the_reference_example():
    """tests/test_fed_robust.py's classical case on the port."""
    params = {"w": torch.zeros(3)}
    honest = np.array([[1.0, 1.0, 1.0], [1.2, 0.8, 1.0], [0.8, 1.2, 1.0]],
                      np.float32)
    poison = np.array([[-50.0, -50.0, -50.0]], np.float32)
    deltas = {"w": torch.as_tensor(np.concatenate([honest, poison]))}
    w = torch.full((4,), 0.25)
    plain, _ = fed_step.aggregate_deltas(params, deltas, w, 1.0)
    tm, _ = fed_step.aggregate_deltas(params, deltas, w, 1.0,
                                      defense="trimmed_mean", trim_frac=0.25)
    clip, _ = fed_step.aggregate_deltas(params, deltas, w, 1.0,
                                        defense="clip", clip_norm=2.0)
    assert float(plain["w"][0]) < -10.0
    np.testing.assert_allclose(tm["w"].numpy(), [0.9, 0.9, 1.0], rtol=1e-5)
    assert float(clip["w"].abs().max()) < 2.0


def test_bf16_wire_aggregate_within_one_ulp():
    p, w, jd, td = injected_deltas("bfloat16")
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp, _ = jfed_step.aggregate_deltas(
        {k: jnp.asarray(v) for k, v in p.items()}, jd, jnp.asarray(w), 1.0)
    # the weighted sums themselves, before the fp32 params absorb them
    wsum = {k: np.asarray(jnp.sum(d * jnp.asarray(w).astype(d.dtype)
                                  .reshape((-1,) + (1,) * (d.ndim - 1)),
                                  axis=0).astype(jnp.float32))
            for k, d in jd.items()}
    zero = {k: torch.zeros(v.shape) for k, v in p.items()}
    got, _ = fed_step.aggregate_deltas(zero, td, torch.as_tensor(w), 1.0)
    for k in wsum:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wsum[k]),
                                                  1e-30))) - 7)
        assert np.all(np.abs(got[k].numpy() - wsum[k]) <= ulp), k
    tp, _ = fed_step.aggregate_deltas(
        {k: torch.as_tensor(v) for k, v in p.items()}, td,
        torch.as_tensor(w), 1.0)
    for k in jp:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wsum[k]),
                                                  1e-30))) - 7)
        assert np.all(np.abs(tp[k].numpy() - np.asarray(jp[k]))
                      <= ulp + 1e-6 * np.abs(np.asarray(jp[k]))), k


# ------------------------------------------------- the substrate and session
def cspec(**kw):
    base = dict(arch=ARCH, n_layers=1, num_nodes=3, nodes_per_round=2,
                interval_length=2, node_batch=2, seq_len=S, data_seed=0)
    base.update(kw)
    return api.FedSpec.classical(**base)


def jcspec(**kw):
    spec = cspec(**kw)
    return japi.FedSpec.from_json(spec.to_json())


FULL = dict(num_nodes=2, nodes_per_round=2, participation="full")


@pytest.mark.parametrize("server", ["none", "nesterov"])
def test_session_matches_reference_under_full_participation(server):
    kw = dict(FULL, server_opt=server, server_momentum=0.8, lr=0.1)
    jsub = japi.ClassicalSubstrate(jcspec(**kw), opt=JSGD())
    sub = api.ClassicalSubstrate(cspec(**kw), opt=SGD(), device="cpu")
    params = conditioned(jsub.model.init(jax.random.PRNGKey(0)))
    jsess = japi.FederationSession.create(
        jsub.spec, jax.random.PRNGKey(1), substrate=jsub,
        params={k: jnp.asarray(v) for k, v in params.items()})
    sess = api.FederationSession.create(
        sub.spec, 1, substrate=sub,
        params=convert.model_params_to_torch(params, sub.cfg, device="cpu"))
    for k in jsub.eval_batch:
        np.testing.assert_array_equal(sub.eval_batch[k].numpy(),
                                      np.asarray(jsub.eval_batch[k]))
    jsess.run(2, callbacks=[japi.EvalEvery(1)])
    sess.run(2, callbacks=[api.EvalEvery(1)])
    np.testing.assert_allclose(sess.history["eval_loss"],
                               jsess.history["eval_loss"], rtol=TOL)
    assert sess.history["iteration"] == jsess.history["iteration"]
    for k in params:
        assert rel(sess.state["params"][k], jsess.state["params"][k]) <= TOL
    # the checkpoint layout: the same keys and shapes
    assert _flat_shapes(sess) == _flat_shapes(jsess)


def _flat_shapes(sess):
    from repro_torch.checkpoint.checkpoint import _flatten
    return {k: tuple(v.shape) for k, v in
            _flatten(sess.substrate.state_flat(sess.state)).items()}


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    spec = cspec(**FULL)
    jsess = japi.FederationSession.create(jcspec(**FULL),
                                          jax.random.PRNGKey(2))
    jsess.run(1, callbacks=[japi.EvalEvery(1)])
    path = str(tmp_path / "ref.npz")
    jsess.save(path)
    sess = api.FederationSession.resume(path, device="cpu")
    assert sess.spec == spec and sess.round == 1
    assert isinstance(sess.substrate, api.ClassicalSubstrate)
    assert sess.state["opt"].step.tolist() == [2, 2]
    assert sess.state["opt"].step.device.type == "cpu"
    for k, v in jsess.state["params"].items():
        np.testing.assert_array_equal(sess.state["params"][k].numpy(),
                                      np.asarray(v))
        np.testing.assert_array_equal(sess.state["opt"].m[k].numpy(),
                                      np.asarray(jsess.state["opt"].m[k]))
    want = jsess.evaluate()["eval_loss"]
    assert abs(sess.evaluate()["eval_loss"] - want) <= LOSS_TOL * want
    # one more round on each (AdamW, full participation): the losses
    jsess.run(1, callbacks=[japi.EvalEvery(1)])
    sess.run(1, callbacks=[api.EvalEvery(1)])
    assert abs(sess.history["eval_loss"][-1] - jsess.history["eval_loss"][-1]
               ) <= LOSS_TOL * jsess.history["eval_loss"][-1]


def copy_state(state):
    return tree_map(torch.clone, state)


def assert_states_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_classical_phases_are_the_round():
    """run_round is compose_round (the local phase consumes the opt state
    in place, so each runs on its own snapshot of the state, and the
    state itself stays as it was)."""
    sub = api.ClassicalSubstrate(cspec(), device="cpu")
    state = sub.init_state(0)
    before = copy_state(state)
    s1, m1 = sub.run_round(sub.snapshot(state), 5, 0)
    s2, m2 = phases.compose_round(sub, sub.snapshot(state), 5, 0)
    assert_states_equal(state, before)
    assert_states_equal(s1, s2)
    assert m1.keys() == m2.keys() and "loss" in m1


def test_sync_scheduler_matches_the_frozen_loop():
    spec = cspec()
    sub = api.make_substrate(spec, device="cpu")
    assert isinstance(sub, api.ClassicalSubstrate)
    sess = api.FederationSession.create(spec, 7, substrate=sub)
    assert isinstance(sess.scheduler, api.SyncScheduler)
    state = sub.init_state(api.rng.split(7)[0])
    for t in range(2):
        state, _ = sub.run_round(state, sess.round_key(t), t)
    sess.run(2)
    assert_states_equal(sess.state, state)


def session(spec, key=3):
    return api.FederationSession.create(spec, key, device="cpu")


@pytest.mark.parametrize("schedule", ["sync", "async", "overlapped"])
def test_kill_and_resume_bit_exact(schedule, tmp_path):
    kw = dict(schedule=schedule)
    if schedule == "async":
        kw.update(async_commit=1, staleness_decay=0.5, latency_seed=9)
    spec = cspec(**kw)
    straight = session(spec)
    straight.run(3, callbacks=[api.EvalEvery(1)])
    killed = session(spec)
    killed.run(1, callbacks=[api.EvalEvery(1)])
    if schedule == "async":
        assert killed.scheduler.entries     # uploads in flight at the kill
    if schedule == "overlapped":
        assert killed.scheduler.pending is not None
    path = str(tmp_path / "fed.npz")
    killed.save(path)
    del killed
    resumed = api.FederationSession.resume(path, device="cpu")
    assert resumed.spec == spec and resumed.round == 1
    resumed.run(2, callbacks=[api.EvalEvery(1)])
    assert resumed.history == straight.history
    assert_states_equal(resumed.state, straight.state)
    if schedule == "async":
        assert resumed.scheduler.clock == straight.scheduler.clock
        assert resumed.scheduler.dispatched == straight.scheduler.dispatched
    resumed.flush()
    straight.flush()
    assert_states_equal(resumed.state, straight.state)


def test_server_opt_beta_zero_is_plain_server():
    a = session(cspec(), key=0)
    b = session(cspec(server_opt="momentum", server_momentum=0.0), key=0)
    a.run(2)
    b.run(2)
    for k in a.state["params"]:
        assert torch.equal(a.state["params"][k], b.state["params"][k])
    assert "sopt" in b.state and "sopt" not in a.state


def test_faulted_sync_retry_starts_from_the_pre_round_state():
    """A deadline that drops a node forces a re-dispatch: the committed
    round must equal one dispatched once from the same state (the failed
    attempt's local steps leave no trace in the inner optimizer)."""
    from repro_torch.core.fed.cohort import latency as flatency
    base = dict(FULL, latency_model="lognormal", latency_seed=9)
    lat = flatency.make_model(cspec(**base))
    cut = 0.5 * sum(sorted(float(lat(n, 0)) for n in range(2)))
    spec = cspec(**base, round_deadline=cut, max_retries=2,
                 retry_backoff=100.0, min_participants=2)
    sess = session(spec, key=1)
    m = sess.step()
    assert m["n_retries"] == 1.0 and m["n_survived"] == 2.0
    plain = session(cspec(**base), key=1)
    plain.step()
    assert_states_equal(sess.state, plain.state)


def test_classical_unequal_nodes_weighted_round():
    spec = cspec(num_nodes=3, interval_length=1, node_sizes=(1, 2, 5),
                 participation="weighted")
    sess = session(spec, key=2)
    sess.run(1, callbacks=[api.EvalEvery(1)])
    assert np.isfinite(sess.history["eval_loss"]).all()
    with pytest.raises(ValueError, match="node_sizes"):
        api.FedSpec.classical(arch=ARCH, num_nodes=3, nodes_per_round=2,
                              node_sizes=(1, 2))


def test_quantize_channel_round_is_deterministic():
    spec = cspec(quantize_bits=8)
    a, b = session(spec), session(spec)
    a.run(1)
    b.run(1)
    assert_states_equal(a.state, b.state)
    plain = session(cspec())
    plain.run(1)
    assert any(not torch.equal(a.state["params"][k], plain.state["params"][k])
               for k in a.state["params"])


def test_classical_tiny_spec_file_runs_a_round():
    with open(os.path.join(ROOT, "benchmarks", "specs",
                           "classical_tiny.json")) as f:
        spec = api.FedSpec.from_json(f.read())
    assert spec.substrate == "classical" and spec.arch == ARCH
    sess = session(spec)
    sess.run(1, callbacks=[api.EvalEvery(1)])
    assert sess.round == 1 and np.isfinite(sess.history["eval_loss"]).all()


# ------------------------------------------------------ driver and example
def test_fed_train_driver_lines_and_resume(tmp_path, capsys):
    path = str(tmp_path / "fed.npz")
    argv = ["--arch", ARCH, "--nodes", "3", "--nodes-per-round", "2",
            "--node-batch", "2", "--seq", str(S), "--device", "cpu"]
    fed_train.main(argv + ["--rounds", "2", "--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"fed arch={ARCH}-smoke N=3 N_p=2 I_l=2 "
                      "non-iid=True")
    assert out[1].startswith("round  0  eval loss ")
    assert out[2].startswith("round  1  eval loss ") and "train loss" in out[2]
    fed_train.main(["--resume", path, "--rounds", "1", "--device", "cpu",
                    "--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed {path} at round 2 (arch={ARCH})"
    assert out[1].startswith("round  3  eval loss ")
    # 2 rounds + resume 1 == 3 straight rounds (the key plan regrows)
    sess = api.FederationSession.resume(path, device="cpu")
    assert sess.round == 3 and len(sess.round_keys) == 3
    assert sess.round_keys == api.sequential_split_plan(7, 3)
    spec_path = str(tmp_path / "spec.json")
    fed_train.main(argv + ["--dump-spec", spec_path])
    with open(spec_path) as f:
        dumped = f.read()
    assert japi.FedSpec.from_json(dumped).to_json_dict() == \
        api.FedSpec.from_json(dumped).to_json_dict()


def test_local_sgd_example_runs_the_reference_spec(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jexample", os.path.join(ROOT, "examples", "fed_llm_local_sgd.py"))
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    seen = []

    def capture(spec, *a, **k):
        seen.append(spec)
        raise StopIteration
    monkeypatch.setattr(jexample.api.FederationSession, "create", capture)
    spec = importlib.util.spec_from_file_location(
        "texample", os.path.join(ROOT, "examples",
                                 "torch_fed_llm_local_sgd.py"))
    texample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(texample)
    for interval in (1, 2, 4):
        with pytest.raises(StopIteration):
            jexample.run(interval)
        assert texample.make_spec(interval).to_json_dict() == \
            seen[-1].to_json_dict()
    loss, rounds = texample.run(4, device="cpu")
    assert rounds == 2 and np.isfinite(loss)
