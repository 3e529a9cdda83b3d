"""The port's MoE FFN (``repro_torch.models.layers.moe``) against the JAX
reference on the CPU, and the reference's own MoE gates
(tests/test_moe.py) run on the port.

Inputs are numpy arrays on both sides: the reference draws the layer's
params (fp32, key 0) and they are carried to the port as they are.

Tolerances:

- routing: the expert indices equal, index for index, and the kept /
  dropped assignments equal, assignment for assignment (a routing
  difference reads as routing, before any numerics are compared);
- the output and both aux losses within 1e-5 of the reference's scale
  (max abs): the same fp32 function, summed in another order;
- the reference's gates at their own tolerances (1e-5 and 1e-6 abs).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as pp  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.models.layers.mlp import _act  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the layers are tiny."""
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


def make_moe(n_experts=4, top_k=2, d=32, f=64, cf=2.0, key=0, **kw):
    """tests/test_moe.py's layer on both sides: (port cfg, reference cfg,
    torch params, jax params), the params drawn by the reference."""
    over = dict(d_model=d, d_ff=f, n_experts=n_experts, top_k=top_k,
                capacity_factor=cf, moe_dense_residual=False)
    over.update(kw)
    cfg = get_config("arctic-480b").reduced(**over)
    jcfg = jget_config("arctic-480b").reduced(**over)
    ini = jpp.Initializer(jnp.float32, key=jax.random.PRNGKey(key))
    jmoe.init_moe(ini, "moe", jcfg)
    jp = jpp.subtree(ini.params, "moe")
    return cfg, jcfg, {k: t(v) for k, v in jp.items()}, jp


def normal(seed, shape, scale):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def reference_routing(jp, x, jcfg):
    """The reference's routing, its lines (moe.py:64-86) on its arrays:
    (expert indices (t, k), keep (t*k,))."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, jp["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    flat = idx.reshape(-1)
    oh = jax.nn.one_hot(flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(idx), np.asarray(pos < jmoe.capacity(jcfg, xf.shape[0]))


# ------------------------------------------------ the reference's gates
@pytest.mark.parametrize("n_tokens", [1, 7, 128, 1000, 4096])
def test_capacity_rounding(n_tokens):
    cfg, jcfg, _, _ = make_moe()
    c = moe.capacity(cfg, n_tokens)
    assert c % 8 == 0 and c >= 8
    assert c >= n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts - 8
    assert c == jmoe.capacity(jcfg, n_tokens)


def test_moe_output_finite_and_shaped():
    cfg, _, p, _ = make_moe()
    x = t(normal(1, (2, 16, 32), 0.5))
    y, aux = moe.moe_ffn(p, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux["load_balance"]) >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz
    assert float(aux["router_z"]) >= 0.0


def test_moe_router_biased_to_expert_zero():
    """Router columns 1-3 at -100 and positive activations: every token
    goes to expert 0 alone, so the output is expert 0's FFN."""
    cfg, _, p, _ = make_moe(n_experts=4, top_k=1)
    router = np.zeros((32, 4), np.float32)
    router[:, 1:] = -100.0
    p = dict(p, router=t(router))
    x = t(np.abs(normal(2, (1, 8, 32), 0.1)))
    y, _ = moe.moe_ffn(p, x, cfg)
    xf = x.reshape(-1, 32)
    h = xf @ p["w_in"][0]
    g = xf @ p["w_gate"][0]
    want = (_act("silu")(g) * h) @ p["w_out"][0]
    np.testing.assert_allclose(y.reshape(-1, 32).numpy(), want.numpy(),
                               atol=1e-5)


def test_moe_capacity_drops_overflow():
    """A tiny capacity factor drops most assignments: a smaller output,
    still finite."""
    cfg_big, _, p, _ = make_moe(cf=8.0)
    cfg_small = dataclasses.replace(cfg_big, capacity_factor=0.1)
    x = t(normal(3, (2, 32, 32), 0.5))
    y_big, _ = moe.moe_ffn(p, x, cfg_big)
    y_small, _ = moe.moe_ffn(p, x, cfg_small)
    assert float(y_small.norm()) < float(y_big.norm())
    assert bool(torch.isfinite(y_small).all())


def test_moe_gate_renormalization():
    """The same router gives the same output (softmax shift invariance
    and the renormalised top-k gates)."""
    cfg, _, p, _ = make_moe()
    x = t(normal(4, (1, 8, 32), 0.3))
    y1, _ = moe.moe_ffn(p, x, cfg)
    y2, _ = moe.moe_ffn(dict(p, router=p["router"] * 1.0 + 0.0), x, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)


@pytest.mark.parametrize("extra", ["dense", "shared"])
def test_dense_residual_and_shared_expert_add(extra):
    """Zeroing the extra FFN's output weights recovers the pure-MoE
    output (the reference's case for the dense residual, and the same for
    the shared expert)."""
    flag = {"dense": "moe_dense_residual", "shared": "shared_expert"}[extra]
    cfg, _, p, _ = make_moe(key=7, **{flag: True})
    x = t(normal(5, (1, 8, 32), 0.3))
    y, _ = moe.moe_ffn(p, x, cfg)
    zeroed = dict(p, **{f"{extra}/w_out": torch.zeros_like(
        p[f"{extra}/w_out"])})
    y_zero, _ = moe.moe_ffn(zeroed, x, cfg)
    pure = {k: v for k, v in p.items() if not k.startswith(f"{extra}/")}
    y_moe, _ = moe.moe_ffn(pure, x, dataclasses.replace(cfg, **{flag: False}))
    np.testing.assert_allclose(y_zero.numpy(), y_moe.numpy(), atol=1e-6)
    assert float((y - y_moe).abs().max()) > 1e-3


# ------------------------------------------------ parity with the reference
@pytest.mark.parametrize("top_k,cf,extras", [
    (2, 2.0, {}), (2, 0.5, {}), (1, 0.5, {}), (1, 1.25, {}),
    (2, 0.5, {"moe_dense_residual": True}),
    (1, 0.5, {"shared_expert": True}),
    (2, 1.25, {"moe_dense_residual": True, "shared_expert": True})],
    ids=["k2-cf2", "k2-cf0.5", "k1-cf0.5", "k1-cf1.25", "k2-dense",
         "k1-shared", "k2-both"])
def test_moe_ffn_matches_the_reference(top_k, cf, extras):
    cfg, jcfg, p, jp = make_moe(n_experts=4, top_k=top_k, cf=cf, key=3,
                                **extras)
    x = normal(6, (2, 24, 32), 0.5)
    want_idx, want_keep = reference_routing(jp, x, jcfg)
    xf = t(x).reshape(-1, 32)
    gate, idx, _ = moe.route(p, xf, cfg)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    keep, slot = moe.slots(idx, moe.capacity(cfg, xf.shape[0]),
                           cfg.n_experts)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 0.5:
        assert not want_keep.all()          # the case drops assignments
    y, aux = moe.moe_ffn(p, t(x), cfg)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    assert rel(y, jy) <= TOL
    assert sorted(aux) == sorted(jaux) == ["load_balance", "router_z"]
    for k in aux:
        assert rel(aux[k], jaux[k]) <= TOL, k


def test_top_k_breaks_ties_as_the_reference():
    """Equal probabilities (a zero router) pick the lower expert index
    first, as jax.lax.top_k does."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals, idx = moe.top_k(t(probs), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_params_match_the_reference_paths():
    cfg, jcfg, _, _ = make_moe(moe_dense_residual=True, shared_expert=True)
    ini = pp.Initializer(torch.float32, device="meta")
    moe.init_moe(ini, "moe", cfg, stack=3)
    jini = jpp.Initializer(jnp.float32, abstract=True)
    jmoe.init_moe(jini, "moe", jcfg, stack=3)
    assert sorted(ini.params) == sorted(jini.params)
    for k, v in jini.params.items():
        assert tuple(ini.params[k].shape) == tuple(v.shape), k


def test_moe_backpropagates():
    """Gradients reach the router (through the gates), the experts and
    the input; the dropped assignments give no gradient."""
    cfg, _, p, _ = make_moe(cf=0.5)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = t(normal(8, (2, 16, 32), 0.5)).requires_grad_()
    y, aux = moe.moe_ffn(leaves, x, cfg)
    (y.square().sum() + aux["load_balance"] + aux["router_z"]).backward()
    for k, v in leaves.items():
        assert v.grad is not None and float(v.grad.abs().max()) > 0, k
    assert bool(torch.isfinite(x.grad).all())
