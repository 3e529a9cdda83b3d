"""The port's fed core (``repro_torch.core.fed``: participation, channel,
strategies' defenses, server_opt, faults) against the JAX reference.

Schedules are held by behaviour (the port draws from torch generators,
not the reference's keys), mirroring ``tests/test_fed_strategies.py``:
distinct, in range, uniform frequency, the ``auto`` routing, size-aware
sampling, the dropout rate and its re-draw. The channels' arithmetic is
held to the reference at <= 1e-10 with the reference's own draws fed to
the port's draw-free cores; the defense primitives and the server
momentum step on the same arrays; the fault draws bit for bit (numpy on
both sides)."""
import math
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import channel as jchannel  # noqa: E402
from repro.core.fed import faults as jfaults  # noqa: E402
from repro.core.fed import participation as jpart  # noqa: E402
from repro.core.fed import server_opt as jsopt  # noqa: E402
from repro.core.fed import strategies as jstrat  # noqa: E402
from repro_torch.core.fed import channel, faults, participation  # noqa: E402
from repro_torch.core.fed import server_opt, strategies  # noqa: E402

TOL = 1e-10
TRACE = os.path.join(os.path.dirname(__file__), os.pardir, "benchmarks",
                     "traces", "tiny_faults.json")


def gen(seed):
    return torch.Generator().manual_seed(seed)


def draw(seed, n, k, **kw):
    return participation.sample_nodes(gen(seed), n, k, device="cpu", **kw)


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def err(port, ref):
    return float(np.max(np.abs(port.resolve_conj().numpy() - np.asarray(ref))))


# ------------------------------------------------------------ schedules
def test_sampled_method_distinct_in_range_deterministic():
    for seed in range(20):
        sel, mask = draw(seed, 50, 7, method="sampled")
        arr = sel.tolist()
        assert len(set(arr)) == 7 and min(arr) >= 0 and max(arr) < 50
        assert torch.equal(sel, draw(seed, 50, 7, method="sampled")[0])
        assert torch.equal(mask, torch.ones(7))


def test_sampled_method_frequency_uniform():
    """Every node appears ~k/n of the time under Floyd's sampler, in
    every position (uniform over subsets and orders)."""
    n, k, trials = 10, 3, 2000
    sels = torch.stack([draw(s, n, k, method="sampled")[0]
                        for s in range(trials)])
    freq = np.bincount(sels.numpy().ravel(), minlength=n) / trials
    np.testing.assert_allclose(freq, k / n, atol=0.05)
    first = np.bincount(sels[:, 0].numpy(), minlength=n) / trials
    np.testing.assert_allclose(first, 1 / n, atol=0.04)


def test_floyd_from_uniforms_is_floyds_sampler():
    # t = floor(u (j + 1)) for j = n - k + i, j itself on a repeat
    assert participation.floyd_from_uniforms(5, 3, [0.99] * 3) == [2, 3, 4]
    assert participation.floyd_from_uniforms(5, 3, [0.0] * 3) == [0, 3, 4]
    assert participation.floyd_from_uniforms(6, 2, [0.5, 0.2]) == [2, 1]


def test_auto_method_routes_by_size():
    """auto is the dense draw below SAMPLED_MIN and Floyd above it when
    N_p^2 < N; an unknown method fails loudly."""
    assert participation.SAMPLED_MIN == jpart.SAMPLED_MIN == 4096
    assert participation.METHODS == jpart.METHODS
    assert torch.equal(draw(9, 64, 4)[0], draw(9, 64, 4, method="dense")[0])
    n = participation.SAMPLED_MIN
    assert torch.equal(draw(9, n, 8)[0], draw(9, n, 8, method="sampled")[0])
    assert not torch.equal(draw(9, n, 8)[0], draw(9, n, 8, method="dense")[0])
    # N_p^2 >= N keeps the dense permutation
    assert torch.equal(draw(9, n, 64)[0], draw(9, n, 64, method="dense")[0])
    with pytest.raises(ValueError, match="unknown participation method"):
        draw(0, 8, 2, method="fastest")


def test_sampling_without_replacement_all_schedules():
    sizes = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    assert participation.SCHEDULES == jpart.SCHEDULES
    for schedule in participation.SCHEDULES:
        n_p = 6 if schedule == "full" else 4
        for seed in range(5):
            sel, mask = draw(seed, 6, n_p, schedule=schedule,
                             node_sizes=sizes, dropout_rate=0.5)
            assert len(set(sel.tolist())) == n_p
            assert mask.shape == (n_p,) and mask.dtype == torch.float32


def test_weighted_schedule_prefers_large_nodes():
    sizes = torch.tensor([200.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    hits = sum(0 in draw(s, 6, 2, schedule="weighted",
                         node_sizes=sizes)[0].tolist() for s in range(100))
    assert hits > 80
    with pytest.raises(ValueError, match="node_sizes"):
        draw(0, 4, 2, schedule="weighted")


def test_dropout_schedule_masks_at_rate():
    rate, trials = 0.3, 400
    kept = np.mean([float(draw(s, 8, 4, schedule="dropout",
                               dropout_rate=rate)[1].mean())
                    for s in range(trials)])
    assert abs(kept - (1.0 - rate)) < 0.06


def test_dropout_redraws_an_all_dropped_mask():
    """A first draw that drops every node is drawn again from the same
    generator; the mask returned is the first with a survivor."""
    rate, n, k = 0.9, 8, 2
    for seed in range(200):
        g = gen(seed)
        participation._uniform_choice(g, n, k, "dense")
        first = torch.rand(k, generator=g, dtype=torch.float64)
        if bool(participation.dropout_mask(first, rate).any()):
            continue
        second = participation.dropout_mask(
            torch.rand(k, generator=g, dtype=torch.float64), rate)
        _, mask = draw(seed, n, k, schedule="dropout", dropout_rate=rate)
        assert float(mask.sum()) >= 1.0
        if bool(second.any()):
            assert torch.equal(mask, second)
        break
    else:
        pytest.fail("no seed under 200 drops both nodes at rate 0.9")
    for seed in range(40):
        _, mask = draw(seed, n, k, schedule="dropout", dropout_rate=0.95)
        assert float(mask.sum()) >= 1.0
    with pytest.raises(ValueError, match="dropout_rate"):
        draw(0, 8, 2, schedule="dropout", dropout_rate=1.0)


def test_schedules_compose_at_large_n():
    """Floyd under dropout at cohort scale: a valid without-replacement
    subset whose surviving data-volume weights sum to 1; weighted
    sampling at N > SAMPLED_MIN pairs with uniform round weights."""
    n = 4 * participation.SAMPLED_MIN
    sizes = torch.arange(1.0, n + 1.0)
    for seed in range(5):
        sel, mask = draw(seed, n, 8, schedule="dropout", dropout_rate=0.4)
        assert len(set(sel.tolist())) == 8 and 0 <= int(sel.min())
        assert int(sel.max()) < n
        w = participation.participation_weights(sizes[sel], mask)
        assert abs(float(w.sum()) - 1.0) <= 1e-5
    sel, mask = draw(2, participation.SAMPLED_MIN + 1, 6,
                     schedule="weighted", node_sizes=sizes)
    w = participation.round_weights("weighted", sizes[sel], mask)
    np.testing.assert_allclose(w.numpy(), np.full(6, 1 / 6), atol=1e-6)


@pytest.mark.parametrize("schedule", ["uniform", "weighted", "dropout"])
def test_round_weights_match_reference(schedule):
    sizes = np.array([3.0, 4.0, 2.0, 4.0, 7.0], np.float32)
    m = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    got = participation.round_weights(schedule, torch.tensor(sizes),
                                      torch.tensor(m))
    want = jpart.round_weights(schedule, jnp.asarray(sizes), jnp.asarray(m))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- channels
def test_perturb_updates_matches_reference_draws(x64):
    rng = np.random.default_rng(4)
    ks = [rand_c(rng, 3, 2, 3, 8, 8), rand_c(rng, 3, 2, 2, 16, 16)]
    ks = [(k + np.conj(np.swapaxes(k, -1, -2))) / 2 for k in ks]
    key = jax.random.PRNGKey(21)
    want = jchannel.perturb_updates(key, [jnp.asarray(k) for k in ks], 0.1)
    gauss = []
    for i, k in enumerate(ks):               # the reference's own draws
        kr, ki = jax.random.split(jax.random.fold_in(key, i))
        a = jax.random.normal(kr, k.shape) + 1j * jax.random.normal(ki,
                                                                    k.shape)
        gauss.append(torch.tensor(np.asarray(a)))
    got = channel.perturb_with([torch.tensor(k) for k in ks], gauss, 0.1)
    for g, w in zip(got, want):
        assert err(g, w) <= TOL
        assert float((g - g.mH).abs().max()) <= 1e-12
    noise = channel.hermitian_noise(gen(0), (4, 8, 8), torch.complex128,
                                    "cpu")
    norms = torch.linalg.matrix_norm(noise)
    assert float((norms - 1.0).abs().max()) <= 1e-12
    assert float((noise - noise.mH).abs().max()) == 0.0


def test_stochastic_round_matches_reference_draws(x64):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 5))
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, x.shape, dtype=jnp.float64)
    want = jchannel._stochastic_round(key, jnp.asarray(x), 6)
    got = channel._round_with(torch.tensor(x), 6, torch.tensor(np.asarray(u)))
    assert err(got, want) <= TOL
    # complex uploads: real and imaginary parts on independent draws
    z = rand_c(rng, 2, 3, 4, 4)
    qc = jchannel.QuantizationChannel(8)
    want = qc(key, [jnp.asarray(z)])[0]
    kr, ki = jax.random.split(jax.random.fold_in(key, 0))
    u_re, u_im = (torch.tensor(np.asarray(jax.random.uniform(
        k, z.shape, dtype=jnp.float64))) for k in (kr, ki))
    got = channel.quantize_with(torch.tensor(z), 8, (u_re, u_im))
    assert err(got, want) <= TOL


def test_stochastic_round_is_unbiased_on_its_grid():
    x = torch.linspace(-1.0, 1.0, 11, dtype=torch.float64)
    outs = torch.stack([channel._stochastic_round(gen(s), x, 3)
                        for s in range(2000)])
    scale = 1.0 / 3.0
    grid = outs / scale
    assert float((grid - grid.round()).abs().max()) <= 1e-12
    assert float((outs.mean(0) - x).abs().max()) <= 0.03


def test_channel_registry():
    assert channel.CHANNELS == jchannel.CHANNELS
    assert isinstance(channel.make_channel("identity"),
                      channel.IdentityChannel)
    assert channel.make_channel("hermitian", sigma=0.2).sigma == 0.2
    assert channel.make_channel("quantize", bits=4).bits == 4
    with pytest.raises(ValueError, match="unknown channel"):
        channel.make_channel("erasure")
    with pytest.raises(ValueError, match="bits"):
        channel.QuantizationChannel(17)
    ks = [torch.randn(2, 3, 3, dtype=torch.complex128)]
    out = channel.QuantizationChannel(8)(gen(1), ks)
    again = channel.QuantizationChannel(8)(gen(1), ks)
    assert torch.equal(out[0], again[0]) and out[0].dtype == ks[0].dtype


# ----------------------------------------------- defenses and momentum
@pytest.mark.parametrize("kind,trim", [("median", 0.0),
                                       ("trimmed_mean", 0.3),
                                       ("trimmed_mean", 0.0)])
def test_robust_combine_matches_reference(x64, kind, trim):
    rng = np.random.default_rng(6)
    x = rand_c(rng, 7, 2, 3, 3)
    valid = np.array([True, True, False, True, True, False, True])
    x[2] = np.inf                # invalid payloads never reach the sum
    x[5] = np.nan
    want = jstrat.robust_combine(jnp.asarray(x), jnp.asarray(valid), kind,
                                 trim)
    got = strategies.robust_combine(torch.tensor(x), torch.tensor(valid),
                                    kind, trim)
    assert err(got, want) <= TOL
    # per-session valid sets: (n, S) against S reference calls
    vs = np.stack([valid, np.ones(7, bool), np.arange(7) < 2], 1)
    xs = rand_c(rng, 7, 3, 2, 2)
    got = strategies.robust_combine(torch.tensor(xs), torch.tensor(vs),
                                    kind, trim)
    for s in range(3):
        want = jstrat.robust_combine(jnp.asarray(xs[:, s]),
                                     jnp.asarray(vs[:, s]), kind, trim)
        assert err(got[s], want) <= TOL
    none = strategies.robust_combine(torch.tensor(xs[:, 0]),
                                     torch.zeros(7, dtype=torch.bool), kind,
                                     trim)
    assert float(none.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_robust_combine_keeps_hermitian_stacks_hermitian(dtype):
    """Mirrored coordinates see negated value multisets, summed in
    other orders: Hermitian to the rounding of the dtype, not bit for
    bit."""
    rng = np.random.default_rng(7)
    a = rand_c(rng, 9, 2, 4, 4)
    h = torch.tensor((a + np.conj(np.swapaxes(a, -1, -2))) / 2).to(dtype)
    valid = torch.ones(9, dtype=torch.bool)
    valid[4] = False
    tol = 8 * torch.finfo(h.real.dtype).eps * float(h.abs().max())
    for kind in ("median", "trimmed_mean"):
        out = strategies.robust_combine(h, valid, kind, 0.25)
        assert float((out - out.mH).abs().max()) <= tol


def test_clip_factors_and_finite_nodes_match_reference(x64):
    rng = np.random.default_rng(8)
    x = rand_c(rng, 5, 2, 3, 3) * np.array([0.1, 1.0, 3.0, 10.0, 1.0]
                                           )[:, None, None, None]
    x[4, 1, 0, 0] = np.nan
    for norm in (0.5, 2.0):
        want = jstrat.clip_factors(jnp.asarray(x), norm)
        got = strategies.clip_factors(torch.tensor(x), norm)
        assert got.shape == (5, 2, 1, 1) and not got.is_complex()
        assert err(got, want) <= TOL
    y = rng.standard_normal((5, 4))
    y[1, 2] = np.inf
    ups = [torch.tensor(x), torch.tensor(y)]
    want = jstrat.finite_nodes([jnp.asarray(x), jnp.asarray(y)])
    assert strategies.finite_nodes(ups).tolist() == np.asarray(want).tolist()


def test_defense_registry():
    assert strategies.DEFENSES == jstrat.DEFENSES
    assert strategies.PARTIAL_KINDS == jstrat.PARTIAL_KINDS
    assert strategies.validate_defense(None, "product") is None
    assert strategies.validate_defense("screen", "product") == "screen"
    for name, combine in (("krum", "average"), ("median", "product"),
                          ("screen", "average")):
        with pytest.raises(ValueError):
            strategies.validate_defense(name, combine)
    agg = strategies.get_aggregation("served")
    assert strategies.partial_kind(agg) == jstrat.partial_kind(
        jstrat.get_aggregation("served"))


@pytest.mark.parametrize("name", ["none", "momentum", "nesterov"])
def test_generator_step_matches_reference(x64, name):
    rng = np.random.default_rng(9)
    kbar, mom = rand_c(rng, 2, 3, 4, 4), rand_c(rng, 2, 3, 4, 4)
    for m in (None, mom):
        want = jsopt.generator_step(name, 0.9, None if m is None
                                    else jnp.asarray(m), jnp.asarray(kbar))
        got = server_opt.generator_step(name, 0.9, None if m is None
                                        else torch.tensor(m),
                                        torch.tensor(kbar))
        assert (got[0] is None) == (want[0] is None)
        for g, w in zip(got, want):
            if g is not None:
                assert err(g, w) <= TOL
    assert server_opt.SERVER_OPTS == jsopt.SERVER_OPTS
    with pytest.raises(ValueError):
        server_opt.validate("adam")


# --------------------------------------------------------------- faults
def same_effect(a, b):
    return all((math.isnan(x) and math.isnan(y)) or x == y
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", sorted(jfaults._EFFECTS))
def test_fault_draws_bit_identical(kind):
    mine = faults.DrawFault(kind, 0.3, 5, 2.5)
    ref = jfaults.DrawFault(kind, 0.3, 5, 2.5)
    grid = [(n, r) for n in range(20) for r in range(5)]
    assert all(same_effect(mine(n, r), ref(n, r)) for n, r in grid)
    assert any(mine.hits(n, r) for n, r in grid)
    assert faults.PERSISTENT == jfaults.PERSISTENT and faults.OK == jfaults.OK


def test_trace_faults_replay_the_committed_file():
    mine, ref = faults.TraceFault(TRACE, 5.0), jfaults.TraceFault(TRACE, 5.0)
    grid = [(n, r) for n in range(6) for r in range(8)]
    assert all(same_effect(mine(n, r), ref(n, r)) for n, r in grid)
    assert mine(2, 7) == (-5.0, False, 1.0) and mine(0, 1) == (1.0, True, 1.0)
    assert math.isnan(mine(3, 4)[0]) and mine(1, 0) == faults.OK


def test_fault_registry_and_spec_validation():
    spec = SimpleNamespace(fault_model="sign_flip", fault_rate=0.2,
                           fault_seed=2, fault_scale=5.0, fault_trace=None,
                           schedule="sync", round_deadline=None)
    faults.validate_spec(spec)
    model = faults.make_model(spec)
    assert sorted(faults.FAULTS) == sorted(jfaults.FAULTS)
    # the sign-flip seed BENCH_robust.json records: 4 of 20 nodes hostile
    assert sum(model.hits(n, 0) for n in range(20)) == 4
    for bad in (dict(fault_rate=0.0), dict(fault_scale=0.0),
                dict(fault_model="comet"), dict(fault_trace=TRACE)):
        with pytest.raises(ValueError):
            faults.validate_spec(SimpleNamespace(**{**vars(spec), **bad}))
    assert faults.make_model(SimpleNamespace(fault_model=None)) is None
