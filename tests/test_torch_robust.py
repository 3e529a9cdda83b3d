"""The port's defended and server-momentum rounds against the JAX
reference, under injected faults (x64, widths (2,3,2), N=6, N_p=5,
I_l=2).

The reference applies faults in its API's sync scheduler
(``SyncScheduler._robust_step``) and aggregates through
``QuantumSubstrate.aggregate``; both sides here compose their own phases
the same way (``faulted_round`` / ``ref_faulted_round``), with the
reference's selection injected into the port and each package's own
fault model (the draws are numpy's on both sides). The port's side
applies the faults through its own scheduler's code
(``scheduler.fault_effects`` / ``apply_effects``, what
``_robust_step`` runs). impl="xla" agrees with the reference's
complex128 round to <= 1e-10, impl="pallas" (the kernels' fp32 plain
versions here) to <= 1e-5."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import faults as jfaults  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fed import api, faults  # noqa: E402
from repro_torch.core.fed.api import scheduler  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402

TOLS = {"xla": 1e-10, "pallas": 1e-5}
WIDTHS = (2, 3, 2)
ROUND_KEY = jax.random.PRNGKey(5)
N, N_P = 6, 5

STRATEGIES = {
    "none_avg": dict(aggregation="average"),
    "none_prod": dict(aggregation="product"),
    "clip": dict(aggregation="average", defense="clip", clip_norm=0.5),
    "trimmed_mean": dict(aggregation="average", defense="trimmed_mean",
                         trim_frac=0.3),
    "median": dict(aggregation="average", defense="median"),
    "screen": dict(aggregation="product", defense="screen",
                   screen_tol=0.005),
}
# kind, rate, seed: each marks at least one selected node at round 0
ATTACKS = {"clean": None, "sign_flip": ("sign_flip", 0.3, 1),
           "crash": ("crash", 0.3, 4)}


def configs(**kw):
    base = dict(widths=WIDTHS, num_nodes=N, nodes_per_round=N_P,
                interval_length=2, eps=0.1, **kw)
    return jfed.QuantumFedConfig(**base), fed.QuantumFedConfig(**base)


def rand_states(rng, n, d):
    x = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rand_unitaries(rng, m, d):
    z = rng.standard_normal((m, d, d)) + 1j * rng.standard_normal((m, d, d))
    return np.linalg.qr(z)[0]


@functools.lru_cache(maxsize=None)
def setup():
    """Seeded numpy data and params in both packages (every caller runs
    x64): pairs (phi, U phi) split non-iid over 6 nodes of 3, 8 test
    pairs (the screen's probe), and the reference's selection."""
    rng = np.random.default_rng(17)
    u = rand_unitaries(rng, 1, 4)[0]
    phi_in = rand_states(rng, 3 * N, 4)
    ds = jdata.partition_non_iid(jnp.asarray(phi_in),
                                 jnp.asarray(phi_in @ u.T), N)
    t_in = rand_states(rng, 8, 4)
    test = (jnp.asarray(t_in), jnp.asarray(t_in @ u.T))
    params = [jnp.asarray(rand_unitaries(rng, 3, 8)),
              jnp.asarray(rand_unitaries(rng, 2, 16))]
    jcfg, _ = configs()
    k_sel = jax.random.split(ROUND_KEY, 3)[0]
    sel, _, weights = jfed.select_phase(ds, k_sel, jcfg)
    tds = convert.dataset_to_torch(np.asarray(ds.phi_in),
                                   np.asarray(ds.phi_out), None, "cpu")
    tparams = convert.params_to_torch([np.asarray(p) for p in params], "cpu")
    ttest = tuple(convert.states_to_torch(np.asarray(x), "cpu") for x in test)
    return ((params, ds, test, sel, weights),
            (tparams, tds, ttest, torch.tensor(np.asarray(sel)),
             torch.tensor(np.asarray(weights))))


def effects(sel, mask, base_w, model, r):
    """The reference's fault effects (``SyncScheduler._robust_step``) on
    one cohort: (coefficients, survivors, renormalised weights)."""
    coeff = np.ones(len(sel))
    survive = np.asarray(mask) > 0.0
    for i, node in enumerate(sel):
        if not survive[i] or model is None:
            continue
        c, drop, _ = model(int(node), r)
        if drop:
            survive[i] = False
            continue
        coeff[i] = c
    w = np.asarray(base_w, np.float64) * survive
    return coeff, survive, w / max(w.sum(), 1e-12)


def faulted_round(params, dataset, sel, weights, cfg, model, r, *,
                  smom=None, server_opt="none", probe=None):
    """One synchronous round of the port under a fault model, with the
    selection given: the port's phases, and the fault effects applied by
    its sync scheduler's own code."""
    ks = fed.local_phase(params, dataset, sel, torch.Generator(), cfg)
    ks = fed.transmit_phase(ks, torch.Generator(), cfg)
    coeff, survive = scheduler.fault_effects(sel.tolist(), np.ones(len(sel)),
                                             model, r)
    ks, w = scheduler.apply_effects(ks, weights.numpy(), coeff, survive,
                                    model is not None)
    return fed.aggregate_phase(params, ks, w, cfg, smom=smom,
                               server_opt=server_opt, server_beta=0.9,
                               probe=probe)


def ref_faulted_round(params, ds, sel, weights, jcfg, model, r, *,
                      smom=None, server_opt="none", probe=None):
    """``faulted_round`` in the reference (its own phases and faults)."""
    ks = jfed.local_phase(params, ds, sel, ROUND_KEY,
                          jcfg._replace(defense=None))
    ks = jfed.transmit_phase(ks, ROUND_KEY, jcfg)
    coeff, survive, w = effects(np.asarray(sel).tolist(), np.ones(len(sel)),
                                np.asarray(weights), model, r)
    if model is not None and bool(np.any(coeff != 1.0)):
        cv = np.where(survive, coeff, 0.0)
        ks = [(x * jnp.asarray(cv, x.real.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1))).astype(x.dtype) for x in ks]
    return jfed.aggregate_phase(params, ks, jnp.asarray(w, jnp.float32),
                                jcfg, smom=smom, server_opt=server_opt,
                                server_beta=0.9, probe=probe)


def models(attack):
    if ATTACKS[attack] is None:
        return None, None
    kind, rate, seed = ATTACKS[attack]
    return (faults.DrawFault(kind, rate, seed, 5.0),
            jfaults.DrawFault(kind, rate, seed, 5.0))


def max_err(xs, ys):
    return max(float(np.max(np.abs(x.resolve_conj().numpy() - np.asarray(y))))
               for x, y in zip(xs, ys))


@functools.lru_cache(maxsize=None)
def reference_round(strategy, attack):
    jcfg, _ = configs(**STRATEGIES[strategy])
    (params, ds, test, sel, weights), _ = setup()
    probe = test if strategy == "screen" else None
    out, _ = ref_faulted_round(params, ds, sel, weights, jcfg,
                               models(attack)[1], 0, probe=probe)
    return [np.asarray(p) for p in out]


def test_attacks_hit_the_selection(x64):
    _, (_, _, _, tsel, _) = setup()
    for attack in ("sign_flip", "crash"):
        model = models(attack)[0]
        assert any(model.hits(int(n), 0) for n in tsel), attack


@pytest.mark.parametrize("attack", sorted(ATTACKS))
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_defended_round_matches_reference(x64, strategy, attack):
    _, tcfg = configs(**STRATEGIES[strategy])
    _, (tparams, tds, ttest, tsel, tweights) = setup()
    probe = ttest if strategy == "screen" else None
    got, smom = faulted_round(tparams, tds, tsel, tweights, tcfg,
                              models(attack)[0], 0, probe=probe)
    assert smom is None
    assert max_err(got, reference_round(strategy, attack)) <= TOLS["xla"]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_defended_kernel_round_matches_reference(x64, strategy):
    _, tcfg = configs(impl="pallas", **STRATEGIES[strategy])
    _, (tparams, tds, ttest, tsel, tweights) = setup()
    probe = ttest if strategy == "screen" else None
    got, _ = faulted_round(tparams, tds, tsel, tweights, tcfg,
                           models("sign_flip")[0], 0, probe=probe)
    assert max_err(got, reference_round(strategy, "sign_flip")) <= TOLS[
        "pallas"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("server_opt", ["momentum", "nesterov"])
def test_server_momentum_rounds_match_reference(x64, server_opt, impl):
    """Two rounds carrying the momentum state, from the zero state."""
    jcfg, tcfg = configs(aggregation="average", impl=impl)
    jcfg = jcfg._replace(impl="xla")
    (params, ds, _, sel, weights), (tparams, tds, _, tsel, tweights) = setup()
    smom, tsmom = None, None
    for r in range(2):
        params, smom = ref_faulted_round(params, ds, sel, weights, jcfg, None,
                                         r, smom=smom, server_opt=server_opt)
        tparams, tsmom = faulted_round(tparams, tds, tsel, tweights, tcfg,
                                       None, r, smom=tsmom,
                                       server_opt=server_opt)
        assert max_err(tparams, params) <= TOLS[impl]
        # the momentum is a generator, held at the tolerance of its scale
        scale = max(1.0, max(float(np.abs(np.asarray(m)).max()) for m in smom))
        assert max_err(tsmom, smom) <= TOLS[impl] * scale
        assert [tuple(m.shape) for m in tsmom] == [(2,) + tuple(p.shape)
                                                  for p in tparams]


def test_screen_quarantines_a_corrupt_node(x64):
    _, tcfg = configs(**STRATEGIES["screen"])
    _, (tparams, tds, ttest, tsel, tweights) = setup()
    model = faults.DrawFault("corrupt", 0.3, 2, 5.0)
    bad = [model.hits(int(n), 0) for n in tsel]
    assert any(bad) and not all(bad)
    ks = fed.local_phase(tparams, tds, tsel, torch.Generator(), tcfg)
    coeff = torch.tensor([model(int(n), 0)[0] for n in tsel])
    ks = [k * coeff.reshape(-1, 1, 1, 1, 1) for k in ks]
    _, w, keep = fed._screen_uploads(
        [p[None] for p in tparams], [k[None] for k in ks], tweights[None],
        tcfg.eps, tcfg, tuple(x[None] for x in ttest))
    assert not any(k and b for k, b in zip(keep[0].tolist(), bad))
    assert float(w[0][torch.tensor(bad)].abs().max()) == 0.0
    got, _ = faulted_round(tparams, tds, tsel, tweights, tcfg, model, 0,
                           probe=ttest)
    assert all(bool(torch.isfinite(p.abs()).all()) for p in got)
    jcfg, _ = configs(**STRATEGIES["screen"])
    (params, ds, test, sel, weights), _ = setup()
    want, _ = ref_faulted_round(params, ds, sel, weights, jcfg,
                                jfaults.DrawFault("corrupt", 0.3, 2, 5.0), 0,
                                probe=test)
    assert max_err(got, want) <= TOLS["xla"]


@pytest.mark.parametrize("aggregation", ["average", "product"])
def test_undefended_corrupt_round_goes_nan_and_does_not_raise(x64,
                                                              aggregation):
    _, tcfg = configs(aggregation=aggregation)
    _, (tparams, tds, ttest, tsel, tweights) = setup()
    model = faults.DrawFault("corrupt", 0.3, 2, 5.0)
    got, _ = faulted_round(tparams, tds, tsel, tweights, tcfg, model, 0)
    assert any(bool(torch.isnan(p.abs()).any()) for p in got)
    res = fed.evaluate(got, *ttest, WIDTHS)
    assert not np.isfinite(float(res["fidelity"]))
    defended = configs(aggregation="average", defense="median")[1]
    good, _ = faulted_round(tparams, tds, tsel, tweights, defended, model, 0)
    assert np.isfinite(float(fed.evaluate(good, *ttest, WIDTHS)["fidelity"]))


def test_faulted_round_fails_loudly_below_min_participants(x64):
    """Every upload crashes: the sync scheduler retries ``max_retries``
    times, then fails loud; a screen without its probe batch is
    refused."""
    _, (tparams, tds, ttest, tsel, tweights) = setup()
    spec = api.FedSpec.quantum(widths=WIDTHS, num_nodes=N,
                               nodes_per_round=N_P, interval_length=2,
                               eps=0.1, aggregation="average",
                               fault_model="crash", fault_rate=1.0)
    sub = api.QuantumSubstrate(spec, dataset=tds, test=ttest, device="cpu")
    sess = api.FederationSession.create(spec, 0, substrate=sub,
                                        params=tparams)
    with pytest.raises(RuntimeError, match="min_participants"):
        sess.step()
    assert sess.round == 0
    with pytest.raises(ValueError, match="probe"):
        faulted_round(tparams, tds, tsel, tweights,
                      configs(**STRATEGIES["screen"])[1], None, 0)
