"""The port's stacked multi-tenant round (``server_round_stacked``): a
stack of S = 3 sessions, each with its own params, data, draws, eta, eps
and momentum, is S solo rounds (<= 1e-10, complex128), and the
reference's ``server_round_stacked`` (<= 1e-10, x64) with the
reference's selections injected; the kernels' plain versions within
1e-5 of it."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quantum import data as jdata  # noqa: E402
from repro.core.quantum import federated as jfed  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.quantum import data as qdata  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402
from repro_torch.core.quantum import qnn  # noqa: E402

TOL = 1e-10
WIDTHS = (2, 3, 2)
S = 3
ETA = [0.5, 1.0, 1.75]
EPS = [0.05, 0.1, 0.2]
BETA = [0.5, 0.9, 0.8]


def f64(xs):
    return torch.tensor(xs, dtype=torch.float64)


def stack(trees):
    return [torch.stack(xs) for xs in zip(*trees)]


def stack_ds(dss):
    return qdata.QuantumDataset(
        torch.stack([d.phi_in for d in dss]),
        torch.stack([d.phi_out for d in dss]),
        None if dss[0].n_per is None else torch.stack([d.n_per for d in dss]))


@functools.lru_cache(maxsize=None)
def sessions():
    """S port sessions on the CPU, each with its own seeded data and
    params: N = 5 nodes of 3 pairs."""
    out = []
    for s in range(S):
        _, ds, _ = qdata.make_federated_dataset(
            torch.Generator().manual_seed(10 + s), 2, 5, 3, n_test=4,
            device="cpu")
        out.append((qnn.init_params(torch.Generator().manual_seed(20 + s),
                                    WIDTHS, device="cpu"), ds))
    return out


def cfg_of(**kw):
    return fed.QuantumFedConfig(**{**dict(
        widths=WIDTHS, num_nodes=5, nodes_per_round=3, interval_length=2),
        **kw})


def max_dev(xs, ys):
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


@pytest.mark.parametrize("kw,server_opt", [
    (dict(aggregation="average"), "none"),
    (dict(aggregation="average"), "momentum"),
    (dict(aggregation="average", minibatch=2), "nesterov"),
    (dict(aggregation="product"), "none"),
    (dict(aggregation="product", participation="dropout",
          dropout_rate=0.4), "none"),
    (dict(aggregation="average", defense="median",
          participation_method="sampled"), "none"),
    (dict(aggregation="average", upload_noise=0.1), "none"),
    (dict(aggregation="average", quantize_bits=8, impl="pallas"),
     "momentum"),
])
def test_stack_of_three_is_three_solo_rounds(kw, server_opt):
    """Two rounds (the momentum carried), per-slot eta, eps and beta;
    session s draws from its own generator as its solo round does."""
    cfg = cfg_of(**kw)
    sess = sessions()
    params = stack([p for p, _ in sess])
    ds = stack_ds([d for _, d in sess])
    smom, solo = None, [(p, None) for p, _ in sess]
    gens = [torch.Generator().manual_seed(30 + s) for s in range(S)]
    solo_gens = [torch.Generator().manual_seed(30 + s) for s in range(S)]
    for _ in range(2):
        params, smom, err = fed.server_round_stacked(
            params, ds, gens, cfg, smom=smom, eta=f64(ETA), eps=f64(EPS),
            server_opt=server_opt, server_beta=f64(BETA))
        assert err.shape == (S,) and float(err.abs().max()) == 0.0
        solo = [fed.server_round_opt(
            p, m, sess[s][1], solo_gens[s],
            cfg._replace(eta=ETA[s], eps=EPS[s]), server_opt=server_opt,
            server_beta=BETA[s]) for s, (p, m) in enumerate(solo)]
        # the kernels' fp32 sums may run in another order in a larger batch
        tol = TOL if cfg.impl == "xla" else 1e-5
        for s, (p, m) in enumerate(solo):
            assert max_dev([x[s] for x in params], p) <= tol
            if server_opt == "none":
                assert smom is None and m is None
            else:
                assert max_dev([x[s] for x in smom], m) <= tol * max(
                    1.0, max(float(x.abs().max()) for x in m))


def test_stacked_screen_is_solo_screen():
    cfg = cfg_of(aggregation="product", defense="screen", screen_tol=0.01)
    sess = sessions()
    probes = [(d.phi_in[0], d.phi_out[0]) for _, d in sess]
    probe = tuple(torch.stack(x) for x in zip(*probes))
    params, _, _ = fed.server_round_stacked(
        stack([p for p, _ in sess]), stack_ds([d for _, d in sess]),
        [torch.Generator().manual_seed(s) for s in range(S)], cfg,
        eps=f64(EPS), probe=probe)
    for s, (p, d) in enumerate(sess):
        want, _ = fed.server_round_opt(
            p, None, d, torch.Generator().manual_seed(s),
            cfg._replace(eps=EPS[s]), probe=probes[s])
        assert max_dev([x[s] for x in params], want) <= TOL


def test_stacked_refusals():
    sess = sessions()
    params = stack([p for p, _ in sess])
    ds = stack_ds([d for _, d in sess])
    sels = torch.tensor([[0, 1, 2]] * S)
    with pytest.raises(ValueError, match="minibatch"):
        fed.server_round_stacked(params, ds, sels, cfg_of(minibatch=2))
    with pytest.raises(ValueError, match="sessions"):
        fed.server_round_stacked(params, ds, sels[:2], cfg_of())
    with pytest.raises(ValueError, match="server_opt"):
        fed.server_round_stacked(params, ds, sels, cfg_of(),
                                 server_opt="momentum")


def rand_states(rng, n, d):
    x = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def rand_unitaries(rng, m, d):
    z = rng.standard_normal((m, d, d)) + 1j * rng.standard_normal((m, d, d))
    return np.linalg.qr(z)[0]


@functools.lru_cache(maxsize=None)
def reference_stack(sizes):
    """S reference sessions (x64) from seeded numpy arrays, stacked."""
    rng = np.random.default_rng(41)
    dss, params = [], []
    for _ in range(S):
        u = rand_unitaries(rng, 1, 4)[0]
        n_total = 12 if sizes is None else sum(sizes)
        phi = rand_states(rng, n_total, 4)
        dss.append(jdata.partition_non_iid(jnp.asarray(phi),
                                           jnp.asarray(phi @ u.T), 4, sizes))
        params.append([rand_unitaries(rng, 3, 8), rand_unitaries(rng, 2, 16)])
    ds = jdata.QuantumDataset(
        jnp.stack([d.phi_in for d in dss]), jnp.stack([d.phi_out for d in dss]),
        None if sizes is None else jnp.stack([d.n_per for d in dss]))
    jparams = [jnp.asarray(np.stack(x)) for x in zip(*params)]
    return ds, jparams


@pytest.mark.parametrize("sizes,server_opt,impl", [
    (None, "none", "xla"), (None, "momentum", "xla"),
    ((2, 4, 3, 3), "nesterov", "xla"), (None, "momentum", "pallas")])
def test_stack_matches_reference_stacked_round(x64, sizes, server_opt,
                                               impl):
    ds, jparams = reference_stack(sizes)
    jcfg = jfed.QuantumFedConfig(widths=WIDTHS, num_nodes=4,
                                 nodes_per_round=3, interval_length=2,
                                 aggregation="average")
    keys = jax.random.split(jax.random.PRNGKey(8), S)
    # the reference's own selections, one per session, injected
    sels = np.stack([np.asarray(jfed.select_phase(
        jdata.QuantumDataset(ds.phi_in[s], ds.phi_out[s],
                             None if ds.n_per is None else ds.n_per[s]),
        jax.random.split(keys[s], 3)[0], jcfg)[0]) for s in range(S)])
    kw = dict(eta=jnp.asarray(ETA), eps=jnp.asarray(EPS),
              server_beta=jnp.asarray(BETA), server_opt=server_opt)
    tds = convert.dataset_to_torch(
        np.asarray(ds.phi_in), np.asarray(ds.phi_out),
        None if ds.n_per is None else np.asarray(ds.n_per), "cpu")
    tparams = convert.params_to_torch([np.asarray(p) for p in jparams], "cpu")
    tkw = {k: (torch.tensor(np.asarray(v)) if k != "server_opt" else v)
           for k, v in kw.items()}
    tcfg = fed.QuantumFedConfig(**{**jcfg._asdict(), "impl": impl})
    smom, tsmom = None, None
    for _ in range(2):
        jparams, smom, _ = jfed.server_round_stacked(jparams, ds, keys, jcfg,
                                                     smom=smom, **kw)
        tparams, tsmom, _ = fed.server_round_stacked(
            tparams, tds, torch.tensor(sels), tcfg,
            smom=convert.smom_to_torch(None if tsmom is None else
                                       convert.smom_to_numpy(tsmom), "cpu"),
            **tkw)
        tol = TOL if impl == "xla" else 1e-5
        assert max(float(np.abs(t.numpy() - np.asarray(j)).max())
                   for t, j in zip(tparams, jparams)) <= tol
        assert (tsmom is None) == (smom is None)
