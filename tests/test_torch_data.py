"""The port's data, participation, strategy, channel and conversion
modules against the JAX reference (x64) where both compute the same
function from the same arrays, and against their invariants where the
port draws its own randomness."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.fed import participation as jpart  # noqa: E402
from repro.core.fed import strategies as jstrat  # noqa: E402
from repro.core.quantum import data as jdata  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import qnn_232  # noqa: E402
from repro_torch.core.fed import channel, participation, strategies  # noqa: E402
from repro_torch.core.quantum import data as qdata  # noqa: E402


def rand_pairs(rng, n=12, d=4):
    """(phi, U phi) for a random unitary U, seeded numpy."""
    u = np.linalg.qr(rng.standard_normal((d, d))
                     + 1j * rng.standard_normal((d, d)))[0]
    phi = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    return u, phi, phi @ u.T


@pytest.mark.parametrize("node_sizes", [None, (3, 4, 2, 3)])
def test_partition_non_iid_matches_reference(x64, node_sizes):
    _, phi_in, phi_out = rand_pairs(np.random.default_rng(1))
    want = jdata.partition_non_iid(jnp.asarray(phi_in), jnp.asarray(phi_out),
                                   4, node_sizes)
    got = qdata.partition_non_iid(convert.states_to_torch(phi_in, "cpu"),
                                  convert.states_to_torch(phi_out, "cpu"), 4,
                                  node_sizes)
    assert np.array_equal(got.phi_in.numpy(), np.asarray(want.phi_in))
    assert np.array_equal(got.phi_out.numpy(), np.asarray(want.phi_out))
    assert np.array_equal(got.node_counts().numpy(),
                          np.asarray(want.node_counts()))
    if node_sizes is None:
        assert got.n_per is None and got.valid_mask() is None
    else:
        assert np.array_equal(got.valid_mask().numpy(),
                              np.asarray(want.valid_mask()))
        assert got.valid_mask().dtype == torch.float32


def test_make_pairs_applies_the_target(x64):
    u = convert.states_to_torch(rand_pairs(np.random.default_rng(4))[0],
                                "cpu")
    phi_in, phi_out = qdata.make_pairs(torch.Generator().manual_seed(5), u,
                                       6, 2)
    want = jnp.einsum("ab,xb->xa", jnp.asarray(u.numpy()),
                      jnp.asarray(phi_in.numpy()))
    assert float(np.max(np.abs(phi_out.numpy() - np.asarray(want)))) <= 1e-12


@pytest.mark.parametrize("iid", [False, True])
def test_make_federated_dataset_is_seeded_and_consistent(iid):
    def make():
        return qdata.make_federated_dataset(
            torch.Generator().manual_seed(3), 2, num_nodes=5, n_per_node=4,
            iid=iid, n_test=6, device="cpu")
    u, ds, (t_in, t_out) = make()
    u2, ds2, _ = make()
    assert torch.equal(u, u2) and torch.equal(ds.phi_in, ds2.phi_in)
    assert ds.phi_in.shape == ds.phi_out.shape == (5, 4, 4)
    assert t_in.shape == (6, 4)
    assert float((ds.phi_out - ds.phi_in @ u.T).abs().max()) <= 1e-12
    assert float((t_out - t_in @ u.T).abs().max()) <= 1e-12
    norms = torch.linalg.vector_norm(ds.phi_in, dim=-1)
    assert float((norms - 1).abs().max()) <= 1e-12


def test_unequal_node_sizes_pad_and_count():
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(1), 2, num_nodes=0, n_per_node=0,
        node_sizes=[2, 5, 1], n_test=2, device="cpu")
    assert ds.phi_in.shape == (3, 5, 4)
    assert ds.node_counts().tolist() == [2.0, 5.0, 1.0]
    assert ds.valid_mask().sum(1).tolist() == [2.0, 5.0, 1.0]
    assert float(ds.phi_in[0, 2:].abs().max()) == 0.0


def test_participation():
    sel, mask = participation.sample_nodes(torch.Generator().manual_seed(0),
                                           100, 10, device="cpu")
    assert len(set(sel.tolist())) == 10 and 0 <= int(sel.min())
    assert int(sel.max()) < 100 and mask.dtype == torch.float32
    sel_f, _ = participation.sample_nodes(None, 4, 4, schedule="full",
                                          device="cpu")
    assert sel_f.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        participation.sample_nodes(None, 5, 4, schedule="full", device="cpu")
    with pytest.raises(ValueError):
        participation.validate("stratified")
    sizes = np.array([3.0, 4.0, 2.0, 4.0], np.float32)
    m = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    got = participation.round_weights("uniform", torch.tensor(sizes),
                                      torch.tensor(m))
    want = jpart.round_weights("uniform", jnp.asarray(sizes), jnp.asarray(m))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["product", "average", "served"])
def test_wire_cast_matches_reference(x64, name):
    rng = np.random.default_rng(0)
    ks = [rng.standard_normal((2, 3, 4, 4)) + 1j * rng.standard_normal(
        (2, 3, 4, 4)), rng.standard_normal((5,))]
    want = jstrat.wire_cast([jnp.asarray(k) for k in ks],
                            jstrat.get_aggregation(name))
    got = strategies.wire_cast([torch.tensor(k) for k in ks],
                               strategies.get_aggregation(name))
    for g, w in zip(got, want):
        assert np.array_equal(g.float().numpy() if g.dtype == torch.bfloat16
                              else g.numpy(), np.asarray(w, np.float32)
                              if w.dtype == jnp.bfloat16 else np.asarray(w))
    with pytest.raises(ValueError):
        strategies.get_aggregation("median")


def test_channel_identity_and_refusals():
    ks = [torch.ones(2, 2)]
    assert channel.resolve_channel()(None, ks) is ks
    assert isinstance(channel.resolve_channel(upload_noise=0.1),
                      channel.HermitianNoiseChannel)
    assert isinstance(channel.resolve_channel(quantize_bits=8),
                      channel.QuantizationChannel)
    for kw in (dict(upload_noise=0.1, quantize_bits=8),
               dict(quantize_bits=1), dict(quantize_bits=17)):
        with pytest.raises(ValueError):
            channel.resolve_channel(**kw)


def test_convert_round_trip_and_config():
    rng = np.random.default_rng(2)
    params = [rng.standard_normal((3, 8, 8)) + 1j * rng.standard_normal(
        (3, 8, 8))]
    back = convert.params_to_numpy(convert.params_to_torch(params, "cpu"))
    assert np.array_equal(back[0], params[0])
    phi = rng.standard_normal((4, 2, 4)) + 0j
    ds = convert.dataset_to_torch(phi, phi, np.array([2, 1, 2, 2]), "cpu")
    p_in, p_out, n_per = convert.dataset_to_numpy(ds)
    assert np.array_equal(p_in, phi) and n_per.tolist() == [2, 1, 2, 2]
    assert ds.n_per.dtype == torch.int32
    assert qnn_232.CONFIG.widths == qnn_232.WIDTHS == (2, 3, 2)
    assert (qnn_232.N_PER_NODE, qnn_232.N_TEST,
            qnn_232.N_ITERATIONS) == (4, 32, 50)
