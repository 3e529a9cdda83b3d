"""The port on the card: each kernel launches, counts its launch and
agrees with its plain version, and a kernel round agrees with a
complex128 round. Every test here needs a CUDA device (``cuda`` marker)
and skips without one. This file imports neither JAX nor the reference,
so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantum import data as qdata  # noqa: E402
from repro_torch.core.quantum import federated as fed  # noqa: E402
from repro_torch.core.quantum import qnn  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

RTOL = 1e-5   # fp32 kernels against their fp32 plain versions / complex128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.cuda
def test_kernels_launch_count_and_agree(cuda_device):
    rng = np.random.default_rng(2)

    def dev(x):
        return torch.as_tensor(x).to(cuda_device)

    a, b = dev(rand_c(rng, 3, 7, 9)), dev(rand_c(rng, 3, 9, 5))
    phi = rand_c(rng, 13, 4)
    phi = dev(phi / np.linalg.norm(phi, axis=-1, keepdims=True))
    rho = dev(rand_c(rng, 13, 4, 4))
    ea, eb = dev(rand_c(rng, 2, 2, 5, 4, 3)), dev(rand_c(rng, 2, 2, 3, 4, 3))
    build.reset_launches()
    # b.conj() is a lazy view: the kernel must see conjugated values
    cases = [("zgemm", ops.complex_matmul, ref.zgemm_ref, (a, b)),
             ("zgemm", ops.complex_matmul, ref.zgemm_ref, (a, b.conj())),
             ("fidelity", ops.fidelity, ref.fidelity_ref, (phi, rho)),
             ("mse", ops.mse, ref.mse_ref, (phi, rho)),
             ("ensemble_commutator_trace", ops.ensemble_commutator_trace,
              ref.ensemble_commutator_trace_ref, (ea, eb))]
    for name, op, plain, args in cases:
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RTOL * scale, name
    assert dict(build.LAUNCHES) == {"zgemm": 2, "fidelity": 1, "mse": 1,
                                    "ensemble_commutator_trace": 1}


@pytest.mark.cuda
def test_kernel_round_matches_complex128_round(cuda_device):
    widths = (2, 3, 2)
    _, ds, test = qdata.make_federated_dataset(
        torch.Generator().manual_seed(1), 2, num_nodes=6, n_per_node=3,
        n_test=5, device=cuda_device)
    params = qnn.init_params(torch.Generator().manual_seed(2), widths,
                             device=cuda_device)
    out = {}
    for impl in ("xla", "pallas"):
        cfg = fed.QuantumFedConfig(widths=widths, num_nodes=6,
                                   nodes_per_round=4, interval_length=2,
                                   eps=0.05, impl=impl)
        p = fed.server_round(params, ds, torch.Generator().manual_seed(3),
                             cfg)
        out[impl] = (p, fed.evaluate(p, *test, widths, impl=impl))
    dev = max(float((a - b).abs().max())
              for a, b in zip(out["xla"][0], out["pallas"][0]))
    assert dev <= RTOL
    for k in ("fidelity", "mse"):
        assert abs(float(out["xla"][1][k]) - float(out["pallas"][1][k])) <= RTOL
