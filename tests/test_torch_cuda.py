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


# ---------------------------------------------------------------- sequence
BF16_ATOL = 2e-2   # the reference's own bf16 gate (tests/test_kernels.py)


def _attn_case(gen, bh, bk, sq, sk, dh, dtype, device):
    def r(*shape):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
    return r(bh, sq, dh), r(bk, sk, dh), r(bk, sk, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_kernels_agree_and_count(cuda_device, dtype):
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rglru_scan as krg
    gen = torch.Generator().manual_seed(4)
    # (bh, bk, sq, sk, dh, window): GQA G = 1, 2, 10; Sq != Sk; S not a
    # multiple of the 64-row tile; window below the tile; dh 64/128/256
    cases = [(6, 3, 70, 70, 64, 0), (6, 3, 70, 70, 64, 20),
             (4, 4, 33, 100, 128, 0), (4, 2, 100, 33, 64, 7),
             (20, 2, 130, 130, 256, 50)]
    build.reset_launches()
    for bh, bk, sq, sk, dh, window in cases:
        q, k, v = _attn_case(gen, bh, bk, sq, sk, dh, dtype, cuda_device)
        got = kfa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=True, window=window)
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        tol = BF16_ATOL if dtype == torch.bfloat16 else RTOL
        assert err <= tol, (bh, bk, sq, sk, dh, window, err)
    a = torch.rand((3, 77, 300), generator=gen).to(cuda_device, dtype)
    b = torch.randn((3, 77, 300), generator=gen).to(cuda_device, dtype)
    got = krg.rglru_scan(a, b)
    torch.cuda.synchronize()
    want = ref.rglru_scan_ref(a, b)
    tol = 5e-2 if dtype == torch.bfloat16 else RTOL
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert dict(build.LAUNCHES) == {"flash_attention": len(cases),
                                    "rglru_scan": 1}


@pytest.mark.cuda
def test_sequence_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rglru_scan as krg
    x = torch.randn((2, 16, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(x.transpose(0, 1).contiguous().transpose(0, 1),
                            x, x)
    with pytest.raises(ValueError, match="head_dim"):
        kfa.flash_attention(x[..., :48].contiguous(), x[..., :48].contiguous(),
                            x[..., :48].contiguous())
    with pytest.raises(ValueError):
        kfa.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="contiguous"):
        krg.rglru_scan(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError):
        krg.rglru_scan(x.double(), x.double())
    # ops makes a transposed operand dense before the launch
    got = ops.lru_scan(x.transpose(1, 2), x.transpose(1, 2))
    want = ref.rglru_scan_ref(x.transpose(1, 2), x.transpose(1, 2))
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


@pytest.mark.cuda
def test_model_prefill_with_kernels_matches_plain(cuda_device):
    """RecurrentGemma reduced (fp32): one prefill through the kernels and
    one through their plain versions, same params. The whole-model gate
    of tests/test_torch_model.py (1e-3 of the logits' scale) covers the
    RG-LRU gate's amplification of fp32 rounding."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.models import Model
    cfg = get_config("recurrentgemma-2b").reduced()
    params = Model(cfg).init(seed=0, device=cuda_device)
    batch = concrete_batch(cfg, 2, 96, torch.Generator().manual_seed(1),
                           kind="prefill", device=cuda_device)
    build.reset_launches()
    got, cache = Model(cfg).prefill(params, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 1, "rglru_scan": 2}
    want, want_cache = Model(cfg, impl="xla").prefill(params, batch)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale
    for key in want_cache:
        w = want_cache[key]
        assert float((cache[key] - w).abs().max()) <= 1e-3 * float(
            w.abs().max()), key
