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


def _dev_c(rng, device, *shape):
    return torch.as_tensor(rand_c(rng, *shape)).to(device)


def _trace_agrees(a, b):
    got = ops.ensemble_commutator_trace(a, b)
    again = ops.ensemble_commutator_trace(a, b)
    torch.cuda.synchronize()
    want = ref.ensemble_commutator_trace_ref(a, b)
    assert got.shape == want.shape and got.dtype == torch.complex128
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max()), (tuple(a.shape), err)
    # partial traces summed in a fixed order, no atomics: same bits
    assert torch.equal(got, again), tuple(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("j,n,ea,eb,dk,dr", [
    (3, 4, 32, 16, 64, 8),     # widths (4,5,4) layer 1, J cut from 40
    (2, 4, 512, 1, 32, 16),    # widths (4,5,4) layer 2, J cut from 50
])
def test_trace_kernel_at_the_wide_shapes(cuda_device, j, n, ea, eb, dk, dr):
    rng = np.random.default_rng(ea + eb)
    build.reset_launches()
    _trace_agrees(_dev_c(rng, cuda_device, j, n, ea, dk, dr),
                  _dev_c(rng, cuda_device, j, n, eb, dk, dr))
    assert dict(build.LAUNCHES) == {"ensemble_commutator_trace": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("j,n,ea,eb,dk,dr", [
    (2, 2, 300, 3, 5, 3),      # a in row ranges, the last one short;
                               # dk*dr odd
    (3, 2, 77, 9, 6, 5),       # b in two chunks of 5 and 4 rows
    (1, 2, 2, 7, 8, 300),      # rows of 19,200 bytes: one a row a tile
    (2, 3, 300, 2, 4, 7),      # Eb > 1 with a split
    (70, 4, 300, 12, 4, 3),    # b's 12 rows padded to the register tile
                               # of 8, a in row ranges
    (70, 4, 20, 12, 4, 3),     # the same, one launch over n
    (1, 1, 1, 1, 1, 1),
])
def test_trace_kernel_on_ragged_plans(cuda_device, j, n, ea, eb, dk, dr):
    rng = np.random.default_rng(ea * eb + dk)
    _trace_agrees(_dev_c(rng, cuda_device, j, n, ea, dk, dr),
                  _dev_c(rng, cuda_device, j, n, eb, dk, dr))


@pytest.mark.cuda
@pytest.mark.parametrize("j,n,ea,eb,dk,dr,one_launch", [
    (30, 4, 32, 1, 8, 4, True),     # widths (2,3,2), layer 1
    (2, 3, 5, 3, 4, 3, True),
    (3, 4, 32, 16, 64, 8, False),   # widths (4,5,4), layer 1
    (2, 4, 512, 1, 32, 16, False),  # widths (4,5,4), layer 2
])
def test_trace_kernel_plans(cuda_device, j, n, ea, eb, dk, dr, one_launch):
    """Small shapes take one launch that sums over n in the block and
    writes T (no workspace); the wide ones write partial traces that a
    second kernel sums. Either way the kernel agrees with its plain
    version and repeats its bits."""
    parts = build.load().qf_ect_parts(j, n, ea, eb, dk, dr,
                                      torch.cuda.current_device())
    assert parts >= 0 and (parts == 0) == one_launch
    rng = np.random.default_rng(j * n + ea)
    _trace_agrees(_dev_c(rng, cuda_device, j, n, ea, dk, dr),
                  _dev_c(rng, cuda_device, j, n, eb, dk, dr))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 64, 64, 64), (3, 7, 9, 5),
                                   (2, 33, 17, 40), (1, 65, 64, 1)])
def test_zgemm_launches_on_the_current_stream(cuda_device, shape):
    """Launched inside torch.cuda.stream(side) behind a long sleep, with
    an operand written on that stream after the sleep: only a launch on
    the side stream reads it written. Synchronised on that stream only."""
    bsz, m, k, n = shape
    rng = np.random.default_rng(m * n)
    a = _dev_c(rng, cuda_device, bsz, m, k)
    b = _dev_c(rng, cuda_device, bsz, k, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        a1 = a + 1.0
        got = ops.complex_matmul(a1, b)
    side.synchronize()
    want = ref.zgemm_ref(a + 1.0, b)
    assert got.shape == (bsz, m, n)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


def _wrapper_operands(device):
    """Each of the seven wrappers with good operands (keyword arguments
    last)."""
    from repro_torch.kernels import fidelity as kfid
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.kernels import zgemm as kz
    rng = np.random.default_rng(12)

    def c(*shape):
        return _dev_c(rng, device, *shape)

    def f(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(device)
    return {"zgemm": (kz.zgemm, [c(2, 4, 4), c(2, 4, 4)], {}),
            "ensemble_commutator_trace": (kz.ensemble_commutator_trace,
                                          [c(2, 2, 3, 4, 2),
                                           c(2, 2, 2, 4, 2)], {}),
            "fidelity": (kfid.fidelity_batch, [c(3, 4), c(3, 4, 4)], {}),
            "mse": (kfid.mse_batch, [c(3, 4), c(3, 4, 4)], {}),
            "flash_attention": (kfa.flash_attention,
                                [f(2, 16, 64), f(2, 16, 64), f(2, 16, 64)],
                                {}),
            "rglru_scan": (krg.rglru_scan, [f(2, 16, 8), f(2, 16, 8)], {}),
            "gla_chunked": (kgla.gla_chunked,
                            [f(1, 16, 2, 8), f(1, 16, 2, 8), f(1, 16, 2, 8),
                             torch.sigmoid(f(1, 16, 2, 8)), f(2, 8)],
                            {"chunk": 16})}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["zgemm", "ensemble_commutator_trace",
                                    "fidelity", "mse", "flash_attention",
                                    "rglru_scan", "gla_chunked"])
def test_wrappers_refuse_views_layouts_dtypes_and_cpu(cuda_device, kernel):
    """Called directly (not through ``ops``), every wrapper refuses a
    lazy conjugate view, a lazy negative view, a non-contiguous tensor, a
    wrong dtype and a tensor on the CPU, and launches nothing; the same
    call with good operands launches once."""
    fn, args, kw = _wrapper_operands(cuda_device)[kernel]
    x = args[0]
    wrong = torch.float64 if not x.is_complex() else torch.complex64
    bad = {"conj": (x if x.is_complex() else torch.complex(x, x)).conj(),
           "neg": torch._neg_view(x),
           "strided": x.transpose(-1, -2),
           "dtype": x.to(wrong),
           "cpu": x.cpu()}
    build.reset_launches()
    for what, y in bad.items():
        with pytest.raises(ValueError):
            fn(y, *args[1:], **kw)
        assert not build.LAUNCHES, what
    fn(*args, **kw)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {kernel: 1}


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


# The bf16 kernel against the fp32 function, element by element. Both
# outputs are one bf16 rounding of fp32 values that differ by the order of
# the sums and by P's split (2^-17 of each term |p v|, against 2^-8 for P
# rounded to bf16 alone). So each element is within one bf16 ulp of the
# plain one, plus 2^-15 of a = (P |V|) / l, the size of the terms summed
# into it: an element near 0 by cancellation meets only the second term.
# Only elements whose two fp32 values straddle a bf16 rounding boundary
# differ at all. On an H100, in these cases: 0.06-0.19% of the elements
# differ, and the largest excess over one ulp is 1.3e-6 a, 24x inside the
# bound; with P rounded to bf16 alone 10.6-34.6% differ and the excess
# reaches 1.7e-3-2.4e-3 a, 57-79x outside it.
ATTN_TERM_TOL = 2.0 ** -15
ATTN_SHARE_DIFFERING = 0.01
ATTN_CASES = [(6, 3, 70, 70, 64, 0), (6, 3, 70, 70, 64, 20),
              (4, 4, 33, 100, 128, 0), (4, 2, 100, 33, 64, 7),
              (20, 2, 130, 130, 256, 50)]


def bf16_ulp(x):
    """Spacing of bf16 at |x| (0 at 0): 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    mant, exp = torch.frexp(x.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
def test_bf16_attention_within_one_ulp_of_the_fp32_function(cuda_device,
                                                            case):
    """(bh, bk, sq, sk, dh, window), causal: dh 64/128/256, GQA up to
    10:1, Sq != Sk, windows below the 64-key tile, and (4, 2, 100, 33,
    64, 7) with rows that have no allowed key (exactly 0 in both)."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh, window = case
    gen = torch.Generator().manual_seed(sum(case))
    q, k, v = _attn_case(gen, bh, bk, sq, sk, dh, torch.bfloat16, cuda_device)
    got = kfa.flash_attention(q, k, v, causal=True, window=window).float()
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=True, window=window).float()
    terms = ref.attention_ref(q.float(), k.float(), v.float().abs(),
                              causal=True, window=window)
    excess = ((got - want).abs() - bf16_ulp(want)).clamp_min(0)
    worst = float((excess - ATTN_TERM_TOL * terms).max())
    share = float((got != want).float().mean())
    print(f"{case}: differing {share:.4%}, excess over one ulp "
          f"{float((excess / terms.clamp_min(1e-30)).max()):.3e} of a")
    assert worst <= 0.0, case
    assert share <= ATTN_SHARE_DIFFERING, case


@pytest.mark.cuda
def test_bf16_attention_runs_on_the_tensor_cores(cuda_device):
    """The built bf16 kernels (dh 64, 128, 256) issue wgmma: HGMMA in
    their machine code. A kernel back on the CUDA cores has none."""
    from repro_torch.kernels import flash_attention as kfa
    code = {name: text for name, text in build.sass().items()
            if "flash_wgmma_kernel" in name}
    assert len(code) == 3
    assert all("HGMMA" in text for text in code.values())
    assert kfa.bf16_design() == "wgmma"


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


# ---------------------------------------------------------------- gla
BF16_ULP = 2.0 ** -7   # one bf16 rounding of the same fp32 value


def _gla_case(gen, b, s, h, dh, dtype, device, w_ends=False,
              w_dtype=torch.float32):
    def r(*shape):
        return 0.5 * torch.randn(shape, generator=gen)
    w = torch.sigmoid(torch.randn((b, s, h, dh), generator=gen)) * 0.5 + 0.45
    if w_ends:   # the RWKV6 clip's ends, exp(-e^4) and exp(-e^-12)
        ends = torch.tensor([1.9e-24, 1.0 - 6.1e-6])
        w = ends[torch.randint(0, 2, w.shape, generator=gen)]
    return ([x.to(device, dtype) for x in (r(b, s, h, dh), r(b, s, h, dh),
                                           r(b, s, h, dh))]
            + [w.to(device, w_dtype), r(h, dh).to(device)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_kernel_agrees_and_counts(cuda_device, dtype):
    """out and the final state against the plain chunked version: fp32
    at 1e-5 of the scale, bf16 outputs within one bf16 ulp of it."""
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(8)
    # (b, s, h, dh, chunk, w at the clip's ends, w dtype): the model's
    # chunk 16 and chunk 1, a chunk of the whole sequence (64), one above
    # the kernel's 64 (run as two sub-chunks), S = 1, dh 8, odd H
    cases = [(2, 48, 3, 64, 16, False, torch.float32),
             (1, 17, 3, 8, 1, False, torch.float32),
             (2, 1, 5, 64, 1, False, torch.float32),
             (1, 64, 2, 64, 64, True, torch.float32),
             (1, 128, 2, 32, 128, False, torch.float32),
             (2, 32, 3, 64, 16, False, torch.bfloat16)]
    build.reset_launches()
    for b, s, h, dh, chunk, ends, w_dtype in cases:
        args = _gla_case(gen, b, s, h, dh, dtype, cuda_device, ends, w_dtype)
        out, state = kgla.gla_chunked(*args, chunk=chunk)
        torch.cuda.synchronize()
        want, want_state = ref.gla_chunked_ref(*args, chunk)
        assert out.dtype == dtype and out.shape == (b, s, h, dh)
        assert state.dtype == torch.float32 and state.shape == (b, h, dh, dh)
        tol = BF16_ULP if dtype == torch.bfloat16 else RTOL
        scale = float(want.float().abs().max())
        err = float((out.float() - want.float()).abs().max())
        assert err <= tol * scale, (b, s, h, dh, chunk, err, scale)
        s_scale = max(float(want_state.abs().max()), 1e-30)
        assert float((state - want_state).abs().max()) <= RTOL * s_scale
    assert dict(build.LAUNCHES) == {"gla_chunked": len(cases)}


@pytest.mark.cuda
def test_gla_wrapper_refuses_bad_operands(cuda_device):
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(9)
    r, k, v, w, u = _gla_case(gen, 1, 16, 2, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kgla.gla_chunked(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu(),
                         chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        kgla.gla_chunked(r.transpose(1, 2), k, v, w, u, chunk=16)
    with pytest.raises(ValueError):
        kgla.gla_chunked(r, k.bfloat16(), v, w, u, chunk=16)
    with pytest.raises(ValueError):
        kgla.gla_chunked(r, k, v, w, u.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kgla.gla_chunked(r.double(), k.double(), v.double(), w, u, chunk=16)
    with pytest.raises(ValueError, match="divide"):
        kgla.gla_chunked(r, k, v, w, u, chunk=5)
    with pytest.raises(ValueError):
        kgla.gla_chunked(r[:, :8].contiguous(), k, v, w, u, chunk=8)
    big = [torch.zeros((1, 4, 1, 128), device=cuda_device)] * 4
    with pytest.raises(ValueError, match="head_dim"):
        kgla.gla_chunked(*big, torch.zeros((1, 128), device=cuda_device),
                         chunk=4)
    # ops makes a strided operand dense and u fp32 before the launch
    out, _ = ops.gla_chunked(r.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, w, u.bfloat16(), chunk=16)
    want, _ = ref.gla_chunked_ref(r, k, v, w, u.bfloat16(), 16)
    assert float((out - want).abs().max()) <= RTOL * float(want.abs().max())


def _rwkv_params(cfg, device):
    """The reduced RWKV6 model with its zero-initialised decay, bonus and
    mixing tensors redrawn, so that w spans the clip's range."""
    from repro_torch.models import Model
    params = Model(cfg).init(seed=0, device=device)
    gen = torch.Generator().manual_seed(5)
    draws = {"w0": lambda s: torch.rand(s, generator=gen) * 18 - 13,
             "w_lora_b": lambda s: 0.1 * torch.randn(s, generator=gen),
             "ts_lora_b": lambda s: 0.1 * torch.randn(s, generator=gen),
             "u": lambda s: 0.5 * torch.randn(s, generator=gen)}
    for key, val in params.items():
        name = key.rsplit("/", 1)[-1]
        if name in draws:
            val.copy_(draws[name](val.shape))
        elif name in ("mu", "mu_base", "mu_k", "mu_r"):
            val.copy_(torch.rand(val.shape, generator=gen))
    return params


@pytest.mark.cuda
def test_rwkv_layer_hands_w_to_the_kernel_in_fp32(cuda_device, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.models import Model
    cfg = get_config("rwkv6-7b").reduced(dtype="bfloat16",
                                         param_dtype="bfloat16")
    params = _rwkv_params(cfg, cuda_device)
    seen, orig = [], ops.gla_chunked

    def recording(r, k, v, w, u, **kw):
        seen.append((r.dtype, w.dtype, float(w.min()), float(w.max())))
        return orig(r, k, v, w, u, **kw)
    monkeypatch.setattr(ops, "gla_chunked", recording)
    batch = concrete_batch(cfg, 2, 64, torch.Generator().manual_seed(1),
                           kind="prefill", device=cuda_device)
    build.reset_launches()
    Model(cfg).prefill(params, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"gla_chunked": cfg.n_layers}
    assert len(seen) == cfg.n_layers
    for r_dtype, w_dtype, w_min, w_max in seen:
        assert (r_dtype, w_dtype) == (torch.bfloat16, torch.float32)
        assert w_min < 1e-3 and w_max > 0.999


@pytest.mark.cuda
def test_rwkv_prefill_with_kernels_matches_plain(cuda_device):
    """RWKV6 reduced (fp32), the redrawn params: one prefill through the
    kernel and one through its plain version, with S a multiple of the
    chunk and not (the chunk-1 path). The whole-model gate of
    tests/test_torch_rwkv.py."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.models import Model
    cfg = get_config("rwkv6-7b").reduced()
    params = _rwkv_params(cfg, cuda_device)
    for s in (96, 37):
        batch = concrete_batch(cfg, 2, s, torch.Generator().manual_seed(1),
                               kind="prefill", device=cuda_device)
        build.reset_launches()
        got, cache = Model(cfg).prefill(params, batch)
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"gla_chunked": cfg.n_layers}
        want, want_cache = Model(cfg, impl="xla").prefill(params, batch)
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
        for key in want_cache:
            w = want_cache[key]
            assert float((cache[key] - w).abs().max()) <= 1e-4 * float(
                w.abs().max()), key
