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


@pytest.mark.cuda
def test_session_round_launches_the_kernels(cuda_device, tmp_path):
    """One sync round and one evaluation through ``FederationSession`` on
    the card: the round launches zgemm and the trace and no fidelity or
    mse kernel, the evaluation one fidelity and one mse launch each for
    the train and the test pairs; the kernel session agrees with the
    complex128 one, and a saved and resumed session continues on the
    card bit for bit."""
    from repro_torch.core.fed import api
    out = {}
    for impl in ("xla", "pallas"):
        spec = api.FedSpec.quantum(widths=(2, 3, 2), num_nodes=6,
                                   nodes_per_round=4, interval_length=2,
                                   eps=0.05, impl=impl, n_per_node=3,
                                   n_test=5, data_seed=1)
        sess = api.FederationSession.create(spec, 0, device=cuda_device)
        torch.cuda.synchronize()
        build.reset_launches()
        sess.step()
        torch.cuda.synchronize()
        round_launches = dict(build.LAUNCHES)
        build.reset_launches()
        ev = sess.evaluate()
        eval_launches = dict(build.LAUNCHES)
        assert all(p.device.type == "cuda" for p in sess.state)
        out[impl] = (sess, ev)
        if impl == "pallas":
            assert round_launches["zgemm"] > 0
            assert round_launches["ensemble_commutator_trace"] > 0
            assert "fidelity" not in round_launches
            assert eval_launches == {"zgemm": 2, "fidelity": 2, "mse": 2}
        else:
            assert round_launches == {} and eval_launches == {}
    dev = max(float((a - b).abs().max()) for a, b in
              zip(out["xla"][0].state, out["pallas"][0].state))
    assert dev <= RTOL
    assert max(abs(out["xla"][1][k] - out["pallas"][1][k])
               for k in out["xla"][1]) <= RTOL
    sess = out["pallas"][0]
    path = str(tmp_path / "card.npz")
    sess.save(path)
    resumed = api.FederationSession.resume(path, device=cuda_device)
    sess.step()
    resumed.step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(sess.state, resumed.state))


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
@pytest.mark.parametrize("m", [1, 16])
def test_zgemm_at_the_local_opb_operator_shapes(cuda_device, m):
    """The local_opb engine's av^H B_j at (4,5,4) with 10 nodes of 4
    pairs: a (40, m, 512) conjugated (a lazy view the dispatch
    materialises) against (40, 512, 512), one launch each."""
    rng = np.random.default_rng(m)
    a = _dev_c(rng, cuda_device, 40, m, 512)
    b = _dev_c(rng, cuda_device, 40, 512, 512)
    build.reset_launches()
    got = ops.complex_matmul(a.conj(), b)
    torch.cuda.synchronize()
    want = ref.zgemm_ref(a.conj(), b)
    assert dict(build.LAUNCHES) == {"zgemm": 1}
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())
    exact = a.conj() @ b
    assert float((got - exact).abs().max()) <= RTOL * float(exact.abs().max())


@pytest.mark.cuda
def test_three_engines_agree_on_the_card(cuda_device):
    """One round of local, local_opb and dense at (3,4,3) (4 nodes, 2 a
    round, I_l = 2) from the same params: complex128 within 1e-10 of the
    dense oracle, the kernel rounds within 1e-5; the certified engine's
    per-node bound dominates its deviation from the exact K's; reduced
    ensemble storage reaches the trace kernel widened, within its
    precision (f32 1e-5, bf16 5e-2, as the reference's gate)."""
    widths = (3, 4, 3)
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(0), 3, 4, 4, n_test=4,
        device=cuda_device)
    params = qnn.init_params(torch.Generator().manual_seed(1), widths,
                             device=cuda_device)
    out = {}
    for engine in qnn.ENGINES:
        for impl in qnn.IMPLS:
            cfg = fed.QuantumFedConfig(widths=widths, num_nodes=4,
                                       nodes_per_round=2, interval_length=2,
                                       eps=0.05, engine=engine, impl=impl)
            out[engine, impl] = fed.server_round(
                params, ds, torch.Generator().manual_seed(2), cfg)
    for (engine, impl), p in out.items():
        dev = max(float((a - b).abs().max())
                  for a, b in zip(p, out["dense", "xla"]))
        assert dev <= (1e-10 if impl == "xla" else RTOL), (engine, impl, dev)
    p2 = [u.expand((2,) + u.shape) for u in params]
    exact = qnn.update_matrices(p2, ds.phi_in[:2], ds.phi_out[:2], widths,
                                1.0)
    for impl in qnn.IMPLS:
        ks, bound = qnn.update_matrices(p2, ds.phi_in[:2], ds.phi_out[:2],
                                        widths, 1.0, impl=impl, rank_tol=1e-3,
                                        rank_cap=6, with_bound=True)
        dev = torch.stack([(k - e).abs().reshape(2, -1).amax(-1)
                           for k, e in zip(ks, exact)]).amax(0)
        slack = 0.0 if impl == "xla" else RTOL * max(
            float(e.abs().max()) for e in exact)
        assert bool((dev <= bound + slack + 1e-12).all()), (dev, bound)
    # complex64 storage: widened to complex128 at the trace kernel
    for dtype, tol in (("f32", 1e-5), ("bf16", 5e-2)):
        ks, bound = qnn.update_matrices(p2, ds.phi_in[:2], ds.phi_out[:2],
                                        widths, 1.0, impl="pallas",
                                        ensemble_dtype=dtype, with_bound=True)
        assert all(k.dtype == torch.complex128 for k in ks)
        assert float(bound.abs().max()) == 0.0
        dev = max(float((k - e).abs().max()) for k, e in zip(ks, exact))
        assert dev <= tol, (dtype, dev)


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
    # the segmented scan's edges: S of 1, one 16-token sub-chunk plus one,
    # a multiple of the 64-token segment, not one (4097: the S+1 prefill);
    # D of one 32-channel tile, under one, and not a multiple of 32
    for bsz, s, d in SCAN_CASES:
        a = torch.rand((bsz, s, d), generator=gen).to(cuda_device, dtype)
        b = torch.randn((bsz, s, d), generator=gen).to(cuda_device, dtype)
        got = krg.rglru_scan(a, b)
        torch.cuda.synchronize()
        want = ref.rglru_scan_ref(a, b)
        assert got.dtype == dtype and got.shape == (bsz, s, d)
        tol = BF16_ULP if dtype == torch.bfloat16 else RTOL
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * scale, (bsz, s, d, err, scale)
    assert dict(build.LAUNCHES) == {"flash_attention": len(cases),
                                    "rglru_scan": 1 + len(SCAN_CASES)}


SCAN_CASES = [(2, 1, 64), (1, 17, 32), (3, 128, 300), (2, 4097, 77),
              (1, 200, 2560), (4, 63, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_kernels_give_the_same_bits_on_repeat(cuda_device, dtype):
    """No atomics and no order between blocks in the scan or the GLA
    kernel: the same inputs give the same bits (out and GLA's state)."""
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import rglru_scan as krg
    gen = torch.Generator().manual_seed(10)
    a = torch.rand((2, 4097, 300), generator=gen).to(cuda_device, dtype)
    b = torch.randn((2, 4097, 300), generator=gen).to(cuda_device, dtype)
    first = krg.rglru_scan(a, b)
    assert torch.equal(first, krg.rglru_scan(a, b))
    for s, dh, chunk in ((64, 64, 16), (33, 40, 1), (96, 64, 48)):
        args = _gla_case(gen, 2, s, 3, dh, dtype, cuda_device)
        out, state = kgla.gla_chunked(*args, chunk=chunk)
        again, again_state = kgla.gla_chunked(*args, chunk=chunk)
        assert torch.equal(out, again) and torch.equal(state, again_state)


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
             (2, 32, 3, 64, 16, False, torch.bfloat16)] + GLA_TILE_CASES
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


# The redesigned kernel's edges: dh 8, 32, 40 and 64 across its 32-column
# tiles (one partial, one full, a full and a partial, two full); S of one
# chunk; stages of several chunks (16 chunks of 1, 5 of 3 with a short
# last stage, 2 of 8) and chunks above 16 (20: a sub-block of 16 and one
# of 4; 48: three), at the clip's ends too; 4097 tokens at chunk 1 (the
# S+1 prefill); rows of dh 5 and 6, which the kernel copies element by
# element (not 16-byte pieces); chunks of 10 and 12, one chunk a stage
# short of 16, on the tensor-core path (as 16 is), with w in fp32 and in
# bf16.
GLA_TILE_CASES = [(2, 16, 3, 8, 16, False, torch.float32),
                  (1, 16, 2, 32, 16, True, torch.float32),
                  (2, 33, 3, 40, 3, True, torch.float32),
                  (1, 48, 2, 64, 1, True, torch.float32),
                  (2, 32, 2, 64, 8, False, torch.float32),
                  (1, 40, 2, 40, 20, True, torch.float32),
                  (1, 96, 3, 64, 48, False, torch.float32),
                  (1, 4097, 2, 64, 1, False, torch.float32),
                  (2, 32, 3, 5, 16, True, torch.float32),
                  (1, 40, 2, 6, 20, False, torch.float32),
                  (1, 40, 2, 40, 10, True, torch.float32),
                  (2, 36, 3, 64, 12, False, torch.bfloat16)]


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


@pytest.mark.cuda
def test_eigh_of_a_batch_with_a_nan_matrix_on_the_card(cuda_device):
    """cuSOLVER sees the finite-masked batch: the NaN matrix gets NaN
    factors, the others the CPU's exponentials."""
    from repro_torch.core.quantum import linalg as ql
    rng = np.random.default_rng(3)
    a = rand_c(rng, 3, 4, 4)
    k = torch.as_tensor((a + np.conj(np.swapaxes(a, -1, -2))) / 2)
    k[1] = float("nan")
    lam, v = ql.eigh_herm(k.to(cuda_device))
    torch.cuda.synchronize()
    assert bool(torch.isnan(lam[1]).all()) and bool(torch.isnan(v[1]).all())
    got = ql.expm_herm(k.to(cuda_device), 0.3).cpu()
    want = ql.expm_herm(k, 0.3)
    assert bool(torch.isnan(got[1]).all())
    assert float((got[[0, 2]] - want[[0, 2]]).abs().max()) <= 1e-10


def _stack_cell(device, s):
    """s sessions of bench_serve's SPEC_A shape: widths (2,3,2), N = 2,
    N_p = 2, 2 pairs a node, I_l = 1, average; own data and params."""
    sess = []
    for i in range(s):
        _, ds, _ = qdata.make_federated_dataset(
            torch.Generator().manual_seed(100 + i), 2, 2, 2, n_test=2,
            device=device)
        sess.append((qnn.init_params(torch.Generator().manual_seed(200 + i),
                                     (2, 3, 2), device=device), ds))
    params = [torch.stack(x) for x in zip(*(p for p, _ in sess))]
    ds = qdata.QuantumDataset(torch.stack([d.phi_in for _, d in sess]),
                              torch.stack([d.phi_out for _, d in sess]))
    return sess, params, ds


@pytest.mark.cuda
@pytest.mark.parametrize("server_opt", ["none", "momentum"])
def test_stacked_round_launches_one_rounds_kernels(cuda_device, server_opt):
    """A stack of 8 sessions with per-slot eta and eps: the kernel round
    within 1e-5 of each session's solo complex128 round, and as many
    kernel launches as one solo kernel round."""
    s = 8
    sess, params, ds = _stack_cell(cuda_device, s)
    cfg = fed.QuantumFedConfig(widths=(2, 3, 2), num_nodes=2,
                               nodes_per_round=2, interval_length=1,
                               aggregation="average", impl="pallas")
    eta = torch.linspace(0.5, 2.0, s, dtype=torch.float64)
    eps = torch.linspace(0.05, 0.2, s, dtype=torch.float64)
    torch.cuda.synchronize()
    build.reset_launches()
    got, smom, _ = fed.server_round_stacked(
        params, ds, [torch.Generator().manual_seed(i) for i in range(s)], cfg,
        eta=eta, eps=eps, server_opt=server_opt)
    torch.cuda.synchronize()
    stacked = dict(build.LAUNCHES)
    build.reset_launches()
    fed.server_round_opt(sess[0][0], None, sess[0][1],
                         torch.Generator().manual_seed(0), cfg,
                         server_opt=server_opt)
    torch.cuda.synchronize()
    assert stacked == dict(build.LAUNCHES) and stacked.get("zgemm")
    assert stacked.get("ensemble_commutator_trace")
    for i, (p, d) in enumerate(sess):
        want, _ = fed.server_round_opt(
            p, None, d, torch.Generator().manual_seed(i),
            cfg._replace(impl="xla", eta=float(eta[i]), eps=float(eps[i])),
            server_opt=server_opt)
        dev = max(float((g[i] - w).abs().max()) for g, w in zip(got, want))
        assert dev <= RTOL, (i, dev)
    assert (smom is None) == (server_opt == "none")


@pytest.mark.cuda
def test_screened_round_on_the_card(cuda_device):
    """The screened product with a corrupt node: the kernel round within
    1e-5 of the complex128 round, finite, the corrupt upload quarantined,
    and the probe scored through the fidelity kernel."""
    from repro_torch.core.fed import faults
    widths = (2, 3, 2)
    _, ds, test = qdata.make_federated_dataset(
        torch.Generator().manual_seed(4), 2, 6, 3, n_test=8,
        device=cuda_device)
    params = qnn.init_params(torch.Generator().manual_seed(5), widths,
                             device=cuda_device)
    model = faults.DrawFault("corrupt", 0.3, 2, 5.0)
    sel = torch.arange(6, device=cuda_device)
    bad = torch.tensor([model.hits(n, 0) for n in range(6)])
    assert bool(bad.any()) and not bool(bad.all())
    coeff = torch.tensor([model(n, 0)[0] for n in range(6)],
                         device=cuda_device)
    out = {}
    for impl in ("xla", "pallas"):
        cfg = fed.QuantumFedConfig(widths=widths, num_nodes=6,
                                   nodes_per_round=6, interval_length=2,
                                   aggregation="product", defense="screen",
                                   screen_tol=0.01, impl=impl)
        ks = fed.local_phase(params, ds, sel, torch.Generator(), cfg)
        ks = [k * coeff.reshape(-1, 1, 1, 1, 1) for k in ks]
        weights = torch.full((6,), 1 / 6, device=cuda_device)
        torch.cuda.synchronize()
        build.reset_launches()
        _, _, keep = fed._screen_uploads(
            [p[None] for p in params], [k[None] for k in ks], weights[None],
            cfg.eps, cfg, tuple(x[None] for x in test))
        new, _ = fed.aggregate_phase(params, ks, weights, cfg, probe=test)
        torch.cuda.synchronize()
        if impl == "pallas":
            assert build.LAUNCHES.get("fidelity") and build.LAUNCHES.get(
                "zgemm")
        assert not bool((keep[0].cpu() & bad).any())
        out[impl] = new
    dev = max(float((a - b).abs().max())
              for a, b in zip(out["pallas"], out["xla"]))
    assert dev <= RTOL and all(bool(torch.isfinite(p.abs()).all())
                               for p in out["pallas"])


@pytest.mark.cuda
@pytest.mark.parametrize("aggregation", ["product", "average"])
def test_tree_round_launches_the_kernels(cuda_device, aggregation):
    """A two-level round (N_p = 8 in 4 pods, I_l = 2) with the kernels:
    within 1e-5 of the flat complex128 round from the same generator.
    The product tree replaces each layer's N_p * I_l chain steps by
    (per - 1) pod steps, (pods - 1) merge steps and I_l applications,
    all through zgemm; the average's combine launches as the flat one."""
    widths, n_p, pods, il = (2, 3, 2), 8, 4, 2
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(6), 2, n_p, 3, n_test=4,
        device=cuda_device)
    params = qnn.init_params(torch.Generator().manual_seed(7), widths,
                             device=cuda_device)
    flat = fed.QuantumFedConfig(widths=widths, num_nodes=n_p,
                                nodes_per_round=n_p, interval_length=il,
                                aggregation=aggregation, impl="pallas")
    tree = flat._replace(topology="two_level", pods=pods)
    launches = {}
    for label, cfg in (("flat", flat), ("tree", tree)):
        torch.cuda.synchronize()
        build.reset_launches()
        got = fed.server_round(params, ds, torch.Generator().manual_seed(1),
                               cfg)
        torch.cuda.synchronize()
        launches[label] = dict(build.LAUNCHES)
    want = fed.server_round(params, ds, torch.Generator().manual_seed(1),
                            flat._replace(impl="xla"))
    dev = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert dev <= RTOL, dev
    layers = len(widths) - 1
    saved = (layers * (n_p * il - ((n_p // pods - 1) + (pods - 1) + il))
             if aggregation == "product" else 0)
    assert launches["tree"]["zgemm"] == launches["flat"]["zgemm"] - saved
    assert launches["tree"]["ensemble_commutator_trace"] == \
        launches["flat"]["ensemble_commutator_trace"] > 0


@pytest.mark.cuda
def test_served_tick_launches_k_stacked_rounds(cuda_device, tmp_path):
    """Four tenants with their own eta on one stacked grid, a tick of
    k = 3 rounds: the tick launches k times one solo kernel round's
    kernels (a stacked round launches as many as one solo round), and
    each tenant ends within 1e-5 of its solo complex128 session with the
    same key (same cohorts)."""
    import dataclasses

    from repro_torch.core.fed.api import FederationSession, FedSpec
    from repro_torch.core.fed.serve import FederationServer
    spec = FedSpec.quantum((2, 3, 2), num_nodes=2, nodes_per_round=2,
                           n_per_node=2, interval_length=1, n_test=2,
                           aggregation="average", impl="pallas")
    specs = [dataclasses.replace(spec, eta=0.5 + 0.25 * i) for i in range(4)]
    k = 3
    server = FederationServer(slots=4, rounds_per_tick=k,
                              store_dir=str(tmp_path))
    sids = [server.submit(s, key=i, rounds=k) for i, s in enumerate(specs)]
    torch.cuda.synchronize()
    build.reset_launches()
    stats = server.tick()
    torch.cuda.synchronize()
    tick = dict(build.LAUNCHES)
    assert stats["retired"] == 4 and server.n_pending == 0
    solo = FederationSession.create(specs[0], 0)
    torch.cuda.synchronize()
    build.reset_launches()
    solo.step()
    torch.cuda.synchronize()
    one = dict(build.LAUNCHES)
    assert one.get("zgemm") and tick == {n: k * c for n, c in one.items()}
    for i, (sid, s) in enumerate(zip(sids, specs)):
        want = FederationSession.create(dataclasses.replace(s, impl="xla"),
                                        i)
        for _ in range(k):
            want.step()
        got = server.session(sid)
        dev = max(float((a - b).abs().max())
                  for a, b in zip(got.state, want.state))
        assert got.round == k and dev <= RTOL, (i, dev)


# ---------------------------------------------------------------- training
BWD_RTOL = 1e-4   # fp32 gradients, relative to each gradient's scale
# (dK sums the P dS products of up to G x window query rows in another
# order than the plain version)

ATTN_BWD_CASES = [  # bh, bk, sq, sk, dh, causal, window
    (10, 1, 100, 100, 256, True, 16),   # GQA 10:1, ragged S, short window
    (3, 3, 77, 77, 64, True, 0),        # G = 1, window 0
    (2, 2, 65, 65, 128, False, 0),      # a short last key tile, no mask
    (4, 2, 130, 130, 64, False, 20),    # window without causality
    (2, 1, 100, 37, 64, True, 16),      # Sq > Sk: rows with no allowed key
]


def _attn_bwd_args(gen, bh, bk, sq, sk, dh, dtype, device):
    def r(*shape):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
    return r(bh, sq, dh), r(bk, sk, dh), r(bk, sk, dh), r(bh, sq, dh), \
        r(bh, sq, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_attention_backward_kernel_agrees_on_ragged_cases(cuda_device, dtype,
                                                          case):
    """The backward kernel (bf16: the wgmma kernels, fp32: the 3xTF32
    mma.sync ones) against ``ref.attention_bwd_ref`` on the same (q, k, v, o, dO)
    and the plain LSE of (q, k, v): fp32 within BWD_RTOL of each
    gradient's scale, bf16 within one bf16 ulp of it (both are one
    rounding of nearly the same fp32 value); the same bits on repeat;
    one launch a call."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh, causal, window = case
    args = _attn_bwd_args(torch.Generator().manual_seed(sum(case)), bh, bk,
                          sq, sk, dh, dtype, cuda_device)
    kw = dict(causal=causal, window=window)
    kw["lse"] = ref.attention_ref(*args[:3], return_lse=True, **kw)[1]
    build.reset_launches()
    got = kfa.flash_attention_bwd(*args, **kw)
    again = kfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention_bwd": 2}
    want = ref.attention_bwd_ref(*args, **kw)
    tol = BWD_RTOL if dtype == torch.float32 else 2.0 ** -7
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a), name
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, name
    if window > 0 and sq > sk + window - 1:  # rows with no allowed key
        assert not got[0][:, sk + window - 1:].float().abs().max()


LSE_RTOL = 1e-6   # the forward kernels' LSE, of its scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_forward_lse_matches_the_plain_lse(cuda_device, dtype, case):
    """The forward kernel's log-sum-exp (``return_lse``; fp32 3xTF32
    mma.sync and bf16 wgmma kernels) against ``ref.attention_ref``'s on the same
    inputs: within LSE_RTOL of its scale, -inf on exactly the rows with
    no allowed key; the output is the one without ``return_lse``, bit
    for bit; one launch a call."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh, causal, window = case
    q, k, v = _attn_bwd_args(torch.Generator().manual_seed(sum(case)), bh,
                             bk, sq, sk, dh, dtype, cuda_device)[:3]
    kw = dict(causal=causal, window=window)
    build.reset_launches()
    out, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    plain_out = kfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 2}
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    want = ref.attention_ref(q, k, v, return_lse=True, **kw)[1]
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), fin)
    assert bool((lse[~fin] == float("-inf")).all())
    scale = float(want[fin].abs().max())
    assert float((lse[fin] - want[fin]).abs().max()) <= LSE_RTOL * scale


@pytest.mark.cuda
def test_bf16_attention_backward_runs_on_the_tensor_cores(cuda_device):
    """The built bf16 backward kernels (the dQ and dK/dV passes at dh 64,
    128, 256) issue wgmma: HGMMA in their machine code; the fp32
    backward kernels (both passes at each dh, with each split) are built
    for fp32 only, so no bf16 backward can take them."""
    from repro_torch.kernels import flash_attention as kfa
    sass = build.sass()
    for name in kfa.BF16_KERNELS[1:]:
        code = [text for n, text in sass.items() if name in n]
        assert len(code) == 3 and all("HGMMA" in t for t in code), name
    assert kfa.bf16_design() == "wgmma"
    cuda_core = [n for n in sass if "attn_bwd_dq_kernel" in n
                 or "attn_bwd_dkdv_kernel" in n]
    assert len(cuda_core) == 12
    assert not any("bfloat16" in n for n in cuda_core)


@pytest.mark.cuda
def test_fp32_attention_runs_on_the_tensor_cores(cuda_device):
    """The built fp32 kernels (the forward and the backward's dQ and
    dK/dV passes, each at dh 64, 128, 256, with the four-instruction split
    and with the one that keeps a NaN) issue TF32 tensor-core
    instructions: HMMA (mma.sync) or HGMMA (wgmma) with .TF32 in their
    machine code, and ``fp32_design`` reads the same. A kernel back on the
    CUDA cores has none."""
    from repro_torch.kernels import flash_attention as kfa
    sass = build.sass()
    for name in kfa.FP32_KERNELS:
        code = [text for n, text in sass.items() if name in n]
        assert len(code) == 6, name
        for text in code:
            assert any(("HMMA" in ln or "HGMMA" in ln) and "TF32" in ln
                       for ln in text.splitlines()), name
    assert kfa.fp32_design() in ("mma.sync", "wgmma")


@pytest.mark.cuda
def test_fp32_attention_backward_same_bits_on_repeat(cuda_device):
    """The fp32 backward splits a kv head's G = 10 query heads over
    ``bwd_splits`` > 1 blocks of its dK/dV pass and sums their fp32
    partials in split order: the same inputs give the same bits, within
    BWD_RTOL of the plain version, one launch a call."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh = 10, 1, 256, 256, 256
    splits = kfa.bwd_splits(bh, bk, sk, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert splits > 1
    args = _attn_bwd_args(torch.Generator().manual_seed(13), bh, bk, sq, sk,
                          dh, torch.float32, cuda_device)
    kw = dict(causal=True, window=100)
    kw["lse"] = kfa.flash_attention(*args[:3], causal=True, window=100,
                                    return_lse=True)[1]
    build.reset_launches()
    first = kfa.flash_attention_bwd(*args, **kw)
    for _ in range(3):
        again = kfa.flash_attention_bwd(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention_bwd": 4}
    want = ref.attention_bwd_ref(*args, **kw)
    for name, g, w in zip("qkv", first, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= BWD_RTOL * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_through_ops_backpropagates_like_the_plain_route(
        cuda_device, dtype):
    """``ops.attention`` on the card is an autograd Function: its
    gradients (forward kernel, backward kernel) match autograd of the
    plain route, and come back in q's dtype."""
    g = torch.Generator().manual_seed(5)

    def leaf(*shape):
        return torch.randn(shape, generator=g).to(cuda_device, dtype
                                                   ).requires_grad_()
    q, k, v = leaf(2, 70, 4, 64), leaf(2, 70, 2, 64), leaf(2, 70, 2, 64)
    dout = torch.randn((2, 70, 4, 64), generator=g).to(cuda_device, dtype)
    kw = dict(causal=True, window=24)
    build.reset_launches()
    out = ops.attention(q, k, v, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 1,
                                    "flash_attention_bwd": 1}
    want = torch.autograd.grad(ops.attention(q, k, v, impl="xla", **kw),
                               (q, k, v), dout)
    tol = BWD_RTOL if dtype == torch.float32 else 2.0 ** -6
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 2560), (3, 77, 300)])
def test_scan_backward_runs_the_kernel_reversed(cuda_device, shape):
    """``ops.lru_scan`` on the card: the backward is the scan kernel on
    the reversed sequence (one more launch), and its da, db match
    autograd of the plain sequential scan within 1e-5 of their scale."""
    g = torch.Generator().manual_seed(6)
    a = torch.rand(shape, generator=g).to(cuda_device).requires_grad_()
    b = torch.randn(shape, generator=g).to(cuda_device).requires_grad_()
    gy = torch.randn(shape, generator=g).to(cuda_device)
    build.reset_launches()
    h = ops.lru_scan(a, b)
    got = torch.autograd.grad(h, (a, b), gy)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"rglru_scan": 2}
    want = torch.autograd.grad(ref.rglru_scan_ref(a, b), (a, b), gy)
    for name, x, y in zip("ab", got, want):
        scale = float(y.abs().max())
        assert float((x - y).abs().max()) <= 1e-5 * scale, name


@pytest.mark.cuda
def test_forward_train_backprop_through_kernels_matches_plain(cuda_device):
    """The fault's gate at reduced widths (fp32, remat on): every
    parameter's gradient of the training loss through the kernels
    (attention and its backward kernel, the scan and its reverse) matches
    the plain route's, at the whole-model tolerance of
    tests/test_torch_model.py (1e-3 of each gradient's scale: the
    reference init's stacked fan-in puts the RG-LRU gates in the
    sigmoid's tail). The remat cycle runs the forward kernels twice."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              remat=True)
    params = Model(cfg).init(seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 96), generator=g,
                              dtype=torch.int32).to(cuda_device)
             for k in ("tokens", "labels")}
    build.reset_launches()
    loss, _, got = loss_and_grads(Model(cfg), params, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 2,
                                    "flash_attention_bwd": 1,
                                    "rglru_scan": 6}
    want_loss, _, want = loss_and_grads(Model(cfg, impl="xla"), params,
                                        batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for key, w in want.items():
        scale = float(w.abs().max())
        assert float((got[key] - w).abs().max()) <= 1e-3 * scale, key


@pytest.mark.cuda
def test_rwkv_training_through_the_gla_kernels_matches_plain(cuda_device):
    """RWKV6 reduced (fp32, remat on, the redrawn decays across the clip):
    every parameter's gradient of the training loss through the GLA
    kernel and its backward kernel matches the plain route's (autodiff of
    the chunked form) within 1e-3 of its scale, the whole-model tolerance
    of the RecurrentGemma case above; the remat cycle runs the forward
    kernel twice a layer and the backward once. Without autograd
    recording the same forward runs the forward kernel alone."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), remat=True)
    params = _rwkv_params(cfg, cuda_device)
    g = torch.Generator().manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 96), generator=g,
                              dtype=torch.int32).to(cuda_device)
             for k in ("tokens", "labels")}
    build.reset_launches()
    loss, _, got = loss_and_grads(Model(cfg), params, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"gla_chunked": 2 * cfg.n_layers,
                                    "gla_chunked_bwd": cfg.n_layers}
    want_loss, _, want = loss_and_grads(Model(cfg, impl="xla"), params,
                                        batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for key, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        assert bool(torch.isfinite(got[key]).all()), key
        assert float((got[key] - w).abs().max()) <= 1e-3 * scale, key
    build.reset_launches()
    with torch.no_grad():
        Model(cfg).forward_train(params, batch)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"gla_chunked": cfg.n_layers}


# (b, s, h, dh, chunk, w at the clip's ends, w dtype, a dstate): the
# train step's chunk 16 and chunk 1 (S that 16 does not divide: the
# kernel's last stage short), chunks above 16 (48; 128, a whole
# sequence), a single token, dh 8, 40 and 5 (a partial row block; rows
# of 5 elements), dh 64 (a cluster of four row blocks), w in bf16, with
# and without the final state's cotangent
GLA_BWD_CASES = [(1, 64, 3, 64, 16, False, torch.float32, False),
                 (2, 48, 2, 64, 16, True, torch.float32, True),
                 (1, 17, 3, 8, 1, False, torch.float32, True),
                 (2, 33, 2, 40, 3, True, torch.float32, False),
                 (1, 96, 2, 64, 48, False, torch.float32, True),
                 (1, 128, 2, 32, 128, True, torch.float32, False),
                 (2, 1, 5, 64, 1, False, torch.float32, True),
                 (2, 32, 3, 5, 16, True, torch.float32, False),
                 (1, 40, 2, 64, 20, False, torch.bfloat16, True),
                 (1, 4097, 1, 64, 1, False, torch.float32, False)]
# the backward's cut points: S one short of and one past a multiple of
# its 16-token stage (63, 65, 31, 127, 129), S below a stage (15), B = 3,
# so that du sums over b and over stages
GLA_CUT_CASES = [(3, 63, 2, 64, 1, False, torch.float32, True),
                 (3, 65, 2, 64, 5, True, torch.float32, False),
                 (1, 15, 3, 64, 5, False, torch.float32, True),
                 (3, 31, 2, 40, 1, True, torch.float32, True),
                 (2, 127, 2, 64, 127, False, torch.bfloat16, False),
                 (3, 129, 2, 24, 3, False, torch.float32, True)]
GLA_BWD_CASES += GLA_CUT_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_backward_kernel_agrees_on_ragged_cases(cuda_device, dtype):
    """dr, dk, dv, dw, du against the plain backward on the same inputs:
    fp32 within 1e-5 of each gradient's scale (the two sum the same
    terms in another order), bf16 outputs within one bf16 ulp of it; dw
    exactly 0 where w is below the 1e-20 clamp; one launch a call."""
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(10)
    build.reset_launches()
    for b, s, h, dh, chunk, ends, w_dtype, with_state in GLA_BWD_CASES:
        args = _gla_case(gen, b, s, h, dh, dtype, cuda_device, ends, w_dtype)
        dout = torch.randn((b, s, h, dh), generator=gen).to(cuda_device,
                                                            dtype)
        dstate = (torch.randn((b, h, dh, dh), generator=gen).to(cuda_device)
                  if with_state else None)
        got = kgla.gla_chunked_bwd(*args, dout, dstate, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.gla_chunked_bwd_ref(*args, dout, dstate, chunk)
        assert [x.dtype for x in got] == [x.dtype for x in want]
        assert [x.shape for x in got] == [x.shape for x in want]
        for name, x, y in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            tol = BF16_ULP if y.dtype == torch.bfloat16 else RTOL
            scale = max(float(y.float().abs().max()), 1e-30)
            err = float((x.float() - y.float()).abs().max())
            assert err <= tol * scale, (b, s, h, dh, chunk, name, err, scale)
        assert bool((got[3][args[3] < 1e-20] == 0).all())
    assert dict(build.LAUNCHES) == {"gla_chunked_bwd": len(GLA_BWD_CASES)}


@pytest.mark.cuda
def test_gla_backward_copies_by_tma_at_the_train_shape(cuda_device):
    """RWKV6-7B's train step (1, 4096, 64, 64), bf16 with w fp32, takes
    the kernel's TMA copies, as do fp32 rows of 64; rows of 5 elements and
    operands 2 or 4 bytes off a 16-byte boundary take the element copy,
    which gives the TMA copy's gradients bit for bit."""
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(13)
    bf = torch.bfloat16
    args = _gla_case(gen, 1, 4096, 64, 64, bf, cuda_device)
    assert kgla.backward_copies_by_tma(*args, torch.zeros_like(args[0]))
    args = _gla_case(gen, 2, 200, 3, 64, torch.float32, cuda_device)
    assert kgla.backward_copies_by_tma(*args, torch.zeros_like(args[0]))
    args = _gla_case(gen, 1, 40, 2, 5, torch.float32, cuda_device)
    assert not kgla.backward_copies_by_tma(*args, torch.zeros_like(args[0]))

    def shifted(x):             # the same values one element further on
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        return buf[1:].view(x.shape).copy_(x)
    args = _gla_case(gen, 2, 200, 3, 64, bf, cuda_device)
    dout = torch.randn((2, 200, 3, 64), generator=gen).to(cuda_device, bf)
    dstate = torch.randn((2, 3, 64, 64), generator=gen).to(cuda_device)
    off = [shifted(x) for x in args + [dout]]
    assert not kgla.backward_copies_by_tma(*off)
    want = kgla.gla_chunked_bwd(*args, dout, dstate, chunk=8)
    got = kgla.gla_chunked_bwd(*off[:5], off[5], dstate, chunk=8)
    torch.cuda.synchronize()
    for name, x, y in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_backward_gives_the_same_bits_on_repeat(cuda_device, dtype):
    """No atomics: the same inputs give the same gradients bit for bit
    (the kill-and-resume of a federated RWKV6 run depends on it)."""
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(11)
    args = _gla_case(gen, 2, 300, 4, 64, dtype, cuda_device)
    dout = torch.randn((2, 300, 4, 64), generator=gen).to(cuda_device, dtype)
    dstate = torch.randn((2, 4, 64, 64), generator=gen).to(cuda_device)
    first = kgla.gla_chunked_bwd(*args, dout, dstate, chunk=4)
    again = kgla.gla_chunked_bwd(*args, dout, dstate, chunk=4)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_gla_backward_wrapper_refuses_bad_operands(cuda_device):
    from repro_torch.kernels import gla_chunked as kgla
    gen = torch.Generator().manual_seed(12)
    r, k, v, w, u = _gla_case(gen, 1, 16, 2, 64, torch.float32, cuda_device)
    do = torch.randn_like(r)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kgla.gla_chunked_bwd(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu(),
                             do.cpu(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        kgla.gla_chunked_bwd(r, k, v, w, u, do.transpose(1, 2), chunk=16)
    with pytest.raises(ValueError):
        kgla.gla_chunked_bwd(r, k, v, w, u, do.bfloat16(), chunk=16)
    with pytest.raises(ValueError):
        kgla.gla_chunked_bwd(r, k, v, w, u, do[:, :8].contiguous(), chunk=8)
    with pytest.raises(ValueError, match="dstate"):
        kgla.gla_chunked_bwd(r, k, v, w, u, do,
                             torch.zeros((1, 2, 64, 32), device=cuda_device),
                             chunk=16)
    with pytest.raises(ValueError):
        kgla.gla_chunked_bwd(r, k, v, w, u, do,
                             torch.zeros((1, 2, 64, 64), device=cuda_device,
                                         dtype=torch.bfloat16), chunk=16)
    with pytest.raises(ValueError, match="divide"):
        kgla.gla_chunked_bwd(r, k, v, w, u, do, chunk=5)
    big = [torch.zeros((1, 4, 1, 128), device=cuda_device)] * 4
    with pytest.raises(ValueError, match="head_dim"):
        kgla.gla_chunked_bwd(*big, torch.zeros((1, 128), device=cuda_device),
                             big[0], chunk=4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["zgemm", "ensemble_commutator_trace",
                                    "fidelity", "mse"])
def test_quantum_wrappers_refuse_inputs_that_require_grad(cuda_device,
                                                          kernel):
    """The quantum kernels have no gradient: through ``ops`` an input
    that requires grad is refused before any launch, rather than give an
    output that silently drops the gradient."""
    fn = {"zgemm": ops.complex_matmul, "fidelity": ops.fidelity,
          "mse": ops.mse,
          "ensemble_commutator_trace": ops.ensemble_commutator_trace}[kernel]
    _, args, _ = _wrapper_operands(cuda_device)[kernel]
    build.reset_launches()
    with pytest.raises(ValueError, match="no gradient"):
        fn(args[0].clone().requires_grad_(), *args[1:])
    assert not build.LAUNCHES
    with torch.no_grad():
        fn(args[0].clone().requires_grad_(), *args[1:])
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {kernel: 1}


@pytest.mark.cuda
def test_bf16_unembedding_backward_on_the_card(cuda_device):
    """``matmul_f32`` of bf16 operands (the tied unembedding) is
    differentiable on the card: its gradients match fp32 autograd of the
    same bf16 values within one bf16 rounding."""
    from repro_torch.models.layers.embeddings import matmul_f32
    g = torch.Generator().manual_seed(8)
    x = torch.randn((3, 50, 64), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((300, 64), generator=g) * 0.1).to(cuda_device,
                                                        torch.bfloat16)
    gy = torch.randn((3, 50, 300), generator=g).to(cuda_device)
    xl, wl = x.requires_grad_(), w.requires_grad_()
    y = matmul_f32(xl, wl.T)
    assert y.dtype == torch.float32
    got = torch.autograd.grad(y, (xl, wl), gy)
    x32, w32 = (t.detach().float().requires_grad_() for t in (x, w))
    want = torch.autograd.grad(x32 @ w32.T, (x32, w32), gy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= 2.0 ** -8 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_dh128_attention_forward_and_backward(cuda_device, dtype):
    """Qwen1.5-4B's attention shape, multi-head (G = 1), dh 128, fully
    causal, no window, at S = 2048: the forward kernel's output (one bf16
    ulp of the plain result's scale in bf16, RTOL in fp32) and its LSE
    (LSE_RTOL) against the plain version's, and the backward kernel on
    that LSE against ``ref.attention_bwd_ref`` (BWD_RTOL in fp32, one
    bf16 ulp of each gradient's scale in bf16); one launch each."""
    from repro_torch.kernels import flash_attention as kfa
    q, k, v, o_unused, do = _attn_bwd_args(torch.Generator().manual_seed(9),
                                           8, 8, 2048, 2048, 128, dtype,
                                           cuda_device)
    del o_unused
    kw = dict(causal=True, window=0)
    build.reset_launches()
    out, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    grads = kfa.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 1,
                                    "flash_attention_bwd": 1}
    want, want_lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    tol = RTOL if dtype == torch.float32 else 2.0 ** -7
    assert float((out.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())
    assert float((lse - want_lse).abs().max()) <= \
        LSE_RTOL * float(want_lse.abs().max())
    want_g = ref.attention_bwd_ref(q, k, v, out, do, lse=want_lse, **kw)
    tol = BWD_RTOL if dtype == torch.float32 else 2.0 ** -7
    for name, g, w in zip("qkv", grads, want_g):
        assert g.dtype == dtype
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [
    ("qwen1.5-4b", {"n_layers": 1}), ("recurrentgemma-2b", {})])
def test_classical_round_on_the_card_matches_the_plain_route(cuda_device,
                                                             arch, overrides):
    """One ``ClassicalSubstrate`` round on the card through the kernels
    against the same round through the plain versions (fp32, reduced,
    SGD at 0.1, the same params and cohort; the stacked matrices at std
    1/sqrt(d_in), where fp32 gradients are not rounding noise): the
    aggregated delta within 1e-3 of each leaf's scale (the whole-model
    gradient tolerance above), each local step's launches counted (no
    remat at reduced width: one forward and one backward a layer)."""
    import math
    from repro_torch.core.fed import api, fed_step
    from repro_torch.core.fed.api import phases
    from repro_torch.models import Model
    from repro_torch.optim import SGD
    spec = api.FedSpec.classical(arch=arch, num_nodes=3, nodes_per_round=2,
                                 interval_length=2, node_batch=2, seq_len=48,
                                 lr=0.1, data_seed=0, **overrides)
    sub = api.ClassicalSubstrate(spec, opt=SGD(), device=cuda_device)
    plain = api.ClassicalSubstrate(spec, model=Model(sub.cfg, impl="xla"),
                                   opt=SGD(), device=cuda_device)
    params = {k: (v * math.sqrt(v.shape[0] / v.shape[1])
                  if k.startswith("stack/") and v.dim() >= 3 else v)
              for k, v in sub.model.init(seed=0, device=cuda_device).items()}
    state = sub.init_state(0, params=params)
    build.reset_launches()
    _, cohort, got, _ = phases.dispatch_round(
        sub, sub.snapshot(state), 3, 0)
    torch.cuda.synchronize()
    n_rec = sub.cfg.block_pattern.count("rec")
    want = {"flash_attention": 4, "flash_attention_bwd": 4}
    if n_rec:
        want["rglru_scan"] = 4 * 2 * n_rec
    assert {k: n for k, n in build.LAUNCHES.items() if n} == want
    _, _, ref_up, _ = phases.dispatch_round(
        plain, plain.snapshot(state), 3, 0)
    zero = {k: torch.zeros(v.shape, device=cuda_device)
            for k, v in params.items()}
    agg = fed_step.aggregate_deltas(zero, got, cohort.weights, 1.0)[0]
    agg_x = fed_step.aggregate_deltas(zero, ref_up, cohort.weights, 1.0)[0]
    for key, x in agg_x.items():
        scale = float(x.abs().max())
        assert float((agg[key] - x).abs().max()) <= 1e-3 * scale, key


# ------------------------------------------- the model zoo's attention shapes
# (bh, bk, sq, sk, dh, window, causal): the query-per-kv-head groups G and
# head sizes of the seven architectures the moe kind, M-RoPE,
# cross-attention and embedding inputs bring in (llama4-scout G = 5,
# arctic G = 7, gemma3 G = 2 with window 1024, command-r and qwen2-vl G =
# 8, llama3 G = 16, musicgen G = 1 at dh 64), and musicgen's
# cross-attention: every query against the conditioning keys, Sk = 256
# (its cond_len) and a ragged Sk = 200, far fewer keys than queries.
ZOO_ATTN_CASES = {
    "llama4-G5": (10, 2, 1100, 1100, 128, 0, True),
    "arctic-G7": (14, 2, 700, 700, 128, 0, True),
    "gemma3-G2-window1024": (8, 4, 2100, 2100, 128, 1024, True),
    "command-r-G8": (16, 2, 1000, 1000, 128, 0, True),
    "llama3-G16": (32, 2, 600, 600, 128, 0, True),
    "musicgen-G1-dh64": (8, 8, 1000, 1000, 64, 0, True),
    "musicgen-cross-Sk256": (8, 8, 4096, 256, 64, 0, False),
    "cross-Sk200": (8, 8, 1000, 200, 64, 0, False),
    "cross-G8-Sk200": (16, 2, 300, 200, 128, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ZOO_ATTN_CASES.values()),
                         ids=list(ZOO_ATTN_CASES))
def test_bf16_attention_at_the_model_zoo_shapes(cuda_device, case):
    """The bf16 kernel within one ulp (plus ATTN_TERM_TOL of the terms)
    of the fp32 function element by element, as the existing shapes;
    one launch each."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh, window, causal = case
    gen = torch.Generator().manual_seed(sum(case))
    q, k, v = _attn_case(gen, bh, bk, sq, sk, dh, torch.bfloat16, cuda_device)
    kw = dict(causal=causal, window=window)
    build.reset_launches()
    got = kfa.flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"flash_attention": 1}
    want = ref.attention_ref(q, k, v, **kw).float()
    terms = ref.attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    excess = ((got - want).abs() - bf16_ulp(want)).clamp_min(0)
    assert float((excess - ATTN_TERM_TOL * terms).max()) <= 0.0, case
    assert float((got != want).float().mean()) <= ATTN_SHARE_DIFFERING, case


@pytest.mark.cuda
@pytest.mark.parametrize("case", [ZOO_ATTN_CASES["musicgen-cross-Sk256"],
                                  ZOO_ATTN_CASES["cross-G8-Sk200"]],
                         ids=["Sk256", "G8-Sk200"])
def test_fp32_attention_with_few_keys_not_causal(cuda_device, case):
    """The fp32-storage kernel (3xTF32) at the cross-attention shapes,
    which the fp32 budget prefill of musicgen runs: within RTOL of the
    plain version's scale."""
    from repro_torch.kernels import flash_attention as kfa
    bh, bk, sq, sk, dh, window, causal = case
    gen = torch.Generator().manual_seed(sum(case) + 1)
    q, k, v = _attn_case(gen, bh, bk, sq, sk, dh, torch.float32, cuda_device)
    kw = dict(causal=causal, window=window)
    got = kfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, **kw)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


def _moe_case(device, dtype, **over):
    from repro_torch.configs import get_config
    from repro_torch.models import params as pp
    from repro_torch.models.layers import moe
    cfg = get_config("arctic-480b").reduced(
        d_model=64, d_ff=128, n_experts=8, top_k=2, capacity_factor=0.5,
        dtype="float32", **over)
    ini = pp.Initializer(torch.float32, seed=3)
    moe.init_moe(ini, "moe", cfg)
    p = {k: v.to(device, dtype) for k, v in pp.subtree(ini.params,
                                                        "moe").items()}
    x = 0.5 * torch.randn((4, 96, 64), generator=torch.Generator()
                          .manual_seed(4))
    return cfg, p, x.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"shared_expert": True,
                                       "moe_dense_residual": False}],
                         ids=["dense-residual", "shared-expert"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device, over):
    """fp32 (no TF32 in the products): the same experts and kept
    assignments as the same call on the CPU (capacity factor 0.5 drops
    some), the output and the aux losses within RTOL of the CPU's
    scale."""
    from repro_torch.models.layers import moe
    cfg, p, x = _moe_case(cuda_device, torch.float32, **over)
    cpu = {k: v.cpu() for k, v in p.items()}
    xf = x.reshape(-1, x.shape[-1])
    _, idx, _ = moe.route(p, xf, cfg)
    _, idx_cpu, _ = moe.route(cpu, xf.cpu(), cfg)
    assert torch.equal(idx.cpu(), idx_cpu)
    cap = moe.capacity(cfg, xf.shape[0])
    keep, _ = moe.slots(idx, cap, cfg.n_experts)
    keep_cpu, _ = moe.slots(idx_cpu, cap, cfg.n_experts)
    assert torch.equal(keep.cpu(), keep_cpu) and not bool(keep_cpu.all())
    y, aux = moe.moe_ffn(p, x, cfg)
    y_cpu, aux_cpu = moe.moe_ffn(cpu, x.cpu(), cfg)
    scale = float(y_cpu.abs().max())
    assert float((y.cpu() - y_cpu).abs().max()) <= RTOL * scale
    for key, val in aux_cpu.items():
        assert abs(float(aux[key]) - float(val)) <= RTOL * abs(float(val))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_gives_the_same_bits_on_repeat(cuda_device, dtype):
    """Dispatch writes each kept slot once (no atomic sums): repeated
    calls give the same bits."""
    from repro_torch.models.layers import moe
    cfg, p, x = _moe_case(cuda_device, dtype)
    first, aux = moe.moe_ffn(p, x, cfg)
    for _ in range(3):
        again, aux2 = moe.moe_ffn(p, x, cfg)
        assert torch.equal(first, again)
        assert all(torch.equal(aux[k], aux2[k]) for k in aux)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "command-r-35b",
                                  "gemma3-27b", "llama3-405b",
                                  "llama4-scout-17b-a16e", "musicgen-large",
                                  "qwen2-vl-72b"])
def test_model_zoo_prefill_with_kernels_matches_plain(cuda_device, arch):
    """Each of the seven at ``reduced()`` (fp32), T = 96 (past gemma3's
    reduced window): one prefill through the kernels against the plain
    route, the whole-model tolerance of tests/test_torch_archs.py (1e-3
    of the scale), logits and every cache entry; one attention launch a
    layer, two with cross-attention."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.models import Model
    cfg = get_config(arch).reduced()
    params = Model(cfg).init(seed=0, device=cuda_device)
    batch = concrete_batch(cfg, 2, 96, torch.Generator().manual_seed(1),
                           kind="prefill", device=cuda_device)
    build.reset_launches()
    got, cache = Model(cfg).prefill(params, batch)
    torch.cuda.synchronize()
    per_layer = 2 if cfg.cross_attn else 1
    assert dict(build.LAUNCHES) == {"flash_attention":
                                    per_layer * cfg.n_layers}
    want, want_cache = Model(cfg, impl="xla").prefill(params, batch)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert sorted(cache) == sorted(want_cache)
    for key, w in want_cache.items():
        assert float((cache[key] - w).abs().max()) <= 1e-3 * float(
            w.abs().max()), key


# ---------------------------------------------------- continuous batching
def _serve_on(device, arch, over, n_slots=2):
    """Four requests through ``n_slots`` slots of the reduced (fp32) arch,
    seed-0 params made on the CPU and copied to ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = get_config(arch).reduced(**over)
    model = Model(cfg)
    params = {k: v.to(device) for k, v in model.init(0, device="cpu").items()}
    rng = np.random.default_rng(0)
    b = ContinuousBatcher(model, params, n_slots=n_slots, max_len=96,
                          device=device)
    for uid, (n, m) in enumerate([(5, 6), (3, 6), (40, 30), (7, 6)]):
        b.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=m))
    b.run_until_drained()
    return {uid: r.generated for uid, r in b.completed.items()}, b.steps_run


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("qwen1.5-4b", {"n_layers": 2}),
                                       ("recurrentgemma-2b", {"n_layers": 4}),
                                       ("rwkv6-7b", {}), ("gemma3-27b", {})])
def test_the_batcher_on_the_card_gives_the_cpu_tokens(cuda_device, arch,
                                                      over):
    """The continuous batcher at ``reduced()`` (fp32), four requests
    through two slots (one past gemma3's and recurrentgemma's window of
    64): the card's tokens and steps are the CPU port's."""
    assert _serve_on(cuda_device, arch, over) == _serve_on("cpu", arch, over)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [("qwen1.5-4b", {"n_layers": 2}),
                                       ("recurrentgemma-2b", {"n_layers": 4}),
                                       ("rwkv6-7b", {}), ("gemma3-27b", {})])
def test_the_batcher_freezes_idle_slots_on_the_card(cuda_device, arch, over):
    """One slot active, three idle at their own positions, every cache
    entry random: after the slot step on the card each idle slot's rows
    are the same bits, the active slot's have moved."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import scheduler as sched
    cfg = get_config(arch).reduced(**over)
    model = Model(cfg)
    params = model.init(0, device=cuda_device)
    cache = model.init_cache(4, 32, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=g, device=cuda_device))
    before = {k: v.clone() for k, v in cache.items()}
    cur = torch.tensor([3, 10, 0, 20], dtype=torch.int32, device=cuda_device)
    tokens = torch.tensor([[1], [2], [3], [4]], dtype=torch.int32,
                          device=cuda_device)
    _, _, new_cur, cache = sched.make_slot_step(model)(
        params, cache, tokens, cur, np.array([False, True, False, False]))
    assert new_cur.tolist() == [3, 11, 0, 20]
    for key, v in cache.items():
        new = sched._slot_major(key, v)
        old = sched._slot_major(key, before[key])
        for i in (0, 2, 3):
            assert torch.equal(new[i], old[i]), (key, i)
        assert not torch.equal(new[1], old[1]), key


# ------------------------------------------------ NaN in the fp32 attention
@pytest.mark.cuda
def test_fp32_attention_keeps_planted_nans(cuda_device):
    """A NaN planted in q, k and v (forward) and in q, k, v and dO
    (backward) of the fp32-storage kernels, as torch's NaN (0x7fc00000),
    the card's arithmetic NaN (0x7fffffff) and that one negated: every row
    the NaN reaches by the attention's data flow is NaN in the kernels'
    outputs, and no row the plain version keeps finite
    (``chip_smoke.nan_rows_check``; phase 5 runs it at the prefill's
    shape)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(17)
    bh, bk, s, dh = 20, 4, 384, 256
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device)
               for shape in ((bh, s, dh), (bk, s, dh), (bk, s, dh)))
    assert smoke.nan_rows_check(q, k, v, dict(causal=True, window=200),
                                "fp32 attention")


@pytest.mark.cuda
def test_fp32_attention_nan_path_keeps_finite_bits(cuda_device):
    """The fp32 kernels run the split that keeps a NaN (cvt.rna's
    ``split``) only when a scan of the call's inputs finds one; for a
    finite operand it gives ``split_finite``'s bits. So a NaN planted in
    one query head changes no bit of the other heads' outputs and
    gradients (the same inputs, once through each split)."""
    from repro_torch.kernels import flash_attention as kfa
    gen = torch.Generator().manual_seed(23)
    bh, bk, s, dh = 8, 2, 256, 128
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda_device)
                   for shape in ((bh, s, dh), (bk, s, dh), (bk, s, dh),
                                 (bh, s, dh)))
    kw = dict(causal=True, window=100)
    o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    grads = kfa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    pq, pdo = q.clone(), do.clone()
    pq[bh - 1, 7, 3] = float("nan")          # the last head of kv head 1
    pdo[bh - 1, 9, 5] = float("nan")
    po, plse = kfa.flash_attention(pq, k, v, return_lse=True, **kw)
    pgrads = kfa.flash_attention_bwd(pq, k, v, o, pdo, lse=lse, **kw)
    keep = slice(0, bh - 1)
    assert bool(torch.isnan(po[bh - 1]).any())
    assert torch.equal(po[keep], o[keep]) and torch.equal(plse[keep],
                                                          lse[keep])
    assert torch.equal(pgrads[0][keep], grads[0][keep])
    # dk, dv of kv head 0 (heads 0..3) are free of the planted NaNs
    for g, pg in zip(grads[1:], pgrads[1:]):
        assert torch.equal(pg[0], g[0])


@pytest.mark.cuda
def test_fp32_attention_bwd_takes_an_lse_off_16_byte_alignment(cuda_device):
    """The backward leaves lse free of cp.async's 16-byte alignment, and
    its NaN scan reads lse too (in float4s only where it is aligned): an
    lse view 4 bytes into its buffer, with bh * sq a multiple of 4, gives
    the gradients of the aligned lse, bit for bit."""
    from repro_torch.kernels import flash_attention as kfa
    gen = torch.Generator().manual_seed(29)
    bh, bk, s, dh = 4, 2, 128, 64
    q, k, v, do = (torch.randn(shape, generator=gen).to(cuda_device)
                   for shape in ((bh, s, dh), (bk, s, dh), (bk, s, dh),
                                 (bh, s, dh)))
    kw = dict(causal=True)
    o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    buf = torch.empty(bh * s + 1, dtype=torch.float32, device=cuda_device)
    off = buf[1:].view(bh, s)
    off.copy_(lse)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    want = kfa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    got = kfa.flash_attention_bwd(q, k, v, o, do, lse=off, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------ the mesh and the roofline
@pytest.fixture
def nccl_pod_mesh(cuda_device):
    """The NCCL host mesh (world 1) with a 'pod' axis, closed at teardown."""
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_host_mesh((1,), ("pod",), device="cuda")
    yield mesh
    mesh_lib.close()


@pytest.mark.cuda
def test_nccl_host_mesh_gathers_and_reduces(nccl_pod_mesh):
    import torch.distributed as dist
    from repro_torch.sharding import collectives, rules
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    x = torch.arange(6, dtype=torch.float64).to(torch.complex128).reshape(
        2, 3).cuda()
    with collectives.record() as tally, nccl_pod_mesh:
        assert rules.current_mesh() is nccl_pod_mesh
        got = collectives.all_gather(x, nccl_pod_mesh, "pod")
        summed = collectives.all_reduce(x.clone(), nccl_pod_mesh, "pod")
    torch.cuda.synchronize()
    assert torch.equal(got, x) and torch.equal(summed, x)
    assert dict(tally.bytes_by_axis) == {"pod": 96 + 2 * 96}
    assert rules.current_mesh() is None


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["flat", "two_level"])
def test_kernel_round_fanout_is_the_batched_round(nccl_pod_mesh, topology):
    widths = (2, 3, 2)
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(1), 2, num_nodes=6, n_per_node=3,
        n_test=5, device="cuda")
    params = qnn.init_params(torch.Generator().manual_seed(2), widths,
                             device="cuda")
    cfg = fed.QuantumFedConfig(widths=widths, num_nodes=6, nodes_per_round=4,
                               interval_length=2, eps=0.05, impl="pallas",
                               topology=topology,
                               pods=2 if topology == "two_level" else None)
    want = fed.server_round(params, ds, torch.Generator().manual_seed(3),
                            cfg._replace(fanout="vmap"))
    build.reset_launches()
    with nccl_pod_mesh:
        got = fed.server_round(params, ds, torch.Generator().manual_seed(3),
                               cfg._replace(fanout="shard_map"))
    torch.cuda.synchronize()
    assert build.LAUNCHES["zgemm"] > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_trace_parse_finds_the_kernel_by_name(cuda_device):
    from repro_torch.roofline import trace_parse
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rand_c(rng, 3, 16, 16)).cuda()
    b = torch.as_tensor(rand_c(rng, 3, 16, 16)).cuda()
    ops.complex_matmul(a, b)
    trace = trace_parse.profile(lambda: ops.complex_matmul(a, b))
    us, n = trace.by_family["zgemm"]
    assert n == 1 and us > 0
    assert 0 < trace.busy_share <= 1
    work = trace_parse.count(lambda: ops.complex_matmul(a, b))
    assert work.kernels["zgemm"][:3] == [1, 8 * 3 * 16 ** 3,
                                         16 * 3 * 3 * 16 * 16]


# ------------------------------------------- the sharded step, q_offset
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("dh,heads,kv,window", [(256, 10, 1, 64),
                                                (128, 4, 4, 0),
                                                (64, 6, 2, 0)])
def test_q_offset_rows_are_the_full_calls_rows(cuda_device, dh, heads, kv,
                                               window, dtype):
    """Queries [S/2, S) at q_offset S/2 (a multiple of the 128-row tile)
    give the full call's forward, LSE and dq rows bit for bit; dk, dv
    match the plain version with the same offset (bf16 within 2^-7 of
    their scale, fp32 within 1e-5)."""
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator(device="cpu").manual_seed(dh + heads)
    s, off = 512, 256
    q = torch.randn((heads, s, dh), generator=g).to(cuda_device, dtype)
    k, v = (torch.randn((kv, s, dh), generator=g).to(cuda_device, dtype)
            for _ in range(2))
    kw = dict(causal=True, window=window)
    full, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    qo = q[:, off:].contiguous()
    got, lse_o = kfa.flash_attention(qo, k, v, return_lse=True, q_offset=off,
                                     **kw)
    assert torch.equal(got, full[:, off:]) and torch.equal(lse_o,
                                                           lse[:, off:])
    assert not torch.equal(kfa.flash_attention(qo, k, v, **kw), got)
    do = torch.randn(full.shape, generator=g).to(cuda_device, dtype)
    dq = kfa.flash_attention_bwd(q, k, v, full, do, lse=lse, **kw)[0]
    do_o = do[:, off:].contiguous()
    dq_o, dk_o, dv_o = kfa.flash_attention_bwd(qo, k, v, got, do_o,
                                               lse=lse_o, q_offset=off, **kw)
    assert torch.equal(dq_o, dq[:, off:])
    want = ref.attention_bwd_ref(qo.float(), k.float(), v.float(),
                                 got.float(), do_o.float(), lse=lse_o,
                                 q_offset=off, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for x, w in zip((dq_o, dk_o, dv_o), want):
        assert float((x.float() - w).abs().max()) <= tol * float(
            w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_q_offset_negative_refused(cuda_device, dtype):
    """Both dtypes take any offset >= 0 and refuse a negative one."""
    from repro_torch.kernels import flash_attention as kfa
    x = torch.randn((2, 256, 64), device=cuda_device).to(dtype)
    lse = torch.zeros((2, 256), device=cuda_device)
    with pytest.raises(ValueError, match="q_offset"):
        kfa.flash_attention(x, x, x, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset"):
        kfa.flash_attention_bwd(x, x, x, x, x, lse=lse, q_offset=-128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_q_offset_ops_route_matches_the_plain_route(cuda_device, dtype):
    """``ops.attention`` with an offset (the context-parallel shard's
    call) through the kernels against the plain route: the output within
    RTOL (fp32) or 2^-7 (bf16) of its scale, the gradients of q
    and of k (also v) within the backprop test's BWD_RTOL or 2^-6."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn((2, 256, 4, 128), generator=g).to(cuda_device, dtype)
    k = torch.randn((2, 512, 2, 128), generator=g).to(cuda_device, dtype)
    do = torch.randn(q.shape, generator=g).to(cuda_device, dtype)
    fp32 = dtype == torch.float32
    tols = (RTOL if fp32 else 2 ** -7,) + (
        BWD_RTOL if fp32 else 2 ** -6,) * 2
    outs = []
    for impl in ("pallas", "xla"):
        qi, ki = (x.detach().clone().requires_grad_() for x in (q, k))
        out = ops.attention(qi, ki, ki, q_offset=256, impl=impl)
        out.backward(do)
        outs.append((out.detach(), qi.grad, ki.grad))
    for got, want, tol in zip(*outs, tols):
        assert float((got.float() - want.float()).abs().max()) <= tol * \
            float(want.float().abs().max())


@pytest.mark.cuda
def test_gla_backward_workspace_formula_is_the_c_entrys(cuda_device):
    from repro_torch.kernels import gla_chunked as kgla
    lib = build.load()
    for b, s, h in ((1, 4096, 64), (2, 17, 3), (4, 4097, 1)):
        for part in range(3):
            assert kgla.bwd_workspace_floats(b, s, h, part) == \
                lib.qf_gla_chunked_bwd_workspace(b, s, h, part)


@pytest.mark.cuda
def test_registered_ops_fakes_are_the_wrappers_allocations(cuda_device):
    """Each sequence op's fake (``FakeTensorMode``) gives the shapes and
    dtypes of what the real op returns on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator(device="cpu").manual_seed(4)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(cuda_device, dtype)
    q, k = draw(6, 256, 128), draw(2, 256, 128)
    r = draw(1, 64, 2, 64)
    w = torch.rand((1, 64, 2, 64), generator=g).to(cuda_device)
    u = draw(2, 64, dtype=torch.float32)
    a = draw(2, 64, 32, dtype=torch.float32)
    calls = [
        lambda *x: torch.ops.repro_torch.flash_attention(*x, True, 0, 0,
                                                         True),
        lambda *x: torch.ops.repro_torch.rglru_scan(*x),
        lambda *x: torch.ops.repro_torch.gla_chunked(*x, 16)]
    args = [(q, k, k), (a, a), (r, r, r, w, u)]
    out, lse = calls[0](*args[0])
    args.append((q, k, k, out, out, lse))
    calls.append(lambda *x: torch.ops.repro_torch.flash_attention_bwd(
        *x, True, 0, 0))
    args.append((r, r, r, w, u, r, None))
    calls.append(lambda *x: torch.ops.repro_torch.gla_chunked_bwd(*x, 16))
    for call, xs in zip(calls, args):
        real = call(*xs)
        real = real if isinstance(real, (tuple, list)) else (real,)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = call(*(None if x is None else mode.from_tensor(x)
                          for x in xs))
        fake = fake if isinstance(fake, (tuple, list)) else (fake,)
        assert [(tuple(x.shape), x.dtype) for x in real] == \
            [(tuple(x.shape), x.dtype) for x in fake]


@pytest.fixture
def nccl_world1_mesh(cuda_device):
    """The NCCL host mesh (world 1) with ('data', 'model'), closed at
    teardown."""
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_host_mesh((1, 1), ("data", "model"), device="cuda")
    yield mesh
    mesh_lib.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b",
                                  "llama4-scout-17b-a16e"])
def test_sharded_step_on_a_world1_mesh_is_the_plain_step(nccl_world1_mesh,
                                                         arch):
    """A reduced bf16 train step with DTensor params, moments and batch
    on the NCCL world-1 mesh, through the kernels: the same bits as the
    plain step, and the same launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import BATCH_AXES, concrete_batch
    from repro_torch.launch.steps import make_train_step, shard_tree
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    cfg = get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16")
    model = Model(cfg)
    opt = AdamW()
    step = make_train_step(model, opt)
    batch = concrete_batch(cfg, 2, 64, torch.Generator().manual_seed(0),
                           device="cuda")
    out = {}
    for side in ("plain", "sharded"):
        params = model.init(seed=0, device="cuda")
        b = batch
        if side == "sharded":
            params = shard_tree(params, model.param_axes(), nccl_world1_mesh)
            b = shard_tree(batch, BATCH_AXES, nccl_world1_mesh)
        build.reset_launches()
        params, _, metrics = step(params, opt.init(params), b, 1e-3)
        torch.cuda.synchronize()
        out[side] = ({k: getattr(v, "to_local", lambda: v)()
                      for k, v in params.items()}, dict(build.LAUNCHES),
                     getattr(metrics["loss"], "to_local",
                             lambda: metrics["loss"])())
    (pp, pl, ploss), (sp, sl, sloss) = out["plain"], out["sharded"]
    assert pl == sl and any(pl.values())
    assert torch.equal(ploss, sloss)
    assert all(torch.equal(pp[k], sp[k]) for k in pp)
