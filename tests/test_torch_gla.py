"""The port's chunked GLA (RWKV6 wkv) through its plain PyTorch version
(CPU).

``repro_torch.kernels.ref.gla_chunked_ref`` is the CUDA kernel's plain
version (fp32 arithmetic, out in r's dtype, the final state in fp32).
It is held against the reference's chunked form
(``repro.models.layers.rwkv.gla_chunked_ref``, out and state), its step
recurrence (``repro.kernels.ref.gla_recurrence_ref``) and the Pallas TPU
kernel in interpret mode, on the inputs of ``tests/test_kernels.py``
drawn with numpy. Tolerances, relative to the output's scale: 1e-5 in
fp32 (every path is fp32 arithmetic; only the order of the sums and
of the cumulative log-decay differ, measured ~1e-6) and the reference's
own 5e-2 in bf16, where r, k, v are rounded before and out after.
``tests/test_torch_cuda.py`` covers the launches on a card."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gla_chunked import gla_chunked as jpallas  # noqa: E402
from repro.models.layers.rwkv import gla_chunked_ref as jchunked  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import gla_chunked as kgla  # noqa: E402

TOL32 = 1e-5
TOL16 = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the RWKV6 block's clip ends: w = exp(-exp(4)) and exp(-exp(-12))
W_LOW = float(np.float32(np.exp(-np.exp(4.0))))
W_HIGH = float(np.float32(np.exp(-np.exp(-12.0))))


def rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def gla_inputs(seed, b, s, h, dh, w=None):
    """numpy r, k, v, w, u as in tests/test_kernels.py::gla_inputs."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, dh)) for _ in range(3))
    if w is None:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h, dh)))) \
            * 0.5 + 0.45
    u = 0.3 * rng.standard_normal((h, dh))
    return [np.asarray(x, np.float32) for x in (r, k, v, w, u)]


def both(arrays, dtype="float32"):
    """r, k, v (and u) in ``dtype``; w stays fp32, as the model hands it."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(x).astype(jnp.float32 if i == 3 else jdt)
         for i, x in enumerate(arrays)]
    t = [torch.as_tensor(x).to(torch.float32 if i == 3 else tdt)
         for i, x in enumerate(arrays)]
    return j, t


CASES = [(32, 8), (64, 16), (64, 64), (48, 16), (17, 1)]


@pytest.mark.parametrize("s,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_chunked_form(s, chunk, dtype):
    j, t = both(gla_inputs(s + chunk, 2, s, 2, 8), dtype)
    out, state = ref.gla_chunked_ref(*t, chunk)
    jout, jstate = jchunked(*j, chunk)
    assert out.dtype == t[0].dtype and out.shape == (2, s, 2, 8)
    assert state.dtype == torch.float32 and state.shape == (2, 2, 8, 8)
    tol = TOL16 if dtype == "bfloat16" else TOL32
    assert rel(out, jout) <= tol
    assert rel(state, jstate) <= TOL32    # fp32 from the same bf16 inputs


@pytest.mark.parametrize("s,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_recurrence_and_pallas(s, chunk, dtype):
    j, t = both(gla_inputs(s * chunk, 2, s, 2, 8), dtype)
    out, _ = ref.gla_chunked_ref(*t, chunk)
    tol = TOL16 if dtype == "bfloat16" else TOL32
    assert rel(out, jref.gla_recurrence_ref(*j)) <= tol
    assert rel(out, jpallas(*j, chunk=chunk, interpret=True)) <= tol
    assert rel(ref.gla_recurrence_ref(*t), jref.gla_recurrence_ref(*j)) <= tol


def test_extreme_decay():
    """Decays near 0 and near 1 in one sequence (the reference's
    test_gla_kernel_extreme_decay), zero bonus."""
    rng = np.random.default_rng(3)
    w = np.where(rng.random((1, 32, 1, 4)) < 0.5, 0.999, 1e-3)
    arrays = gla_inputs(3, 1, 32, 1, 4, w=w)
    arrays[4][:] = 0.0
    j, t = both(arrays)
    out, _ = ref.gla_chunked_ref(*t, 8)
    assert bool(torch.isfinite(out).all())
    assert rel(out, jref.gla_recurrence_ref(*j)) <= TOL32
    assert rel(out, jpallas(*j, chunk=8, interpret=True)) <= TOL32


@pytest.mark.parametrize("chunk", [16, 1])
def test_decay_at_the_clip_ends(chunk):
    """w at exp(-e^4) ~ 1.9e-24, below the 1e-20 clamp of log w, and at
    exp(-e^-12) = 1 - 6.1e-6: the clamp is live, and nothing overflows
    (the cumulative log-decay reaches 16 x -46 inside one chunk)."""
    rng = np.random.default_rng(4)
    w = np.where(rng.random((2, 48, 2, 8)) < 0.5, W_LOW, W_HIGH)
    assert W_LOW < 1e-20 and W_HIGH < 1.0
    j, t = both(gla_inputs(4, 2, 48, 2, 8, w=w))
    out, state = ref.gla_chunked_ref(*t, chunk)
    jout, jstate = jchunked(*j, chunk)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    assert rel(out, jout) <= TOL32 and rel(state, jstate) <= TOL32
    assert rel(out, jpallas(*j, chunk=chunk, interpret=True)) <= TOL32
    # the clamp: 1.9e-24 and 1e-20 give the same result
    t[3] = torch.clamp_min(t[3], 1e-20)
    again, _ = ref.gla_chunked_ref(*t, chunk)
    assert torch.equal(out, again)


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: the low 13 of the 23
    mantissa bits rounded to nearest, ties away from zero (an add of half
    their range to the magnitude, then a mask)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(eq, a, b, terms=3):
    """einsum ``eq`` of fp32 a and b as the tensor-core path runs it: each
    operand split into TF32 hi + lo, the products hi hi, hi lo and lo hi
    (``terms`` = 1: hi hi alone) exact, summed in fp64 and rounded once to
    fp32 (the accumulation order inside mma.sync is the card's)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = [(ah, bh), (ah, bl), (al, bh)][:terms]
    return sum(torch.einsum(eq, x.double(), y.double())
               for x, y in pairs).float()


def gla_3xtf32(r, k, v, w, u, chunk, terms=3):
    """The chunked form with its three products in 3xTF32, in the CUDA
    kernel's order on its tensor-core path (csrc/gla_chunked.cu, a stage
    of one chunk): per chunk the inter term from the state before it,
    the state decayed then the update added, and out = inter +
    scores @ v; the pairwise scores, decays and logs in fp32 as
    ``ref.gla_chunked_ref`` forms them. Returns fp32 out and state."""
    b, s, h, dh = r.shape
    n = s // chunk
    r_, k_, v_ = (x.float().reshape(b, n, chunk, h, dh) for x in (r, k, v))
    logw = torch.log(torch.clamp_min(w.float(), 1e-20)).reshape(
        b, n, chunk, h, dh)
    lp = torch.cumsum(logw, 2)
    for t in range(1, chunk):             # left to right, as the kernel
        lp[:, :, t] = lp[:, :, t - 1] + logw[:, :, t]
    lp_prev = lp - logw
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril(-1)
    pair = (lp_prev[:, :, :, None] - lp[:, :, None]).exp()   # b n t i h c
    scores = (pair * r_[:, :, :, None] * k_[:, :, None]).sum(-1)
    scores = torch.where(tri[:, :, None], scores, 0.0)        # b n t i h
    diag = (r_ * k_ * u.float()).sum(-1)                      # b n t h
    scores = scores + torch.diag_embed(diag.transpose(-1, -2)).permute(
        0, 1, 3, 4, 2)
    q_dec = r_ * torch.exp(lp_prev)
    k_dec = k_ * torch.exp(lp[:, :, -1:] - lp)
    decay = torch.exp(lp[:, :, -1])[..., None]                # b n h c 1
    state = torch.zeros((b, h, dh, dh))
    out = torch.empty((b, n, chunk, h, dh))
    for i in range(n):
        inter = mm_3xtf32("bthc,bhce->bthe", q_dec[:, i], state, terms)
        state = decay[:, i] * state + mm_3xtf32(
            "bthc,bthe->bhce", k_dec[:, i], v_[:, i], terms)
        out[:, i] = inter + mm_3xtf32("btih,bihe->bthe", scores[:, i],
                                      v_[:, i], terms)
    return out.reshape(b, s, h, dh), state


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12 - 2.0 ** -20])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tf32(x), want)


# 3xTF32 keeps each product to ~2^-22 of itself: against the plain
# chunked form at the same chunk the tensor-core path's arithmetic is held
# to 1e-6 of the scale, ten times tighter than the fp32 tolerance
TOL_3XTF32 = 1e-6


@pytest.mark.parametrize("chunk", [16, 12])
@pytest.mark.parametrize("w_kind", ["random", "clip ends"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_3xtf32_products_hold_the_fp32_function(chunk, w_kind, dtype):
    """The tensor-core path's arithmetic (3xTF32 products) against the
    port's plain chunked form (1e-6 of the scale), the Pallas kernel in
    interpret mode (1e-5) and the reference's step recurrence, on random
    decays and at the decay clip's ends (as test_decay_at_the_clip_ends);
    bf16-rounded r, k, v (v exact in TF32) too. At the clip's ends the
    chunked form itself is up to ~3e-5 off the recurrence (the cumulative
    log-decay reaches 16 x -46, rounded in fp32), so there the emulation
    is held to no more than the plain form's distance plus 1e-6; with
    random decays to 1e-5. One TF32 product alone (hi x hi) misses the
    fp32 tolerance against the plain form."""
    s = 48 if chunk == 16 else 36
    rng = np.random.default_rng(6)
    w = (np.where(rng.random((2, s, 2, 8)) < 0.5, W_LOW, W_HIGH)
         if w_kind == "clip ends" else None)
    arrays = gla_inputs(6, 2, s, 2, 8, w=w)
    if dtype == "bfloat16":
        arrays[:3] = [np.asarray(torch.as_tensor(x).bfloat16().float())
                      for x in arrays[:3]]
    j, t = both(arrays)
    out, state = gla_3xtf32(*t, chunk)
    plain, plain_state = ref.gla_chunked_ref(*t, chunk)
    assert bool(torch.isfinite(out).all())
    assert rel(out, plain) <= TOL_3XTF32
    assert rel(state, plain_state) <= TOL_3XTF32
    assert rel(out, jpallas(*j, chunk=chunk, interpret=True)) <= TOL32
    rec = jref.gla_recurrence_ref(*j)
    limit = rel(plain, rec) + TOL_3XTF32 if w_kind == "clip ends" else TOL32
    assert rel(out, rec) <= limit
    one, _ = gla_3xtf32(*t, chunk, terms=1)
    assert rel(one, plain) > TOL32


def test_keyless_first_token_gets_only_the_bonus():
    j, t = both(gla_inputs(5, 1, 16, 2, 8))
    r, k, v, _, u = t
    out, _ = ref.gla_chunked_ref(*t, 8)
    bonus = (r[:, 0] * k[:, 0] * u).sum(-1, keepdim=True) * v[:, 0]
    assert float((out[:, 0] - bonus).abs().max()) <= 1e-6


def test_chunk_size_invariance():
    """The same function at every chunk that divides S (as in
    tests/test_property.py::test_gla_chunk_size_invariance), out and
    state."""
    _, t = both(gla_inputs(6, 1, 48, 2, 4))
    want, want_state = ref.gla_chunked_ref(*t, 1)
    for chunk in (2, 3, 4, 6, 8, 12, 16, 24, 48):
        out, state = ref.gla_chunked_ref(*t, chunk)
        assert rel(out, want) <= 2e-6, chunk
        assert rel(state, want_state) <= 2e-6, chunk


def test_small_slabs_give_the_same_result(monkeypatch):
    """The pairwise decay tensor is built a slab of chunks at a time."""
    _, t = both(gla_inputs(7, 2, 64, 2, 8))
    want, want_state = ref.gla_chunked_ref(*t, 16)
    monkeypatch.setattr(ref, "GLA_SLAB_ELEMS", 1)
    out, state = ref.gla_chunked_ref(*t, 16)
    assert torch.equal(out, want) and torch.equal(state, want_state)


# ---------------------------------------------------------------- dispatch
def test_ops_on_cpu_take_the_plain_version():
    _, t = both(gla_inputs(8, 1, 32, 2, 8))
    j, _ = both(gla_inputs(8, 1, 32, 2, 8))
    want, want_state = ref.gla_chunked_ref(*t, 16)
    before = dict(build.LAUNCHES)
    for impl in ("pallas", "xla"):
        out, state = ops.gla_chunked(*t, chunk=16, impl=impl)
        assert torch.equal(out, want) and torch.equal(state, want_state)
        assert torch.equal(ops.wkv(*t, chunk=16, impl=impl), want)
    assert dict(build.LAUNCHES) == before  # no kernel ran
    # the reference's ops.wkv plain route is the step recurrence
    assert rel(ops.wkv(*t, chunk=16), jops.wkv(*j, chunk=16, impl="xla")) \
        <= TOL32
    with pytest.raises(ValueError, match="impl"):
        ops.wkv(*t, impl="triton")
    with pytest.raises(ValueError, match="divide"):
        ops.gla_chunked(*t, chunk=5)


def test_wrapper_refuses_cpu_tensors():
    _, t = both(gla_inputs(9, 1, 16, 2, 8))
    with pytest.raises(ValueError, match="CUDA kernel"):
        kgla.gla_chunked(*t, chunk=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kgla.gla_chunked(*(x.double() for x in t), chunk=16)


@pytest.mark.parametrize("chunk,sub", [(1, 1), (16, 16), (64, 64),
                                       (128, 64), (96, 48), (67, 1)])
def test_kernel_sub_chunk(chunk, sub):
    """Chunks above the kernel's 64 run as sub-chunks that divide them."""
    assert kgla.kernel_chunk(chunk) == sub


def test_kernel_is_built_and_bound():
    names = {p.name for p in build._sources()}
    assert "gla_chunked.cu" in names
    argtypes, _ = build._SIGNATURES["qf_gla_chunked"]
    assert argtypes[:7] == [build._VP] * 7
    assert argtypes[7:14] == [build._INT] * 7
    assert argtypes[-1] is build._VP          # the stream
    text = (build.CSRC / "gla_chunked.cu").read_text()
    assert 'extern "C" int qf_gla_chunked(' in text
    assert "src/repro/kernels/gla_chunked.py:73" in text
