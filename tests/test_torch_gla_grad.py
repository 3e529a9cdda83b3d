"""The gradient of the port's chunked GLA (RWKV6 wkv) on the CPU: the
plain backward ``ref.gla_chunked_bwd_ref`` (the CUDA kernel
``csrc/gla_chunked_bwd.cu``'s plain version) and ``ops``'s autograd
Function ``_GlaChunkedFn`` with its kernels swapped for their plain
versions.

The same numpy inputs go through the port and through ``jax.vjp`` of the
reference's ``repro.models.layers.rwkv.gla_chunked_ref`` (the function
XLA differentiates to train RWKV6), with and without a cotangent of the
final state. Tolerances, relative to each gradient's scale:

- fp32, against autodiff of the chunked form (torch's of
  ``ref.gla_chunked_ref``, and the reference's): 1e-5, as
  tests/test_torch_gla.py holds the forward;
- against the fp64 function (``chip_smoke.gla_bwd_fp64``, the step
  recurrence in fp64): 1e-6. Measured here the plain backward stays
  within 2.2e-7 of it in every case below, the clip's ends included.

At the decay clip's ends the chunked form is itself up to 2.5e-5 off the
fp64 function at chunk 16 (its cumulative log-decay reaches 16 x -46 in
fp32), so there autodiff is held at its own distance from fp64 plus
1e-6. Two faults of the reference's autodiff show here, and the tests
pin them: its dw is NaN once the masked upper triangle's exp overflows
(at chunks of 4 and more at the clip's ends; the port's plain forward
masks the exponent first and is finite), and at strong decays its dw is
0 where the function's is O(1), since d(log w) comes out of sums that
cancel; the gradient of the decay's logit, dw w, is unharmed.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.layers.rwkv import gla_chunked_ref as jchunked  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import gla_chunked as kgla  # noqa: E402

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

TOL32 = 1e-5
TOL64 = 1e-6
NAMES = ("dr", "dk", "dv", "dw", "du")
# the RWKV6 block's clip ends: w = exp(-exp(4)) and exp(-exp(-12))
W_LOW = float(np.float32(np.exp(-np.exp(4.0))))
W_HIGH = float(np.float32(np.exp(-np.exp(-12.0))))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rel(got, want):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want.detach().double() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def inputs(seed, b, s, h, dh, w="random"):
    """numpy r, k, v, w, u, dout and a final-state cotangent; w drawn as
    tests/test_torch_gla.py draws it, at the clip's ends, or as the
    RWKV6 block's exp(-exp(x)) with x uniform over its clip [-12, 4]."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, dh)) for _ in range(3))
    if w == "ends":
        w = np.where(rng.random((b, s, h, dh)) < 0.5, W_LOW, W_HIGH)
    elif w == "model":
        w = np.exp(-np.exp(rng.uniform(-12.0, 4.0, (b, s, h, dh))))
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h, dh)))) \
            * 0.5 + 0.45
    u = 0.3 * rng.standard_normal((h, dh))
    do = rng.standard_normal((b, s, h, dh))
    ds = rng.standard_normal((b, h, dh, dh))
    return [np.asarray(x, np.float32) for x in (r, k, v, w, u, do, ds)]


def torch_autodiff(t, chunk, with_state):
    """torch autograd of the port's plain chunked form."""
    xs = [x.clone().requires_grad_() for x in t[:5]]
    out, state = ref.gla_chunked_ref(*xs, chunk)
    loss = (out * t[5]).sum()
    if with_state:
        loss = loss + (state * t[6]).sum()
    return torch.autograd.grad(loss, xs)


def jax_vjp(a, chunk, with_state):
    """jax.vjp of the reference's chunked form, out's (and the final
    state's) cotangent."""
    _, vjp = jax.vjp(lambda *x: jchunked(*x, chunk),
                     *(jnp.asarray(x) for x in a[:5]))
    ds = a[6] if with_state else np.zeros_like(a[6])
    return [np.asarray(g) for g in vjp((jnp.asarray(a[5]), jnp.asarray(ds)))]


def plain(t, chunk, with_state):
    return ref.gla_chunked_bwd_ref(*t[:6], t[6] if with_state else None,
                                   chunk)


CASES = [(48, 16), (64, 16), (20, 4), (17, 1)]


@pytest.mark.parametrize("s,chunk", CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_matches_autodiff_and_the_reference(s, chunk,
                                                           with_state):
    a = inputs(s + chunk, 2, s, 2, 8)
    t = [torch.as_tensor(x) for x in a]
    got = plain(t, chunk, with_state)
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert [tuple(g.shape) for g in got] == [(2, s, 2, 8)] * 4 + [(2, 8)]
    auto = torch_autodiff(t, chunk, with_state)
    jgot = jax_vjp(a, chunk, with_state)
    exact = chip_smoke.gla_bwd_fp64(*t[:6], t[6] if with_state else None)
    for name, g, x, j, e in zip(NAMES, got, auto, jgot, exact):
        assert rel(g, x) <= TOL32, name
        assert rel(g, j) <= TOL32, name
        assert rel(g, e) <= TOL64, name


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_at_the_decay_clip_ends(chunk, with_state):
    """w at exp(-e^4) ~ 1.9e-24 (below the 1e-20 clamp: dw = 0 there) and
    1 - 6.1e-6: the plain backward within 1e-6 of the fp64 function;
    autodiff of the chunked form within its own distance from fp64 plus
    1e-6 (at chunk 16 that distance is up to 2.5e-5). The reference's dw
    is NaN at chunks of 4 and 16 (its masked exp overflows); the port's
    plain forward differentiates to a finite dw."""
    a = inputs(4 + chunk, 2, 48, 2, 8, w="ends")
    t = [torch.as_tensor(x) for x in a]
    got = plain(t, chunk, with_state)
    exact = chip_smoke.gla_bwd_fp64(*t[:6], t[6] if with_state else None)
    auto = torch_autodiff(t, chunk, with_state)
    jgot = jax_vjp(a, chunk, with_state)
    assert bool((got[3][t[3] < 1e-20] == 0).all())
    for i, name in enumerate(NAMES):
        assert rel(got[i], exact[i]) <= TOL64, name
        limit = max(TOL32, rel(auto[i], exact[i]) + TOL64)
        assert rel(got[i], auto[i]) <= limit, name
        if name == "dw" and chunk > 1:
            assert np.isnan(jgot[i]).any()
            assert bool(torch.isfinite(auto[i]).all())
        else:
            assert rel(got[i], jgot[i]) <= max(
                TOL32, rel(jgot[i], exact[i]) + TOL64), name


@pytest.mark.parametrize("chunk", [1, 16])
def test_plain_backward_at_strong_decays(chunk):
    """w = exp(-exp(x)) with x over the whole clip, as the RWKV6 block
    draws it: the plain backward within 1e-6 of the fp64 function; the
    chunked form's autodiff puts dw at 0 (or far off) where the function's
    is O(1), since its d(log w) is a difference of sums that cancel, yet
    dw w, what reaches the decay's logit, agrees within 1e-5."""
    a = inputs(9, 2, 48, 2, 8, w="model")
    t = [torch.as_tensor(x) for x in a]
    got = plain(t, chunk, False)
    exact = chip_smoke.gla_bwd_fp64(*t[:6])
    for name, g, e in zip(NAMES, got, exact):
        assert rel(g, e) <= TOL64, name
    auto = torch_autodiff(t, chunk, False)
    assert rel(auto[3], exact[3]) > 1e-2
    assert rel(auto[3] * t[3], exact[3] * t[3].double()) <= TOL32
    assert rel(got[3] * t[3], exact[3] * t[3].double()) <= TOL64


def test_plain_backward_in_bf16():
    """bf16 r, k, v and dout, w fp32 (as the model hands them over): the
    fp32 arithmetic of the same values, each gradient rounded once."""
    a = inputs(10, 2, 32, 2, 8)
    t = [torch.as_tensor(x) for x in a]
    for i in (0, 1, 2, 5):
        t[i] = t[i].bfloat16()
    got = ref.gla_chunked_bwd_ref(*t[:6], None, 16)
    want = ref.gla_chunked_bwd_ref(*(x.float() for x in t[:6]), None, 16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for name, g, x in zip(NAMES, got, want):
        assert rel(g.float(), x) <= 2.0 ** -8, name


def test_dropping_the_carried_state_gradient_fails():
    """The control: the same backward with dS dropped at every 16-token
    boundary (``chip_smoke.gla_bwd_dropped_carry``, the planted fault of
    phase 11b) misses autodiff and the fp64 function by far more than the
    tolerances."""
    a = inputs(11, 2, 48, 2, 8)
    t = [torch.as_tensor(x) for x in a]
    bad = chip_smoke.gla_bwd_dropped_carry(
        lambda *x, chunk: ref.gla_chunked_bwd_ref(*x, chunk), t, 16)
    good = plain(t, 16, True)
    auto = torch_autodiff(t, 16, True)
    exact = chip_smoke.gla_bwd_fp64(*t[:6], t[6])
    for name, g, x, e in zip(NAMES, good, auto, exact):
        assert rel(g, x) <= TOL32 and rel(g, e) <= TOL64, name
    # dS reaches dk, dv and dw; dr and du do not depend on it
    devs = {name: rel(g, x) for name, g, x in zip(NAMES, bad, auto)}
    assert all(devs[n] > 100 * TOL32 for n in ("dk", "dv", "dw")), devs
    assert devs["dr"] <= TOL32 and devs["du"] <= TOL32, devs


def test_plain_backward_refuses_a_chunk_that_does_not_divide():
    t = [torch.as_tensor(x) for x in inputs(12, 1, 16, 1, 4)]
    with pytest.raises(ValueError, match="divide"):
        ref.gla_chunked_bwd_ref(*t[:6], None, 5)


def _count(name, fn):
    def counted(*args, **kw):
        build.LAUNCHES[name] += 1
        return fn(*args, **kw)
    return counted


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_the_card_route_differentiates_through_both_kernels(
        monkeypatch, dtype, with_state):
    """``ops.gla_chunked``'s card route on the CPU, the kernels swapped
    for their plain versions (counted): one forward and one backward
    launch; the backward gets out's cotangent in r's dtype and the final
    state's, or None where the state does not reach the loss; the
    gradients are the plain backward's, in r's, w's and u's dtypes and
    shapes, as autograd of the plain route gives them."""
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    seen = []

    def bwd(r, k, v, w, u, dout, dstate, *, chunk):
        assert dout.dtype == r.dtype and dout.is_contiguous()
        assert u.dtype == torch.float32
        seen.append(dstate)
        return ref.gla_chunked_bwd_ref(r, k, v, w, u, dout, dstate, chunk)
    monkeypatch.setattr(kgla, "gla_chunked", _count(
        "gla_chunked", lambda *x, chunk: ref.gla_chunked_ref(*x, chunk)))
    monkeypatch.setattr(kgla, "gla_chunked_bwd", _count("gla_chunked_bwd",
                                                         bwd))
    a = inputs(13, 2, 32, 2, 8)
    t = [torch.as_tensor(x) for x in a]
    t[0], t[1], t[2], t[4] = (x.to(dtype) for x in (t[0], t[1], t[2], t[4]))
    xs = [x.clone().requires_grad_() for x in t[:5]]
    build.reset_launches()
    out, state = ops.gla_chunked(*xs, chunk=16)
    loss = (out.float() * t[5]).sum()
    if with_state:
        loss = loss + (state * t[6]).sum()
    got = torch.autograd.grad(loss, xs)
    assert dict(build.LAUNCHES) == {"gla_chunked": 1, "gla_chunked_bwd": 1}
    build.reset_launches()
    assert (seen[0] is None) != with_state
    assert [g.dtype for g in got] == [dtype] * 3 + [torch.float32, dtype]
    assert [g.shape for g in got] == [x.shape for x in xs]
    ys = [x.clone().requires_grad_() for x in t[:5]]
    out, state = ops.gla_chunked(*ys, chunk=16, impl="xla")
    loss = (out.float() * t[5]).sum()
    if with_state:
        loss = loss + (state * t[6]).sum()
    want = torch.autograd.grad(loss, ys)
    tol = TOL32 if dtype == torch.float32 else 2.0 ** -7
    for name, g, x in zip(NAMES, got, want):
        assert rel(g.float(), x.float()) <= tol, name


def test_the_card_route_never_takes_the_plain_version(monkeypatch):
    """With the kernel route chosen, CPU tensors reach the kernels'
    wrappers, which refuse them, whether or not autograd records."""
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    t = [torch.as_tensor(x) for x in inputs(14, 1, 16, 2, 8)]
    r = t[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.gla_chunked(r, *t[1:5], chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel"):
        ops.gla_chunked(r, *t[1:5], chunk=16)


def test_backward_wrapper_refuses_bad_operands():
    t = [torch.as_tensor(x) for x in inputs(15, 1, 16, 2, 8)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        kgla.gla_chunked_bwd(*t[:6], chunk=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kgla.gla_chunked_bwd(*(x.double() for x in t[:6]), chunk=16)


def test_backward_kernel_is_built_and_bound():
    names = {p.name for p in build._sources()}
    assert "gla_chunked_bwd.cu" in names
    argtypes, _ = build._SIGNATURES["qf_gla_chunked_bwd"]
    assert argtypes[:15] == [build._VP] * 15
    assert argtypes[15:21] == [build._INT] * 6
    assert argtypes[-1] is build._VP          # the stream
    text = (build.CSRC / "gla_chunked_bwd.cu").read_text()
    assert 'extern "C" int qf_gla_chunked_bwd(' in text
    argtypes, _ = build._SIGNATURES["qf_gla_chunked_bwd_tma"]
    assert argtypes == [build._VP] * 6 + [build._INT] * 3
    assert 'extern "C" int qf_gla_chunked_bwd_tma(' in text
    assert "src/repro/models/layers/rwkv.py:80" in text
    assert "atomicAdd" not in text            # repeatable bit for bit


# ---- the backward kernel's cut schedule, emulated in fp32 torch

D, SUB, ROWS = 64, 16, 16      # the kernel's state width, sub-stage, rows


def _lr(x):
    """x (..., n) summed left to right (zeros for n = 0)."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i] if i else x[..., 0]
    return acc


def _tree(x):
    """x (..., 2^m) summed as the kernel's xor butterflies sum it: the
    pairs (i, i + n / 2) first, then the halves' pairs, and so on."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _pairs(x):
    """x (..., n) summed as the kernel sums warps and blocks: adjacent
    pairs first, ((x0 + x1) + (x2 + x3)) + .., and three as
    (x0 + x1) + x2."""
    if x.shape[-1] == 3:
        return (x[..., 0] + x[..., 1]) + x[..., 2]
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def cut_schedule(r, k, v, w, u, dout, dstate, stage):
    """``csrc/gla_chunked_bwd.cu``'s decomposition in fp32 torch: the
    per-entry scans write S before every ``stage`` tokens and dS after
    every stage's last token; each stage then runs from its two
    checkpoints alone (its states recomputed in sub-stages of 16 tokens:
    the kernel's stage is one sub-stage, 16 tokens; 32 and 64, which it
    measured no faster, keep the decomposition's longer stages checked);
    dr, dk and dw sum a thread's 4 columns left to right and the row's 16
    threads by the butterfly; dv pairs a warp's two rows, sums a block's
    8 warps pairwise and the cluster's blocks (16 rows each) pairwise in
    rank order, the bonus's block partials likewise, then adds the bonus
    times dout; v . dout sums 4
    columns and the 16 groups' butterfly; du sums a stage's tokens by
    warp (tokens 2w, 2w + 1 of each sub-stage, the sub-stages in the
    walk's order) and the 8 warps in order, then 16 runs of (b, stage)
    partials. Everything is padded to 64 columns as the kernel pads."""
    pad = torch.nn.functional.pad
    b, s, h, dh = r.shape
    r_, k_, v_, do, wr = (pad(x.float(), (0, D - dh))
                          for x in (r, k, v, dout, w))
    wc = torch.clamp_min(wr, 1e-20)
    u_ = pad(u.float(), (0, D - dh))
    nst, nq = -(-s // stage), -(-dh // ROWS)

    def fwd(S, t):
        return wc[:, t, :, :, None] * S + k_[:, t, :, :, None] * v_[:, t, :,
                                                                    None]

    # 1. the scans, parallel over the entries
    ck_f = [torch.zeros((b, h, D, D))] + [None] * (nst - 1)
    S = ck_f[0]
    for t in range((nst - 1) * stage):
        S = fwd(S, t)
        if (t + 1) % stage == 0:
            ck_f[(t + 1) // stage] = S
    dS = (torch.zeros((b, h, D, D)) if dstate is None
          else pad(dstate.float(), (0, D - dh, 0, D - dh)))
    ck_b = [None] * (nst - 1) + [dS]
    for t in range(s - 1, stage - 1, -1):
        dS = wc[:, t, :, :, None] * dS + r_[:, t, :, :, None] * do[:, t, :,
                                                                   None]
        if t % stage == 0:
            ck_b[t // stage - 1] = dS

    # 2. each stage from its checkpoints
    def rows(x):                        # (b, h, D, D) terms -> row sums
        return _tree(_lr(x.reshape(b, h, D, D // 4, 4)))
    dr, dk, dv, dw = (torch.zeros((b, s, h, D)) for _ in range(4))
    du_part = torch.zeros((b, h, nst, D))
    for j in range(nst):
        t0 = j * stage
        n = min(stage, s - t0)
        tok = slice(t0, t0 + n)
        vd = _tree(_lr((v_[:, tok] * do[:, tok]).reshape(b, n, h, D // 4,
                                                         4)))  # (b, n, h)
        urk = u_ * r_[:, tok] * k_[:, tok]
        bnp = torch.stack([_tree(urk[..., ROWS * p:ROWS * (p + 1)])
                           for p in range(nq)], -1)             # (b, n, h, nq)
        subs, S = [ck_f[j]], ck_f[j]
        for m in range(-(-n // SUB) - 1):
            for t in range(SUB):
                S = fwd(S, t0 + m * SUB + t)
            subs.append(S)
        dS, dvc = ck_b[j], torch.zeros((b, n, h, nq, D))
        for m in reversed(range(len(subs))):
            ns = min(SUB, n - m * SUB)
            hist, S = [], subs[m]
            for t in range(ns):
                hist.append(S)
                S = fwd(S, t0 + m * SUB + t)
            for t in reversed(range(ns)):
                tt, tl = t0 + m * SUB + t, m * SUB + t
                dd, vv = do[:, tt, :, None, :], v_[:, tt, :, None, :]
                sr, sk = rows(hist[t] * dd), rows(dS * vv)
                sw = rows(dS * hist[t])
                pv = dS * k_[:, tt, :, :, None]
                pairs = (pv[:, :, 0::2] + pv[:, :, 1::2]).reshape(b, h, 4, 8,
                                                                  D)
                dvc[:, tl] = _pairs(pairs.transpose(-1, -2))[:, :, :nq]
                dS = (wc[:, tt, :, :, None] * dS
                      + r_[:, tt, :, :, None] * do[:, tt, :, None])
                dr[:, tt] = sr + u_ * k_[:, tt] * vd[:, tl, :, None]
                dk[:, tt] = sk + u_ * r_[:, tt] * vd[:, tl, :, None]
                dw[:, tt] = torch.where(wr[:, tt] >= 1e-20, sw, 0.0)
        dv[:, tok] = (_pairs(dvc.transpose(-1, -2))
                      + _pairs(bnp)[..., None] * do[:, tok])
        terms = pad(r_[:, tok] * k_[:, tok] * vd[..., None],
                    (0, 0, 0, 0, 0, -n % SUB))     # (b, n + pad, h, D)
        warps = []
        for wp in range(8):   # warp wp: tokens 2wp, 2wp + 1 of each sub-stage
            acc = torch.zeros((b, h, D))
            for m in reversed(range(len(subs))):
                t = m * SUB + 2 * wp
                acc = acc + (terms[:, t] + terms[:, t + 1])
            warps.append(acc)
        du_part[:, :, j] = _lr(torch.stack(warps, -1))

    # 3. du: 16 runs of consecutive (b, stage) partials, then the runs
    flat = du_part.permute(1, 0, 2, 3).reshape(h, b * nst, D)
    length = -(-(b * nst) // 16)
    du = _lr(torch.stack([_lr(flat[:, g * length:(g + 1) * length]
                              .transpose(1, 2)) for g in range(16)], -1))
    cut = (..., slice(0, dh))
    return (dr[cut].to(r.dtype), dk[cut].to(r.dtype), dv[cut].to(r.dtype),
            dw[cut].to(w.dtype), du[cut])


# (stage, S, dh, B, a final-state cotangent, w at the clip's ends): S of
# one token, 17, and one short of, one past and three times the stage;
# dh 5 (one partial row block), 40 (a cluster of three, the last partial)
# and 64 (four)
CUT_CASES = [(16, 1, 64, 2, True, False), (16, 15, 5, 1, False, True),
             (16, 17, 40, 2, True, True), (16, 48, 64, 1, False, False),
             (32, 1, 5, 1, True, True), (32, 17, 64, 2, False, False),
             (32, 31, 40, 1, True, False), (32, 33, 64, 2, True, True),
             (32, 96, 5, 2, False, True), (64, 1, 40, 2, False, False),
             (64, 17, 5, 2, True, False), (64, 63, 64, 1, False, True),
             (64, 65, 40, 1, True, True), (64, 192, 64, 2, True, False)]


@pytest.mark.parametrize("stage,s,dh,b,with_state,ends", CUT_CASES)
def test_the_kernels_cut_schedule_is_the_function(stage, s, dh, b,
                                                  with_state, ends):
    """The backward kernel's decomposition (``cut_schedule``: checkpoints
    from per-entry scans, stages run apart from them, its reduction
    orders) against the plain backward within 1e-5 of each gradient's
    scale and the fp64 function within 1e-6; dw 0 below the clamp."""
    a = inputs(100 + stage + s, b, s, 2, dh, w="ends" if ends else "random")
    t = [torch.as_tensor(x) for x in a]
    ds = t[6] if with_state else None
    got = cut_schedule(*t[:6], ds, stage)
    want = ref.gla_chunked_bwd_ref(*t[:6], ds, 1)
    exact = chip_smoke.gla_bwd_fp64(*t[:6], ds)
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in want]
    for name, g, x, e in zip(NAMES, got, want, exact):
        assert rel(g, x) <= TOL32, name
        assert rel(g, e) <= TOL64, name
    assert bool((got[3][t[3] < 1e-20] == 0).all())
