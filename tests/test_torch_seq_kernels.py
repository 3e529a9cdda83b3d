"""The port's sequence kernels (flash attention, RG-LRU scan) through
their plain PyTorch versions (CPU).

Each plain version (``repro_torch.kernels.ref``, fp32 arithmetic like
the CUDA kernel it stands beside) is held against the JAX reference's
oracle (``repro.kernels.ref``) and against the Pallas TPU kernel run in
interpret mode, on the shape, dtype and window cases of
``tests/test_kernels.py``: 1e-5 in fp32, the reference's own 2e-2
(attention) and 5e-2 (scan) in bf16. Grouped-query heads are held
against the reference's ``ops.attention(impl="xla")``, which repeats
k/v where the port reads kv head h // G. ``tests/test_torch_cuda.py``
covers the launches on a card."""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jscan  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# the tensor cores' score sums as modelled in chip_smoke.py (one copy)
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)
tensor_core_scores = chip_smoke.tensor_core_scores
# the attention function in fp64 and the size of its terms (one copy)
attention_fp64 = chip_smoke.attention_fp64
attention_bwd_fp64 = chip_smoke.attention_bwd_fp64

TOL32 = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(x, dtype):
    """One numpy array as a JAX array and a torch tensor of one dtype
    (both round to bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def max_err(got, want):
    return float(np.max(np.abs(f32(got) - f32(want))))


def qkv(seed, bh, sq, sk, dh, dtype, bk=None):
    rng = np.random.default_rng(seed)
    bk = bk or bh
    return (both(rng.standard_normal((bh, sq, dh)), dtype),
            both(rng.standard_normal((bk, sk, dh)), dtype),
            both(rng.standard_normal((bk, sk, dh)), dtype))


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,sk", [(32, 32), (64, 64), (48, 80), (16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_shapes(sq, sk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = qkv(sq * sk, 3, sq, sk, 32, dtype)
    got = ref.attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (3, sq, 32)
    atol = 2e-2 if dtype == "bfloat16" else TOL32
    assert max_err(got, jref.attention_ref(jq, jk, jv, causal=True)) <= atol
    pallas = jflash(jq, jk, jv, causal=True, block_q=16, block_k=16,
                    interpret=True)
    assert max_err(got, pallas) <= atol


@pytest.mark.parametrize("window", [8, 24, 64])
def test_attention_plain_window(window):
    (jq, tq), (jk, tk), (jv, tv) = qkv(window, 2, 64, 64, 16, "float32")
    got = ref.attention_ref(tq, tk, tv, causal=True, window=window)
    want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    assert max_err(got, want) <= TOL32
    pallas = jflash(jq, jk, jv, causal=True, window=window, block_q=16,
                    block_k=16, interpret=True)
    assert max_err(got, pallas) <= TOL32


def test_attention_plain_noncausal():
    (jq, tq), (jk, tk), (jv, tv) = qkv(0, 2, 32, 32, 16, "float32")
    got = ref.attention_ref(tq, tk, tv, causal=False)
    assert max_err(got, jref.attention_ref(jq, jk, jv, causal=False)) <= TOL32


@pytest.mark.parametrize("sq,sk,window", [(48, 48, 16), (40, 72, 0),
                                          (72, 40, 0), (64, 64, 0)])
def test_attention_plain_grouped_heads(sq, sk, window):
    """H = 4 query heads over K = 2 kv heads: the port reads kv head
    h // G; the reference's ops.attention repeats k/v G times."""
    rng = np.random.default_rng(sq + sk + window)
    q = rng.standard_normal((2, sq, 4, 32))
    k = rng.standard_normal((2, sk, 2, 32))
    v = rng.standard_normal((2, sk, 2, 32))
    got = ops.attention(*(torch.as_tensor(x, dtype=torch.float32)
                          for x in (q, k, v)), causal=True, window=window,
                        impl="xla")
    want = jops.attention(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
                          causal=True, window=window, impl="xla")
    assert got.shape == (2, sq, 4, 32)
    assert max_err(got, want) <= TOL32


def test_attention_rows_with_no_allowed_key_are_zero():
    """Sq > Sk + window - 1 leaves late query rows with no key; the port
    gives 0 there like the TPU kernel (the JAX oracle's -1e30 fill gives
    the mean of v instead)."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(7, 2, 32, 8, 16, "float32")
    got = ref.attention_ref(tq, tk, tv, causal=True, window=4)
    pallas = jflash(jq, jk, jv, causal=True, window=4, block_q=8, block_k=8,
                    interpret=True)
    assert max_err(got, pallas) <= TOL32
    assert float(got[:, 11:].abs().max()) == 0.0
    assert bool((got[:, :11].abs().amax(dim=-1) > 0).all())


@pytest.mark.parametrize("bh,bk,sq,sk,window", [
    (4, 4, 48, 48, 0), (4, 4, 64, 64, 16), (6, 2, 40, 40, 7),
    (2, 1, 50, 20, 0), (2, 1, 50, 20, 8)])
def test_attention_plain_lse_matches_jax_logsumexp(bh, bk, sq, sk, window):
    """``ref.attention_ref(..., return_lse=True)``'s LSE (natural-log
    units, the unit of the forward kernels' LSE) against
    ``jax.nn.logsumexp`` of the masked, scaled scores that the reference's
    ``repro.kernels.ref.attention_ref`` forms (k repeated to every query
    head), within 1e-6 of its scale, on causal, windowed, GQA and Sq > Sk
    cases. The last case's rows past Sk + window - 1 have no allowed key:
    -inf in the port (the oracle's -1e30 fill gives -1e30 + log Sk)."""
    rng = np.random.default_rng(bh + sq + sk + window)
    q = rng.standard_normal((bh, sq, 32)).astype(np.float32)
    k = rng.standard_normal((bk, sk, 32)).astype(np.float32)
    v = rng.standard_normal((bk, sk, 32)).astype(np.float32)
    out, lse = ref.attention_ref(*(torch.as_tensor(x) for x in (q, k, v)),
                                 causal=True, window=window, return_lse=True)
    assert out.shape == (bh, sq, 32) and lse.shape == (bh, sq)
    assert lse.dtype == torch.float32
    kr = jnp.repeat(jnp.asarray(k), bh // bk, axis=0)
    s = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), kr) / jnp.sqrt(32.0)
    qp = jnp.arange(sq)[:, None]
    kp = jnp.arange(sk)[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1))
    has = np.asarray(mask.any(-1))
    got = lse.numpy()
    scale = float(np.abs(want[:, has]).max())
    assert float(np.abs(got[:, has] - want[:, has]).max()) <= 1e-6 * scale
    assert np.all(got[:, ~has] == -np.inf)
    assert has.all() == (window == 0 or sq <= sk + window - 1)


def split_p_attention(q, k, v, *, causal, window, split=True, tile=64,
                      tensor_core=False):
    """The bf16 CUDA kernel's arithmetic (csrc/flash_attention_wgmma.cu)
    in plain PyTorch: scores of the bf16 inputs summed in fp32 and scaled
    in the log2 domain, an online softmax over key tiles of 64, and P·V as
    P_hi V + P_lo V with P_hi = bf16(P), P_lo = bf16(P - P_hi) and fp32
    sums (``split=False``: P_hi alone, P rounded to bf16 as SDPA does;
    ``tensor_core``: the scores summed as ``tensor_core_scores`` models
    the tensor cores, else by one fp32 matmul).
    q (BH, Sq, dh), k/v (BH / G, Sk, dh) -> fp32 (BH, Sq, dh)."""
    g = q.shape[0] // k.shape[0]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 0) for x in (k, v))
    sl2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    o = torch.zeros(qf.shape)
    m = torch.full(qf.shape[:2] + (1,), -1e30)
    l = torch.zeros(m.shape)
    rows = torch.arange(q.shape[1])[:, None]
    for k0 in range(0, k.shape[1], tile):
        cols = torch.arange(k0, min(k0 + tile, k.shape[1]))[None, :]
        ok = torch.ones((rows.shape[0], cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window > 0:
            ok &= cols > rows - window
        if tensor_core:
            s = tensor_core_scores(q, kf[:, k0:k0 + tile].bfloat16()) * sl2
        else:
            s = (qf @ kf[:, k0:k0 + tile].transpose(1, 2)) * sl2
        m_new = torch.maximum(m, s.masked_fill(~ok, -1e30).amax(-1, True))
        alpha, m = torch.exp2(m - m_new), m_new
        p = torch.where(ok, torch.exp2(s - m), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        o = o * alpha + hi @ vf[:, k0:k0 + tile] + lo @ vf[:, k0:k0 + tile]
    return o / l.clamp_min(1e-30)


def bf16_ulp(x):
    """Spacing of bf16 at |x| (0 at 0): 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    mant, exp = torch.frexp(x.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


@pytest.mark.parametrize("bh,bk,sq,sk,dh,window",
                         [(6, 3, 70, 70, 64, 20), (4, 4, 33, 100, 128, 0),
                          (4, 2, 100, 33, 64, 7), (20, 2, 130, 130, 256, 50)])
def test_attention_split_p_emulation(bh, bk, sq, sk, dh, window):
    """The precision argument of the bf16 tensor-core kernel, runnable
    without a card. Against the fp32 function of the bf16 inputs, the
    split-P arithmetic misses by at most 2^-16 of a = (P |V|) / l, the
    size of the terms summed into each element (2^-8 is one bf16 ulp);
    P rounded to bf16 alone misses by more than 2^-10 of it. Rounded to
    bf16, the emulation is within one bf16 ulp (+ 2^-15 a) of the Pallas
    kernel in interpret mode and of ``attention_ref``."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(dh + window, bh, sq, sk, dh,
                                       "bfloat16", bk=bk)
    want = ref.attention_ref(tq.float(), tk.float(), tv.float(),
                             causal=True, window=window)
    terms = ref.attention_ref(tq.float(), tk.float(), tv.float().abs(),
                              causal=True, window=window)
    got = split_p_attention(tq, tk, tv, causal=True, window=window)
    rounded = split_p_attention(tq, tk, tv, causal=True, window=window,
                                split=False)
    assert float(((got - want).abs() - 2.0 ** -16 * terms).max()) <= 0.0
    assert float(((rounded - want).abs() - 2.0 ** -10 * terms).max()) > 0.0
    g = bh // bk
    pallas = jflash(jq, jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0),
                    causal=True, window=window, block_q=64, block_k=64,
                    interpret=True)
    got16 = got.bfloat16().float()
    for other in (torch.as_tensor(np.asarray(pallas, np.float32)),
                  ref.attention_ref(tq, tk, tv, causal=True,
                                    window=window).float()):
        excess = ((got16 - other).abs() - bf16_ulp(other)).clamp_min(0)
        assert float((excess - 2.0 ** -15 * terms).max()) <= 0.0


def hi_lo(x, split=True):
    """x as bf16 hi + lo (fp32 values); ``split=False``: hi alone."""
    hi = x.bfloat16().float()
    return hi, ((x - hi).bfloat16().float() if split
                else torch.zeros_like(x))


def split_bwd_attention(q, k, v, o, do, lse, *, causal, window, splits=1,
                        split_p=True, split_ds=True, tensor_core=False):
    """The bf16 backward kernel's arithmetic
    (csrc/flash_attention_bwd_wgmma.cu) in plain PyTorch, in its tile
    order: P = exp2(fma(s, 1/sqrt(dh), -LSE) log2(e)) of the bf16
    inputs' fp32 scores on the allowed pairs (the fma exact, then one
    rounding, through fp64), D_i = sum_c dO_ic O_ic,
    dS = P (dP - D). Pass A: for each key tile of 64, dQ += dS_hi K +
    dS_lo K. Pass B: for each of ``splits`` groups of a kv head's query
    heads, for each head and query tile of 64, dV += P^T_hi dO + P^T_lo dO
    and dK += dS^T_hi Q + dS^T_lo Q; then the groups' partials summed in
    order. Every sum fp32; hi = bf16(x), lo = bf16(x - hi) (``split_p`` /
    ``split_ds`` False: P or dS rounded to bf16 alone; ``tensor_core``:
    the scores and dP summed as ``tensor_core_scores`` models the tensor
    cores, else by one fp32 matmul each). q, o, dO (BH, Sq, dh), k, v
    (BK, Sk, dh) -> fp32 dq, dk, dv."""
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    g = bh // bk
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kr, vr = (x.repeat_interleave(g, 0) for x in (kf, vf))
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    mask = ref.attention_mask(sq, sk, causal, window, q.device)
    if tensor_core:
        s = tensor_core_scores(q, kr.bfloat16())
        dp = tensor_core_scores(do, vr.bfloat16())
    else:
        s, dp = qf @ kr.transpose(1, 2), dof @ vr.transpose(1, 2)
    arg = (s.double() * scale.double() - lse[..., None].double()).float()
    p = torch.where(mask, torch.exp2(arg * math.log2(math.e)), 0.0)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    p_hi, p_lo = hi_lo(p, split_p)
    ds_hi, ds_lo = hi_lo(ds, split_ds)
    dq = torch.zeros(qf.shape)
    for k0 in range(0, sk, 64):
        t = slice(k0, k0 + 64)
        dq += ds_hi[:, :, t] @ kr[:, t]
        dq += ds_lo[:, :, t] @ kr[:, t]
    dk_parts, dv_parts = [], []
    for sp in range(splits):
        heads = range(sp * g // splits, (sp + 1) * g // splits)
        dk = torch.zeros(kf.shape)
        dv = torch.zeros(vf.shape)
        for h in heads:
            rows = h + g * torch.arange(bk)      # head h of each kv head
            for i0 in range(0, sq, 64):
                t = slice(i0, i0 + 64)
                for lo_, hi_, x, acc in ((p_lo, p_hi, dof, dv),
                                         (ds_lo, ds_hi, qf, dk)):
                    acc += hi_[rows, t].transpose(1, 2) @ x[rows, t]
                    acc += lo_[rows, t].transpose(1, 2) @ x[rows, t]
        dk_parts.append(dk)
        dv_parts.append(dv)
    dk, dv = dk_parts[0], dv_parts[0]
    for a, b in zip(dk_parts[1:], dv_parts[1:]):
        dk, dv = dk + a, dv + b
    return dq * scale, dk * scale, dv


def bwd_terms(q, k, v, o, do, lse, *, causal, window):
    """The size of the terms summed into each gradient element of the
    fp32 function: scale |dS| |K|, scale |dS|^T |Q| and |P|^T |dO| (the
    sums over each kv head's query heads included)."""
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    g = bh // bk
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kr, vr = (x.repeat_interleave(g, 0) for x in (kf, vf))
    mask = ref.attention_mask(sq, sk, causal, window, q.device)
    p = torch.where(mask, torch.exp((qf @ kr.transpose(1, 2))
                                    / math.sqrt(dh) - lse[..., None]), 0.0)
    ds = (p * (dof @ vr.transpose(1, 2)
               - (dof * of).sum(-1, keepdim=True))).abs()
    scale = 1.0 / math.sqrt(dh)
    dq = scale * ds @ kr.abs()
    dk = scale * (ds.transpose(1, 2) @ qf.abs()).view(bk, g, sk, dh).sum(1)
    dv = (p.transpose(1, 2) @ dof.abs()).view(bk, g, sk, dh).sum(1)
    return dq, dk, dv


@pytest.mark.parametrize("bh,bk,sq,sk,dh,window",
                         [(6, 3, 70, 70, 64, 20), (4, 4, 33, 100, 128, 0),
                          (4, 2, 100, 33, 64, 7), (20, 2, 130, 130, 256, 50)])
def test_attention_backward_split_emulation(bh, bk, sq, sk, dh, window):
    """The precision argument of the bf16 backward kernel, runnable
    without a card. Against the fp32 function of the bf16 inputs
    (``ref.attention_bwd_ref`` on the upcast inputs, with the plain LSE),
    the kernel's arithmetic with P and dS split hi + lo, in its tile order
    and with the wrapper's splits of the group, misses each gradient
    element by at most 2^-16 of the size of the terms summed into it; dS
    rounded to bf16 alone, or P alone, misses by more than 2^-10 of it
    somewhere. Rounded to bf16, the emulation is within one bf16 ulp (+
    2^-15 of the terms) of the plain bf16 gradients. (4, 2, 100, 33, 64,
    7) has rows with no allowed key."""
    from repro_torch.kernels import flash_attention as kfa
    (_, tq), (_, tk), (_, tv) = qkv(dh + window + 1, bh, sq, sk, dh,
                                    "bfloat16", bk=bk)
    rng = np.random.default_rng(sq)
    tdo = torch.as_tensor(rng.standard_normal((bh, sq, dh))).bfloat16()
    kw = dict(causal=True, window=window)
    to, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    args = (tq, tk, tv, to, tdo)
    want = ref.attention_bwd_ref(*(x.float() for x in args), lse=lse, **kw)
    terms = bwd_terms(*args, lse, **kw)
    splits = kfa.bwd_splits(bh, bk, sk, 132)
    got = split_bwd_attention(*args, lse, splits=splits, **kw)
    for name, x, w, t in zip("qkv", got, want, terms):
        assert float(((x - w).abs() - 2.0 ** -16 * t).max()) <= 0.0, name
    for flags in (dict(split_ds=False), dict(split_p=False)):
        rounded = split_bwd_attention(*args, lse, splits=splits, **kw,
                                      **flags)
        worst = max(float(((x - w).abs() - 2.0 ** -10 * t).max())
                    for x, w, t in zip(rounded, want, terms))
        assert worst > 0.0, flags
    plain = ref.attention_bwd_ref(*args, lse=lse, **kw)
    for name, x, pl, t in zip("qkv", got, plain, terms):
        excess = ((x.bfloat16().float() - pl.float()).abs()
                  - bf16_ulp(pl)).clamp_min(0)
        assert float((excess - 2.0 ** -15 * t).max()) <= 0.0, name


def test_attention_backward_error_scales_with_the_logit_range():
    """The bf16 backward's arithmetic against the fp64 gradients at
    growing logits (the reference init's reach an LSE near 2000), with
    the tensor cores' score and dP sums (``split_bwd_attention(
    tensor_core=True)``) and with fp32-rounded ones: every fp32 score
    carries an error of about |x| 2^-24 (x the largest score in log2
    units), so each weight P carries that relative error, and each
    gradient element stays within 2 |x| 2^-24 + 2^-15 of the size of its
    terms, the bound the forward's arithmetic meets
    (``test_attention_kernel_order_error_scales_with_the_logit_range``);
    an element whose weights underflow fp32 is off by no more than 1e-30.
    The error grows with the logits: at |x| in the thousands it is more
    than 4x that at unit logits and above 2e-5 of the terms."""
    errs = []
    for scale in (1.0, 64.0, 256.0):
        (_, tq), (_, tk), (_, tv) = qkv(5, 4, 130, 130, 64, "bfloat16", bk=2)
        tq = (tq.float() * scale).bfloat16()
        tdo = qkv(6, 4, 130, 130, 64, "bfloat16")[0][1]
        kw = dict(causal=True, window=50)
        to, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
        exact, terms, smax = attention_bwd_fp64(tq, tk, tv, to, tdo, **kw)
        bound = 2 * smax * math.log2(math.e) * 2.0 ** -24 + 2.0 ** -15
        for tc in (False, True):    # the errors below: the tensor cores'
            got = split_bwd_attention(tq, tk, tv, to, tdo, lse, splits=2,
                                      tensor_core=tc, **kw)
            for g, e, t in zip(got, exact, terms):
                excess = (g.double() - e).abs() - bound * t
                assert float(excess.max()) <= 1e-30, (scale, tc)
        errs.append(max(float(((g.double() - e).abs() / t)[t > 1e-30].max())
                        for g, e, t in zip(got, exact, terms)))
    assert errs[2] > 4 * errs[0] and errs[2] > 2e-5, errs


def test_attention_kernel_order_error_scales_with_the_logit_range():
    """Isolating the bf16 kernel's excess over one bf16 ulp on the serving
    path, whose logits are large (the reference init): every fp32 attention
    rounds the scores at 2^-24 of their size, so each weight p carries a
    relative error of about |x| 2^-24, x the largest score in log2 units,
    and an output element one of that size times a = (P |V|) / l. The
    kernel's order (``split_p_attention``: scores scaled before the max is
    subtracted, P split hi + lo; with the scores of one fp32 matmul and
    with the tensor cores' truncated sums) and the plain version's stay
    within
    2 |x| 2^-24 + 2^-15 of a of the fp64 function at every logit range,
    and both errors grow with it: at |x| in the thousands they reach
    1e-4 a, more than one bf16 ulp of an element near 0, so two fp32
    versions may round to bf16 values more than one ulp apart there."""
    errs = []
    for scale in (1.0, 256.0, 1024.0):
        (_, tq), (_, tk), (_, tv) = qkv(5, 4, 130, 130, 64, "bfloat16", bk=2)
        tq = (tq.float() * scale).bfloat16()
        kw = dict(causal=True, window=50)
        exact, a, smax = attention_fp64(tq, tk, tv, **kw)
        xmax = smax * math.log2(math.e)
        bound = (2 * xmax * 2.0 ** -24 + 2.0 ** -15) * a
        emu = split_p_attention(tq, tk, tv, **kw).double()
        emu_tc = split_p_attention(tq, tk, tv, tensor_core=True,
                                   **kw).double()
        plain = ref.attention_ref(tq.float(), tk.float(), tv.float(),
                                  **kw).double()
        for got in (emu, emu_tc, plain):
            assert float(((got - exact).abs() - bound).max()) <= 0.0, scale
        errs.append(float(((emu - exact).abs() / a).max()))
    assert errs[2] > 10 * errs[0] and errs[2] > 1e-4, errs


# ------------------------------------------- fp32 attention on the tensor cores
def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: the low 13 of the 23
    mantissa bits rounded to nearest, ties away from zero (an add of half
    their range to the magnitude, then a mask)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tc_mma(acc, x, y):
    """acc (..., m, n) + x (..., m, 8) @ y (..., 8, n) of TF32 values as one
    mma.sync of the tensor cores sums it, as ``tensor_core_scores`` models
    their sums: the 8 exact products and the accumulator aligned to the
    largest exponent among them, each truncated below 2^(e - 26), added
    exactly, and the sum truncated to fp32 (toward 0). The 8 products lie
    k-major, (8, ..., m, n), so each reduction over them is elementwise
    across 8 slabs; scaled by 2^(26 - e), every truncated term is an
    integer below 2^27 and their sum is exact in any order."""
    terms = x.double().movedim(-1, 0)[..., :, None] * \
        y.double().movedim(-2, 0)[..., None, :]
    a = acc.double()
    top = torch.maximum(torch.maximum(terms.amax(0), terms.amin(0).neg_()),
                        a.abs())
    inv = torch.ldexp(torch.ones_like(top), 26 - torch.frexp(top).exponent)
    total = (terms.mul_(inv).trunc_().sum(0)
             + a.mul(inv).trunc_()).div_(inv)
    rn = total.float()
    return torch.where(rn.double().abs() > total.abs(),
                       torch.nextafter(rn, torch.zeros_like(rn)), rn)


CHAIN = 32      # columns of a chain: 4 k-steps, 12 mmas (attention_tf32.cuh)


def chain_tf32(a, b, terms=3):
    """a (..., m, K <= CHAIN) @ b (..., K, n) as one chain of the fp32
    kernels (``mma_3xtf32`` of csrc/tf32.cuh into a fresh accumulator): a
    and b split into TF32 hi + lo, k-steps of 8 in order, in each the
    products lo hi, hi lo, hi hi, each one ``tc_mma``. ``terms`` = 1: hi
    hi alone (TF32); 4: lo lo first as well."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = {1: [(ah, bh)], 3: [(al, bh), (ah, bl), (ah, bh)],
             4: [(al, bl), (al, bh), (ah, bl), (ah, bh)]}[terms]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in pairs:
            acc = tc_mma(acc, x[..., ks], y[..., ks, :])
    return acc


def dot_tf32(a, b, terms=3):
    """a (..., m, K) @ b (..., K, n) as the kernels' ``dot_rows``: chains of
    CHAIN columns, each added in order to the fp32 sum."""
    out = chain_tf32(a[..., :CHAIN], b[..., :CHAIN, :], terms)
    for c0 in range(CHAIN, a.shape[-1], CHAIN):
        out = out + chain_tf32(a[..., c0:c0 + CHAIN], b[..., c0:c0 + CHAIN, :],
                               terms)
    return out


def fma32(x, y, z):
    """fmaf(x, y, z): the exact x y + z rounded once to fp32."""
    return (x.double() * y.double() + z.double()).float()


def tile_mask(sq, k0, k1, causal, window):
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(k0, k1)[None, :]
    ok = torch.ones((sq, k1 - k0), dtype=torch.bool)
    if causal:
        ok &= cols <= rows
    if window > 0:
        ok &= cols > rows - window
    return ok


def split_tf32_attention(q, k, v, *, causal, window, terms=3, tile=32):
    """The fp32 CUDA kernel's arithmetic (csrc/flash_attention.cu) in
    plain PyTorch, in its tile order: for each key tile of 32, S = Q K^T
    (``dot_tf32``), scaled (one fp32 rounding) and masked, the online
    softmax in fp32, then O = fma(O, alpha, P V), P V one chain
    (``chain_tf32``, P split as well). q (BH, Sq, dh), k/v (BH / G, Sk,
    dh) -> fp32 (BH, Sq, dh)."""
    bh, sq, dh = q.shape
    g = bh // k.shape[0]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 0) for x in (k, v))
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    o = torch.zeros(qf.shape)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros(m.shape)
    for k0 in range(0, k.shape[1], tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        ok = tile_mask(sq, k0, k0 + kt.shape[1], causal, window)
        s = dot_tf32(qf, kt.transpose(1, 2), terms) * scale
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, True))
        alpha, m = torch.exp(m - m_new), m_new
        p = torch.where(ok, torch.exp(s - m), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = fma32(o, alpha, chain_tf32(p, vt, terms))
    return o / l.clamp_min(1e-30)


def split_tf32_bwd_attention(q, k, v, o, do, lse, *, causal, window,
                             splits=1, terms=3, tile=32):
    """The fp32 backward kernels' arithmetic (csrc/flash_attention_bwd.cu)
    in plain PyTorch, in their tile order, every product in 3xTF32 chains
    (``dot_tf32`` over dh, ``chain_tf32`` over a tile's rows, each added
    to its fp32 sum):
    P = exp(fma(s, 1/sqrt(dh), -LSE)) on the allowed pairs (the fma exact,
    then one rounding, through fp64), D_i = sum_c dO_ic O_ic,
    dS = P (dP - D). Pass A: for each key tile of 32, S = Q K^T,
    dP = dO V^T, then dQ += dS K, a sum for each half of the tile's keys
    (two warps), the halves added at the end. Pass B: for each of ``splits`` groups of
    a kv head's query heads, for each head and query tile of 32,
    S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q; the
    groups' partials summed in order. -> fp32 dq, dk, dv."""
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    g = bh // bk
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kr, vr = (x.repeat_interleave(g, 0) for x in (kf, vf))
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    lse = lse.float().clamp_min(-1e30)
    dd = (dof * of).sum(-1)

    def p_ds(s, dp, ok, lse_, dd_):
        arg = (s.double() * scale.double() - lse_.double()).float()
        p = torch.where(ok, torch.exp(arg), 0.0)
        return p, p * (dp - dd_)
    halves = [torch.zeros(qf.shape), torch.zeros(qf.shape)]
    for k0 in range(0, sk, tile):
        kt, vt = kr[:, k0:k0 + tile], vr[:, k0:k0 + tile]
        ok = tile_mask(sq, k0, k0 + kt.shape[1], causal, window)
        s = dot_tf32(qf, kt.transpose(1, 2), terms)
        dp = dot_tf32(dof, vt.transpose(1, 2), terms)
        _, ds = p_ds(s, dp, ok, lse[..., None], dd[..., None])
        for h, c in enumerate((slice(0, tile // 2), slice(tile // 2, tile))):
            halves[h] = halves[h] + chain_tf32(ds[..., c], kt[:, c], terms)
    dq = halves[0] + halves[1]
    parts = []
    for sp in range(splits):
        dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
        for h in range(sp * g // splits, (sp + 1) * g // splits):
            rows = h + g * torch.arange(bk)      # head h of each kv head
            for i0 in range(0, sq, tile):
                t = slice(i0, i0 + tile)
                qt, dot = qf[rows, t], dof[rows, t]
                ok = tile_mask(sq, 0, sk, causal, window)[t].T
                st = dot_tf32(kf, qt.transpose(1, 2), terms)
                dpt = dot_tf32(vf, dot.transpose(1, 2), terms)
                pt, dst = p_ds(st, dpt, ok, lse[rows, None, t],
                               dd[rows, None, t])
                dv = dv + chain_tf32(pt, dot, terms)
                dk = dk + chain_tf32(dst, qt, terms)
        parts.append((dk, dv))
    dk, dv = parts[0]
    for a, b in parts[1:]:
        dk, dv = dk + a, dv + b
    return dq * scale, dk * scale, dv


@pytest.fixture
def one_thread():
    """One intra-op thread: the emulations run many small products, which
    threads only slow down when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the fp32 kernels' tolerances on the card (chip_smoke.py)
KERNEL_RTOL, BWD_RTOL = chip_smoke.KERNEL_RTOL, chip_smoke.BWD_RTOL
TF32_CASES = [(6, 3, 70, 70, 64, 20), (4, 4, 33, 100, 128, 0),
              (4, 2, 100, 33, 64, 7), (20, 2, 130, 130, 256, 50)]


@pytest.mark.parametrize("bh,bk,sq,sk,dh,window", TF32_CASES)
def test_attention_3xtf32_emulation(bh, bk, sq, sk, dh, window, one_thread):
    """The precision argument of the fp32 forward kernel on the tensor
    cores, runnable without a card: its 3xTF32 arithmetic in its tile
    order is within KERNEL_RTOL of the output's scale of the plain fp32
    version and of the Pallas kernel in interpret mode (fp32); with TF32
    products alone (lo dropped) it misses by more than 10x that.
    (4, 2, 100, 33, 64, 7) has rows with no allowed key: 0 in both."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(dh + window + 2, bh, sq, sk, dh,
                                       "float32", bk=bk)
    kw = dict(causal=True, window=window)
    want = ref.attention_ref(tq, tk, tv, **kw)
    scale = max(1.0, float(want.abs().max()))
    got = split_tf32_attention(tq, tk, tv, **kw)
    assert float((got - want).abs().max()) <= KERNEL_RTOL * scale
    g = bh // bk
    pallas = jflash(jq, jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0),
                    causal=True, window=window, block_q=64, block_k=64,
                    interpret=True)
    assert max_err(got, pallas) <= KERNEL_RTOL * scale
    if sq > sk + window - 1 > 0:
        assert float(got[:, sk + window - 1:].abs().max()) == 0.0
    one = split_tf32_attention(tq, tk, tv, terms=1, **kw)
    assert float((one - want).abs().max()) > 10 * KERNEL_RTOL * scale


@pytest.mark.parametrize("bh,bk,sq,sk,dh,window", TF32_CASES)
def test_attention_backward_3xtf32_emulation(bh, bk, sq, sk, dh, window,
                                             one_thread):
    """The precision argument of the fp32 backward kernels on the tensor
    cores, runnable without a card: their 3xTF32 arithmetic, in their
    tile order and with the wrapper's splits of the group, is within
    BWD_RTOL of each gradient's scale of ``ref.attention_bwd_ref``
    (the plain LSE given to both); with TF32 products alone it misses by
    more than 5x that."""
    from repro_torch.kernels import flash_attention as kfa
    (_, tq), (_, tk), (_, tv) = qkv(dh + window + 3, bh, sq, sk, dh,
                                    "float32", bk=bk)
    tdo = torch.as_tensor(np.random.default_rng(sk).standard_normal(
        (bh, sq, dh)), dtype=torch.float32)
    kw = dict(causal=True, window=window)
    to, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    args = (tq, tk, tv, to, tdo)
    want = ref.attention_bwd_ref(*args, lse=lse, **kw)
    splits = kfa.bwd_splits(bh, bk, sk, 132)
    got = split_tf32_bwd_attention(*args, lse, splits=splits, **kw)
    one = split_tf32_bwd_attention(*args, lse, splits=splits, terms=1, **kw)
    worst = 0.0
    for name, x, x1, w in zip("qkv", got, one, want):
        scale = float(w.abs().max())
        assert float((x - w).abs().max()) <= BWD_RTOL * scale, name
        worst = max(worst, float((x1 - w).abs().max()) / scale)
    assert worst > 5 * BWD_RTOL


@pytest.mark.parametrize("terms,dh", [(3, 64), (4, 64), (3, 256)])
def test_3xtf32_attention_at_the_reference_init_logit_range(terms, dh,
                                                           one_thread):
    """At the reference init's logits (|s| / sqrt(dh) near 2000) every
    fp32 arithmetic misses the fp64 function: each fp32 rounding of a
    score at its own size (the plain version's matmul and scale; the
    kernels' accumulator after each mma) and of the LSE puts up to
    ~|x| 2^-24 (x the largest score in log2 units) on the exponent of each
    weight P. There the plain fp32 version is itself more than KERNEL_RTOL
    of the output's scale off the fp64 function, so the kernels' 3xTF32
    arithmetic is held against fp64 to ``chip_smoke.fp32_fn_bound``, 4 |x|
    2^-24 + 2^-15 of the size of the terms summed into each element
    (forward: (P |V|) / l; backward: ``attention_bwd_fp64``'s, of the
    backward's own inputs, the LSE given), twice what two such roundings
    give, as the card's gates hold the kernels on the path's inputs: three
    products a k-step meet it at dh 64 and at the path's 256 (8 chains a
    score), so QK^T takes no fourth product (a fourth, lo lo, ~2^-22 of a
    product, meets it too); TF32 alone misses."""
    from repro_torch.kernels import flash_attention as kfa
    (_, tq), (_, tk), (_, tv) = qkv(5, 4, 130, 130, dh, "float32", bk=2)
    tq = tq * 512.0
    tdo = qkv(6, 4, 130, 130, dh, "float32")[0][1]
    kw = dict(causal=True, window=50)
    exact, a, smax = attention_fp64(tq, tk, tv, **kw)
    assert smax > 1500.0
    bound = chip_smoke.fp32_fn_bound(smax)
    plain = ref.attention_ref(tq, tk, tv, **kw).double()
    scale = float(exact.abs().max())
    assert float((plain - exact).abs().max()) > KERNEL_RTOL * scale
    to, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    gexact, gterms, _ = attention_bwd_fp64(tq, tk, tv, to, tdo, lse=lse,
                                           **kw)
    splits = kfa.bwd_splits(4, 2, 130, 132)

    def errors(t):
        """Each output's largest excess over the bound (absolute: an
        element whose weights underflow fp32 may be off by 1e-30), and
        its largest error relative to its terms."""
        fwd = split_tf32_attention(tq, tk, tv, terms=t, **kw).double()
        bwd = split_tf32_bwd_attention(tq, tk, tv, to, tdo, lse,
                                       splits=splits, terms=t, **kw)
        fits = [chip_smoke.fp64_excess(x, e, s, smax)
                for x, e, s in zip((fwd,) + bwd, (exact,) + gexact,
                                   (a,) + gterms)]
        return [x for x, _ in fits], [share * bound for _, share in fits]
    over, rel = errors(terms)
    assert max(over) <= 1e-30, over
    print(f"{terms} products: worst errors of the forward, dq, dk, dv "
          f"{[f'{x:.3e}' for x in rel]} of their terms (bound {bound:.3e})")
    if terms == 3:
        assert max(errors(1)[0]) > 0.0


# ---------------------------------------------------------------- rglru
@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64), (16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_plain(s, chunk, dtype):
    rng = np.random.default_rng(s + chunk)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((2, s, 8))))
    b = 0.5 * rng.standard_normal((2, s, 8))
    (ja, ta), (jb, tb) = both(a, dtype), both(b, dtype)
    got = ref.rglru_scan_ref(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (2, s, 8)
    atol = 5e-2 if dtype == "bfloat16" else TOL32
    assert max_err(got, jref.rglru_scan_ref(ja, jb)) <= atol
    assert max_err(got, jscan(ja, jb, chunk=chunk, interpret=True)) <= atol


def test_rglru_scan_plain_matches_associative_scan():
    rng = np.random.default_rng(5)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((1, 32, 4))))
    b = 0.5 * rng.standard_normal((1, 32, 4))
    (ja, ta), (jb, tb) = both(a, "float32"), both(b, "float32")

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, h_assoc = jax.lax.associative_scan(combine, (ja, jb), axis=1)
    assert max_err(ref.rglru_scan_ref(ta, tb), h_assoc) <= TOL32


def segmented_scan(a, b, sub=16, warps=4):
    """The CUDA scan's arithmetic (csrc/rglru_scan.cu) in plain PyTorch:
    segments of ``warps`` sub-chunks of ``sub`` tokens; each sub-chunk
    run from h = 0 with its decay product P = a_0 a_1 ... (fp32, left to
    right), the carry into each sub-chunk folded in order from the
    segment's (carry = P_j carry + h_j), the sub-chunk run again from its
    carry, and the next segment's carry folded over all its sub-chunks.
    Every h update and fold is one fused multiply-add (one rounding, as
    the kernel's fmaf: the product is exact in fp64). Returns a's dtype."""
    def fma(x, y, z):
        return (x.double() * y.double() + z.double()).float()
    bsz, s, d = a.shape
    a32, b32 = a.float(), b.float()
    out = torch.empty((bsz, s, d))
    carry = torch.zeros((bsz, d))
    for s0 in range(0, s, sub * warps):
        spans = [range(t0, min(t0 + sub, s))
                 for t0 in range(s0, s0 + sub * warps, sub)]
        parts = []
        for span in spans:
            p, h = torch.ones((bsz, d)), torch.zeros((bsz, d))
            for t in span:
                h = fma(a32[:, t], h, b32[:, t])
                p = p * a32[:, t]
            parts.append((p, h))
        c = carry
        for span, (p, h_end) in zip(spans, parts):
            h = c
            for t in span:
                h = fma(a32[:, t], h, b32[:, t])
                out[:, t] = h
            c = fma(p, c, h_end)
        carry = c
    return out.to(a.dtype)


@pytest.mark.parametrize("s,chunk", [(1, 1), (17, 17), (64, 64), (128, 64),
                                     (200, 8), (4097, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_segmented_scan_emulation(s, chunk, dtype):
    """The carry fix-up of the CUDA scan runs out of the sequential order;
    its emulation stays within 1e-5 of the output's scale of the Pallas
    kernel in interpret mode and of the reference's sequential scan in
    fp32, and within one bf16 ulp of them in bf16 (S of 1, one 16-token
    sub-chunk plus one, one 64-token segment, a multiple of it, neither,
    and the 4097 tokens of the S+1 prefill)."""
    rng = np.random.default_rng(s)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((2, s, 8)) - 2.0))
    b = rng.standard_normal((2, s, 8))
    (ja, ta), (jb, tb) = both(a, dtype), both(b, dtype)
    got = segmented_scan(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (2, s, 8)
    for want in (jref.rglru_scan_ref(ja, jb),
                 jscan(ja, jb, chunk=chunk, interpret=True)):
        want = torch.tensor(f32(want))
        scale = float(want.abs().max())
        if dtype == "bfloat16":
            assert bool(((got.float() - want).abs()
                         <= bf16_ulp(want)).all())
        else:
            assert max_err(got, want) <= TOL32 * scale
    # past one segment the fold is not the sequential order of the same
    # fused steps (one sub-chunk over the whole sequence): bits differ
    if s > 64 and dtype == "float32":
        assert not torch.equal(got, segmented_scan(ta, tb, sub=s, warps=1))


# ---------------------------------------------------------------- dispatch
def test_sequence_ops_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.standard_normal((1, 20, 2, 64)),
                        dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 20, 1, 64)),
                        dtype=torch.float32)
    a = torch.rand((2, 9, 5))
    b = torch.randn((2, 9, 5))
    before = dict(build.LAUNCHES)
    for impl in ("pallas", "xla"):
        out = ops.attention(q, k, k, causal=True, window=4, impl=impl)
        want = ref.attention_ref(q[0].transpose(0, 1), k[0].transpose(0, 1),
                                 k[0].transpose(0, 1), causal=True, window=4)
        assert torch.equal(out[0].transpose(0, 1), want)
        assert torch.equal(ops.lru_scan(a, b, impl=impl),
                           ref.rglru_scan_ref(a, b))
    assert dict(build.LAUNCHES) == before  # no kernel ran
    with pytest.raises(ValueError):
        ops.lru_scan(a, b, impl="triton")
    with pytest.raises(ValueError):
        ops.attention(q, k, k, impl="auto")


def test_sequence_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rglru_scan as krg
    x = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        kfa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA kernel"):
        krg.rglru_scan(x, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        krg.rglru_scan(x.double(), x.double())


def test_sequence_kernels_are_built_and_bound():
    """The sources (attention: fp32 in 3xTF32 mma.sync, bf16 on wgmma,
    both on the tensor cores) are in the library's build and the entry points have
    ctypes signatures (pointers as c_void_p, so none is cut to 32 bits)."""
    names = {p.name for p in build._sources()}
    assert {"flash_attention.cu", "flash_attention_wgmma.cu",
            "rglru_scan.cu"} <= names
    for fn, n_ptr in (("qf_flash_attention", 4), ("qf_rglru_scan", 3)):
        argtypes, _ = build._SIGNATURES[fn]
        assert argtypes[:n_ptr] == [build._VP] * n_ptr
        assert argtypes[-1] is build._VP       # the stream
        text = "".join(p.read_text() for p in build._sources())
        assert f'extern "C" int {fn}(' in text


# ------------------------------------------------ NaN in the fp32 attention
def test_nan_reach_is_the_attention_data_flow():
    """``chip_smoke.nan_reach`` (the rows a planted NaN must reach in the
    fp32 attention kernels' outputs, ``nan_rows_check``'s gate on the
    card) against the plain version with one NaN planted at a time: every
    row it names is NaN in the plain version's outputs; where the plain
    version has no 0 x NaN of a masked pair (a NaN in q; in k, forward)
    the two agree row for row; the counts follow the mask (window 40)."""
    gen = torch.Generator().manual_seed(0)
    bh, bk, s, dh = 20, 4, 96, 64
    q, k, v, do = (torch.randn(shape, generator=gen) for shape in (
        (bh, s, dh), (bk, s, dh), (bk, s, dh), (bh, s, dh)))
    kw = dict(causal=True, window=40)
    # (spot, rows of out / dq reached, keys of dk / dv reached)
    cases = [((0, 17, 95, 7), (1, 1), (40, 40)),
             ((1, 0, 24, 5), (200, 200), (64, 1)),
             # o from the plain forward is NaN on all 480 rows of the
             # group (0 x NaN), so D_i carries it into every dq, dk row
             ((2, 1, 48, 9), (200, 480), (96, 0)),
             ((3, 11, 32, 3), (0, 1), (33, 33))]
    for spot, (n_out, n_dq), (n_dk, n_dv) in cases:
        pq, pk, pv, pdo = chip_smoke.plant_nans((q, k, v, do), [spot],
                                                0x7fc00000)
        o, lse = ref.attention_ref(pq, pk, pv, return_lse=True, **kw)
        reach = ((chip_smoke.nan_reach(pq, pk, pv, **kw),)
                 + chip_smoke.nan_reach(pq, pk, pv, o=o, do=pdo, lse=lse,
                                        **kw))
        plain = (o,) + ref.attention_bwd_ref(pq, pk, pv, o, pdo, lse=lse,
                                             **kw)
        for need, out in zip(reach, plain):
            assert bool((~need | torch.isnan(out).any(-1)).all()), spot
        assert [int(x.sum()) for x in reach] == [n_out, n_dq, n_dk, n_dv]
        if spot[0] in (0, 1):
            assert torch.equal(reach[0], torch.isnan(o).any(-1))

