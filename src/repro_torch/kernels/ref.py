"""Plain PyTorch versions of the port's CUDA kernels.

Each computes the same function as its kernel with the kernel's
precision contract. The quantum kernels: complex128 in, fp32
arithmetic, complex128 (or float64) out. The sequence kernels
(attention, the RG-LRU scan, chunked GLA): fp32 or bf16 in, fp32
arithmetic, out in the input's dtype (GLA's final state in fp32). The ``ops`` wrappers take these for tensors on the
CPU, and ``chip_smoke.py`` holds each kernel against its plain version
on the card, like for like. The JAX package's ``repro.kernels.ref`` is
the oracle they are tested against.
"""
from __future__ import annotations

import math

import torch


def _parts32(x: torch.Tensor):
    return x.real.float(), x.imag.float()


def zgemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matmul (B, M, K) @ (B, K, N) on split fp32 parts."""
    ar, ai = _parts32(a)
    br, bi = _parts32(b)
    cr = ar @ br - ai @ bi
    ci = ar @ bi + ai @ br
    return torch.complex(cr, ci).to(torch.complex128)


def fidelity_ref(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Re<phi|rho|phi> per pair: phi (N, d), rho (N, d, d) -> (N,)."""
    pr, pi = _parts32(phi)
    rr, ri = _parts32(rho)
    yr = torch.einsum("nde,ne->nd", rr, pr) - torch.einsum("nde,ne->nd", ri, pi)
    yi = torch.einsum("nde,ne->nd", rr, pi) + torch.einsum("nde,ne->nd", ri, pr)
    return (torch.sum(pr * yr, -1) + torch.sum(pi * yi, -1)).double()


def mse_ref(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """||rho - |phi><phi|||_F^2 per pair: phi (N, d), rho (N, d, d)."""
    pr, pi = _parts32(phi)
    rr, ri = _parts32(rho)
    proj_r = pr[:, :, None] * pr[:, None, :] + pi[:, :, None] * pi[:, None, :]
    proj_i = pi[:, :, None] * pr[:, None, :] - pr[:, :, None] * pi[:, None, :]
    dr, di = rr - proj_r, ri - proj_i
    return torch.sum(dr * dr + di * di, dim=(-2, -1)).double()


def ensemble_commutator_trace_ref(a: torch.Tensor, b: torch.Tensor
                                  ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) on keep-major ensembles
    a: (J, N, Ea, dk, dr), b: (J, N, Eb, dk, dr) -> (J, dk, dk): the cross
    Gram, re-expanded against a and traced against b, in complex64."""
    a, b = a.to(torch.complex64), b.to(torch.complex64)
    g = torch.einsum("jnekr,jnfkr->jnef", a.conj(), b)
    w = torch.einsum("jnef,jnekr->jnfkr", g, a)
    t = torch.einsum("jnfar,jnfbr->jab", w, b.conj())
    return t.to(torch.complex128)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  return_lse: bool = False, q_offset: int = 0):
    """q (BH, Sq, dh); k/v (BK, Sk, dh) with BH = BK * G: query row i
    reads kv row i // G (G = 1 is the reference's same-head layout).
    Query row i sits at position p = i + ``q_offset`` (a context-parallel
    shard's rows start there; 0 otherwise), key j at position j; they
    pair when j <= p (causal) and j > p - window (window > 0). fp32
    softmax; out
    in q's dtype. With ``return_lse``, (out, lse): each row's
    log-sum-exp of its scaled allowed scores, fp32 (BH, Sq), natural-log
    units, the unit of the CUDA kernels' LSE.

    A query row with no allowed key gives 0, as the TPU kernel and the
    CUDA kernel do (the JAX oracle's -1e30 fill gives the mean of v
    there instead; no model path has such a row), and an LSE of -inf.
    """
    g = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = (q.float() @ kf.transpose(1, 2)) / math.sqrt(float(q.shape[-1]))
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, q.device,
                          q_offset)
    if s.requires_grad:                    # autograd keeps every step
        s = s.masked_fill(~mask, float("-inf"))
        m = s.detach().amax(dim=-1, keepdim=True).clamp_min(-1e30)
        p = (s - m).exp()
    else:                                  # in place: s is (BH, Sq, Sk)
        s.masked_fill_(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        p = s.sub_(m).exp_()
    lsum = p.sum(dim=-1, keepdim=True)
    out = ((p @ vf) / lsum.clamp_min(1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(lsum > 0, m + torch.log(lsum), float("-inf"))
    return out, lse.squeeze(-1)


def attention_mask(sq: int, sk: int, causal: bool, window: int, device,
                   q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: query row i (at position p = i + q_offset) and key j
    pair when j <= p (causal) and j > p - window (window > 0)."""
    qp = torch.arange(q_offset, q_offset + sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return mask


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      lse: torch.Tensor | None = None, q_offset: int = 0):
    """dq, dk, dv of ``attention_ref`` at (q, k, v) for the cotangent
    ``do`` of its output ``o`` (the plain version of the CUDA kernels
    ``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_wgmma
    .cu``, by the same algorithm): fp32 math, each row's log-sum-exp
    ``lse`` (fp32 (BH, Sq), natural-log units, as ``attention_ref(...,
    return_lse=True)`` and the forward kernels give it; ``None``: worked
    out here over the row's allowed keys), D_i = sum_c do_ic o_ic, P =
    exp(s - lse) on the allowed pairs, dS = P (do v^T - D); dq = scale
    dS k, dk = scale dS^T q and dv = P^T do, dk and dv summed over the G
    query heads of each kv head. A row with no allowed key has no
    gradient. Query rows start at position ``q_offset``, as in
    ``attention_ref``. Out in q's dtype (the reference's
    ``_grad_dtype_fence``)."""
    g = q.shape[0] // k.shape[0]
    bk, sk, dh = k.shape
    scale = 1.0 / math.sqrt(float(dh))
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    mask = attention_mask(q.shape[1], sk, causal, window, q.device,
                          q_offset)
    s = (qf @ kf.transpose(1, 2)).mul_(scale).masked_fill_(~mask,
                                                            float("-inf"))
    if lse is None:
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        lsum = (s - m).exp_().sum(dim=-1, keepdim=True)
        lse = torch.where(lsum > 0, m + torch.log(lsum), 0.0)
    else:                                  # -inf rows: no allowed key
        lse = lse.float()[..., None].clamp_min(-1e30)
    p = s.sub_(lse).exp_()                 # in place: s is (BH, Sq, Sk)
    dd = (dof * of).sum(dim=-1, keepdim=True)
    ds = (dof @ vf.transpose(1, 2)).sub_(dd).mul_(p)
    dv = (p.transpose(1, 2) @ dof).view(bk, g, sk, dh).sum(1)
    del p
    dq = (ds @ kf).mul_(scale)
    dk = (ds.transpose(1, 2) @ qf).mul_(scale).view(bk, g, sk, dh).sum(1)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential diagonal recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0,
    over axis 1 of (B, S, D); fp32 carry, out in a's dtype."""
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((a.shape[0],) + a.shape[2:], dtype=torch.float32,
                    device=a.device)
    a32, b32 = a.float(), b.float()
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


# log(w) is clamped here before the cumulative sums: decays below it
# (the RWKV6 block reaches exp(-e^4) ~ 1.9e-24) count as 1e-20
GLA_W_FLOOR = 1e-20
# fp32 elements of one slab of the pairwise decay tensor (256 MB)
GLA_SLAB_ELEMS = 1 << 26


def gla_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, chunk: int):
    """RWKV6 wkv as chunked gated linear attention (the reference's
    ``models/layers/rwkv.py::gla_chunked_ref``, and the plain version of
    the CUDA kernel).

    r, k, v, w (B, S, H, dh) with w in (0, 1), any float dtypes; u (H, dh);
    ``chunk`` divides S. Returns out (B, S, H, dh) in r's dtype and the
    final state (B, H, dh, dh) in fp32. Per chunk, with lp the inclusive
    cumulative log-decay (summed left to right, as the kernel does) and
    lp_prev = lp - log w:

        out[t] = sum_{i<t} (sum_c r_tc k_ic e^{lp_prev,tc - lp_ic}) v_i
               + (sum_c r_tc k_tc u_c) v_t + (r_t * e^{lp_prev,t}) S
        S     <- e^{lp_last} * S + sum_i (k_i * e^{lp_last - lp_i}) v_i^T

    Every exponent of a pair that counts is <= 0. The pairs above the
    diagonal, which do not count, are set to -inf before the exp: the
    reference's ``where(tri, exp(pair), 0)`` overflows there (the pair's
    exponent reaches +736 within a chunk of 16 at the decay clip) and
    its autodiff multiplies the masked gradient's 0 by that inf, so dw
    comes back NaN (``tests/test_torch_gla_grad.py``). The forward's
    values are the same bits either way. The pairwise tensor (B, n, t,
    i, H, dh) is built a slab of chunks at a time, so a full-width
    prefill stays within a few GB."""
    b, s, h, dh = r.shape
    if chunk < 1 or s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence {s}")
    n = s // chunk
    r_, k_, v_ = (x.float().reshape(b, n, chunk, h, dh) for x in (r, k, v))
    logw = torch.log(torch.clamp_min(w.float(), GLA_W_FLOOR)).reshape(
        b, n, chunk, h, dh)
    lp = logw.clone()
    for t in range(1, chunk):
        lp[:, :, t] += lp[:, :, t - 1]
    lp_prev = lp - logw

    # intra-chunk: the strictly lower pairs, then the u bonus
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device
                     ).tril(-1)[:, :, None, None]
    bonus = (r_ * k_ * u.float()).sum(-1, keepdim=True) * v_
    out = torch.empty_like(bonus)
    slab = max(1, GLA_SLAB_ELEMS // (b * chunk * chunk * h * dh))
    for n0 in range(0, n, slab):
        sl = slice(n0, n0 + slab)
        pair = lp_prev[:, sl, :, None] - lp[:, sl, None]  # (b,n,t,i,h,c)
        dec = torch.where(tri, pair.masked_fill_(~tri, float("-inf"))
                          .exp_(), 0.0)
        del pair
        a = dec.mul_(r_[:, sl, :, None]).mul_(k_[:, sl, None]).sum(-1)
        del dec
        out[:, sl] = torch.einsum("bntih,bnihe->bnthe", a, v_[:, sl]) \
            + bonus[:, sl]
    del bonus

    # inter-chunk: the (dh, dh) state carried across chunks
    q_dec = r_ * torch.exp(lp_prev)
    k_dec = k_ * torch.exp(lp[:, :, -1:] - lp)
    decay = torch.exp(lp[:, :, -1])[..., None]            # (b,n,h,c,1)
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    for i in range(n):
        out[:, i] += torch.einsum("bthc,bhce->bthe", q_dec[:, i], state)
        kv = torch.einsum("bthc,bthe->bhce", k_dec[:, i], v_[:, i])
        state = decay[:, i] * state + kv
    return out.reshape(b, s, h, dh).to(r.dtype), state


# tokens a stage of the GLA backward: the state before each stage is kept
# from a forward sweep, and the states within a stage recomputed from it
GLA_BWD_STAGE = 16


def gla_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                        dstate: torch.Tensor | None = None, chunk: int = 16):
    """Gradients of ``gla_chunked_ref``'s (out, final state) at (r, k, v,
    w, u) for the cotangents ``dout`` of out and ``dstate`` of the final
    state (None: zero): (dr, dk, dv in r's dtype, dw in w's dtype, du
    (H, dh) fp32, summed over B and S). The plain version of the CUDA
    kernel ``csrc/gla_chunked_bwd.cu``, by the same algorithm, fp32
    arithmetic.

    The function does not depend on the chunk (``chunk`` is checked as
    the forward checks it). With S_t the state after token t (S_0 = 0)
    and dS_t its cotangent, carried in reverse from ``dstate``:

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t
        dk_t = (dS_t + diag(u) r_t do_t^T) v_t
        dv_t = (dS_t + diag(u) r_t do_t^T)^T k_t
        dw_t = sum_e dS_t S_{t-1}    (0 where w_t < 1e-20: the clamp)
        du   = sum_t r_t k_t (v_t . do_t)
        dS_{t-1} = diag(w_t) dS_t + r_t do_t^T

    with w clamped to 1e-20 as the forward clamps it. dw is formed from
    the states directly, never as d(log w) / w: the chunked form's
    autodiff (the reference's) takes d(log w) as a difference of sums
    that cancel to nothing at a strong decay, so its dw is 0 where the
    function's is O(1) (and NaN where its masked exp overflowed). No
    exponential is taken at all. The states before each stage of
    GLA_BWD_STAGE tokens come from a forward sweep; a stage's own states
    are recomputed from them, so a full-width layer holds S / 16 states
    and no more."""
    b, s, h, dh = r.shape
    if chunk < 1 or s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence {s}")
    r_, k_, v_, do = (x.float() for x in (r, k, v, dout))
    wf = w.float()
    wc = torch.clamp_min(wf, GLA_W_FLOOR)[..., None]     # (b, s, h, dh, 1)
    vd = (v_ * do).sum(-1, keepdim=True)                  # (b, s, h, 1)
    bonus = (r_ * u.float() * k_).sum(-1, keepdim=True)
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    starts = []
    for t in range(s):
        if t % GLA_BWD_STAGE == 0:
            starts.append(state)
        state = wc[:, t] * state + k_[:, t, :, :, None] * v_[:, t, :, None, :]
    ds = (torch.zeros_like(state) if dstate is None
          else dstate.float().clone())
    dr, dk, dv, dw = (torch.empty_like(r_) for _ in range(4))
    for j in reversed(range(len(starts))):
        t0 = j * GLA_BWD_STAGE
        prev, state = [], starts[j]
        for t in range(t0, min(s, t0 + GLA_BWD_STAGE)):
            prev.append(state)
            state = (wc[:, t] * state
                     + k_[:, t, :, :, None] * v_[:, t, :, None, :])
        for t in reversed(range(t0, t0 + len(prev))):
            sp = prev[t - t0]
            dr[:, t] = torch.einsum("bhce,bhe->bhc", sp, do[:, t])
            dk[:, t] = torch.einsum("bhce,bhe->bhc", ds, v_[:, t])
            dv[:, t] = torch.einsum("bhce,bhc->bhe", ds, k_[:, t])
            dw[:, t] = (ds * sp).sum(-1)
            ds = wc[:, t] * ds + r_[:, t, :, :, None] * do[:, t, :, None, :]
    u_ = u.float()
    dr += u_ * k_ * vd
    dk += u_ * r_ * vd
    dv += bonus * do
    du = (r_ * k_ * vd).sum((0, 1))
    dw = torch.where(wf >= GLA_W_FLOOR, dw, 0.0)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw.to(w.dtype),
            du)


def gla_recurrence_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The step-by-step RWKV6 recurrence (the reference's
    ``kernels/ref.py::gla_recurrence_ref``, the definitional oracle):
    out_t = r_t (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1}
    + k_t v_t^T; fp32 state, out in r's dtype."""
    b, s, h, dh = r.shape
    r_, k_, v_, w_ = (x.float() for x in (r, k, v, w))
    u_ = u.float()[..., None]
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = k_[:, t, :, :, None] * v_[:, t, :, None, :]
        out[:, t] = torch.einsum("bhc,bhce->bhe", r_[:, t], state + u_ * kv)
        state = w_[:, t, :, :, None] * state + kv
    return out.to(r.dtype)
