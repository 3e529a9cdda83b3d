"""Device dispatch for the port's kernels (the ``impl="pallas"``
backend of the quantum path and of the model's sequence layers).

A tensor on the card launches the hand-written CUDA kernel, or the
kernel's wrapper raises; a tensor on the CPU takes the kernel's plain
version in ``ref``. The sequence ops also take ``impl="xla"``, which
gives the plain version on any device. There is no other route and no
fallback.

Gradients. Plain torch differentiates every plain version. On the card,
attention, the RG-LRU scan and the chunked GLA (RWKV6's wkv) are
``torch.autograd.Function``s: the forward is the kernel's launch, the
backward a kernel too (attention's and the GLA's own backward kernels;
the scan's adjoint is the same scan kernel run on the reversed
sequence). The quantum kernels have no backward: they refuse an input
that requires grad while autograd records (``ValueError``), rather than
return an output that would silently drop the gradient (the quantum
path never uses autograd).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fidelity as _fid
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gla_chunked as _gla
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import zgemm as _zgemm


def _on_cpu(x: torch.Tensor) -> bool:
    return x.is_cpu


def _dense(x: torch.Tensor) -> torch.Tensor:
    """The kernels read raw storage: materialise lazy conjugate/negative
    views (``x.conj()`` only sets a bit) and make the layout contiguous.
    A tensor that is already all that is returned as it is."""
    if x.is_contiguous() and not x.is_conj() and not x.is_neg():
        return x
    return x.resolve_conj().resolve_neg().contiguous()


def _records_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _no_grad_kernel(name: str, *xs: torch.Tensor) -> None:
    if _records_grad(*xs):
        raise ValueError(f"{name}: the CUDA kernel has no gradient; the "
                         "quantum path never differentiates it (pass "
                         "tensors that do not require grad)")


def complex_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matmul (B, M, K) @ (B, K, N) -> complex128."""
    if _on_cpu(a):
        return ref.zgemm_ref(a, b)
    _no_grad_kernel("complex_matmul", a, b)
    return _zgemm.zgemm(_dense(a), _dense(b))


def fidelity(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Re<phi|rho|phi> per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.fidelity_ref(phi, rho)
    _no_grad_kernel("fidelity", phi, rho)
    return _fid.fidelity_batch(_dense(phi), _dense(rho))


def mse(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """||rho - |phi><phi|||_F^2 per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.mse_ref(phi, rho)
    _no_grad_kernel("mse", phi, rho)
    return _fid.mse_batch(_dense(phi), _dense(rho))


def ensemble_commutator_trace(a: torch.Tensor, b: torch.Tensor
                              ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) for keep-major ensembles
    a (J, N, Ea, dk, dr), b (J, N, Eb, dk, dr) -> (J, dk, dk) complex128."""
    if _on_cpu(a):
        return ref.ensemble_commutator_trace_ref(a, b)
    _no_grad_kernel("ensemble_commutator_trace", a, b)
    return _zgemm.ensemble_commutator_trace(_dense(a), _dense(b))


def plain_route(x: torch.Tensor, impl: str) -> bool:
    """Whether a sequence op on ``x`` takes the plain version (``impl
    ="xla"``, or a tensor on the CPU) rather than the CUDA kernel."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl {impl!r}: 'pallas' or 'xla'")
    return impl == "xla" or _on_cpu(x)


class _FlashAttentionFn(torch.autograd.Function):
    """The flash-attention kernel with its backward kernel. Saves q, k,
    v, the output and each row's log-sum-exp, which the forward kernel
    emits (under remat both come from the recompute); dq, dk, dv come
    back in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(
            q, k, v, out, _dense(dout.to(q.dtype)), lse=lse,
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def lru_scan_adjoint(scan, a: torch.Tensor, h: torch.Tensor,
                     g: torch.Tensor):
    """(da, db) of h = scan(a, b) (h_t = a_t h_{t-1} + b_t, h_0 = 0, over
    axis 1) for the cotangent g of h. The adjoint dh_t = g_t + a_{t+1}
    dh_{t+1} (zero past the end) is the same recurrence on the reversed
    sequence, with a shifted one step left (last entry 0) and b = g, so
    ``scan`` computes it; then da_t = dh_t h_{t-1} and db_t = dh_t."""
    a_next = torch.zeros_like(a)
    a_next[:, :-1] = a[:, 1:]
    dh = scan(a_next.flip(1), g.to(a.dtype).flip(1)).flip(1)
    h_prev = torch.zeros_like(h)
    h_prev[:, 1:] = h[:, :-1]
    return (dh * h_prev).to(a.dtype), dh


class _LruScanFn(torch.autograd.Function):
    """h = scan(a, b) with ``lru_scan_adjoint`` as its backward; ``scan``
    is the kernel's wrapper on the card (``ref.rglru_scan_ref`` runs the
    same algebra on the CPU)."""

    @staticmethod
    def forward(ctx, a, b, scan):
        h = scan(a, b)
        ctx.save_for_backward(a, h)
        ctx.scan = scan
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, db = lru_scan_adjoint(ctx.scan, a, h, g)
        return da, db, None


class _GlaChunkedFn(torch.autograd.Function):
    """The chunked GLA kernel with its backward kernel. Saves the inputs
    (the backward kernel recomputes the states it needs); dr, dk, dv come
    back in r's dtype, dw in w's and du fp32. The final state's cotangent
    goes to the backward kernel as it is, or as None where the state
    does not reach the loss."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk: int):
        ctx.set_materialize_grads(False)
        out, state = _gla.gla_chunked(r, k, v, w, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u = ctx.saved_tensors
        dout = torch.zeros_like(r) if dout is None else _dense(
            dout.to(r.dtype))
        dstate = None if dstate is None else _dense(dstate.float())
        return (*_gla.gla_chunked_bwd(r, k, v, w, u, dout, dstate,
                                      chunk=ctx.chunk), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, impl: str = "pallas"
              ) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, dh), k/v (B, Sk, K, dh) with
    H = K * G; queries and keys at positions 0.. -> (B, Sq, H, dh). The
    kernel reads kv head h // G itself; nothing is repeated."""
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, sq, dh)
    kf = k.transpose(1, 2).reshape(b * kh, -1, dh)
    vf = v.transpose(1, 2).reshape(b * kh, -1, dh)
    if plain_route(q, impl):
        out = ref.attention_ref(qf, kf, vf, causal=causal, window=window)
    else:
        out = _FlashAttentionFn.apply(_dense(qf), _dense(kf), _dense(vf),
                                      causal, window)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def lru_scan(a: torch.Tensor, b: torch.Tensor, *, impl: str = "pallas"
             ) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0, over
    axis 1 of (B, S, D) (RG-LRU)."""
    if plain_route(a, impl):
        return ref.rglru_scan_ref(a, b)
    return _LruScanFn.apply(_dense(a), _dense(b), _rg.rglru_scan)


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                impl: str = "pallas"):
    """RWKV6 wkv as chunked gated linear attention: r, k, v, w
    (B, S, H, dh) with w in (0, 1) (keep it fp32), u (H, dh), ``chunk``
    dividing S -> (out (B, S, H, dh) in r's dtype, final state
    (B, H, dh, dh) fp32). The model layer's entry; on the card both
    outputs differentiate through the backward kernel."""
    if plain_route(r, impl):
        return ref.gla_chunked_ref(r, k, v, w, u, chunk)
    return _GlaChunkedFn.apply(_dense(r), _dense(k), _dense(v), _dense(w),
                               _dense(u.float()), chunk)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16, impl: str = "pallas"
        ) -> torch.Tensor:
    """RWKV6 linear attention, the reference's ``ops.wkv`` signature:
    out only. Its plain route is the chunked form (the reference's is the
    step recurrence; the tests hold the two together)."""
    return gla_chunked(r, k, v, w, u, chunk=chunk, impl=impl)[0]
