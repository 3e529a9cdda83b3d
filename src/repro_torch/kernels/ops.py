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

Sharded. A DTensor operand (the sharded model step) runs each sequence
op on this rank's shards (``sharding.dtensor.local``), given at the
model's (B, S, H, dh) level, where DTensor keeps batch and heads
sharded (a flatten of two sharded dims would all-gather): attention is
local over batch and heads (a kv head that the model axis does not
divide stays whole, and each rank reads the kv heads of its query
heads), and over a query-sequence shard (context parallelism) with the
keys whole and the rows' ``q_offset`` from the rank; the RG-LRU scan is
local over batch and width; the GLA over batch and heads. Any other
placement is redistributed first. On the card each op still launches
its kernel.

Traced. A fake tensor (``FakeTensorMode``) holds no data and takes the
kernels' route on any device: the kernels are registered ops whose
fakes give their outputs' and workspaces' shapes, so a traced step is
the card's step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fidelity as _fid
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gla_chunked as _gla
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import zgemm as _zgemm
from repro_torch.sharding import dtensor as sdt
from repro_torch.sharding.dtensor import is_dtensor as isdt


def _on_cpu(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain route: a real tensor on the CPU (a
    fake one takes the kernels' route, see the module's docstring)."""
    return x.is_cpu and not _is_fake(x)


def _is_fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    if isdt(x):
        x = x._local_tensor
    return isinstance(x, FakeTensor)


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
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out, lse = _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(
            q, k, v, out, _dense(dout.to(q.dtype)), lse=lse,
            causal=ctx.causal, window=ctx.window, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


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
              causal: bool = True, window: int = 0, impl: str = "pallas",
              q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, H, dh), k/v (B, Sk, K, dh) with
    H = K * G; query row i at position i + ``q_offset``, keys at 0..
    -> (B, Sq, H, dh). The kernel reads kv head h // G itself; nothing is
    repeated. DTensor operands run sharded (the module's docstring)."""
    if isdt(q):
        return _sharded_attention(q, k, v, causal, window, impl)
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, sq, dh)
    kf = k.transpose(1, 2).reshape(b * kh, -1, dh)
    vf = v.transpose(1, 2).reshape(b * kh, -1, dh)
    if plain_route(q, impl):
        out = ref.attention_ref(qf, kf, vf, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        out = _FlashAttentionFn.apply(_dense(qf), _dense(kf), _dense(vf),
                                      causal, window, q_offset)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def _sharded_attention(q, k, v, causal, window, impl):
    """``attention`` on DTensors: per mesh dim, q keeps a batch, heads or
    query-sequence shard (anything else is gathered); k and v follow a
    batch shard, follow a heads shard where the dim divides the kv heads
    and stay whole otherwise (their gradients then partial sums), and
    stay whole under a sequence shard."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    g = q.shape[2] // k.shape[2]
    q_pl, kv_pl, kv_grad = [], [], []
    for i, pl in enumerate(q.placements):
        dim = pl.dim if isinstance(pl, Shard) else None
        if dim == 0 or (dim == 2 and k.shape[2] % mesh.size(i) == 0):
            q_pl.append(pl), kv_pl.append(pl), kv_grad.append(pl)
        elif dim in (1, 2):
            q_pl.append(pl), kv_pl.append(Replicate())
            kv_grad.append(Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    seq_dims = [i for i, p in enumerate(q_pl) if p == Shard(1)]
    head_dims = [i for i, (p, kp) in enumerate(zip(q_pl, kv_pl))
                 if p == Shard(2) and kp == Replicate()]

    def fn(ql, kl, vl):
        off = sdt.coord(mesh, seq_dims) * ql.shape[1]
        if head_dims:       # this rank's query heads read these kv heads
            hl = ql.shape[2]
            first = sdt.coord(mesh, head_dims) * hl
            idx = torch.arange(first, first + hl, device=kl.device) // g
            if hl % g == 0 or g % hl == 0:
                kl = kl[:, :, first // g:(first + hl - 1) // g + 1]
                vl = vl[:, :, first // g:(first + hl - 1) // g + 1]
            else:
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return attention(ql, kl, vl, causal=causal, window=window,
                         impl=impl, q_offset=off)

    return sdt.local(fn, mesh, q_pl, (q_pl, kv_pl, kv_pl),
                     (q_pl, kv_grad, kv_grad))(q, k, v)


def _keep(x, dims, mesh):
    """Per mesh dim, x's placement where it shards one of ``dims``, else
    Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return [pl if isinstance(pl, Shard) and pl.dim in dims else Replicate()
            for pl in x.placements]


def lru_scan(a: torch.Tensor, b: torch.Tensor, *, impl: str = "pallas"
             ) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0, over
    axis 1 of (B, S, D) (RG-LRU); DTensors run local over batch and
    width."""
    if isdt(a):
        pl = _keep(a, (0, 2), a.device_mesh)
        return sdt.local(lambda al, bl: lru_scan(al, bl, impl=impl),
                         a.device_mesh, pl, (pl, pl))(a, b)
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
    outputs differentiate through the backward kernel. DTensors run
    local over batch and heads (u's gradient a partial sum over a batch
    shard)."""
    if isdt(r):
        return _sharded_gla(r, k, v, w, u, chunk, impl)
    if plain_route(r, impl):
        return ref.gla_chunked_ref(r, k, v, w, u, chunk)
    return _GlaChunkedFn.apply(_dense(r), _dense(k), _dense(v), _dense(w),
                               _dense(u.float()), chunk)


def _sharded_gla(r, k, v, w, u, chunk, impl):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = r.device_mesh
    x_pl = _keep(r, (0, 2), mesh)
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in x_pl]
    u_grad = [Partial() if p == Shard(0) else q for p, q in zip(x_pl, u_pl)]
    s_pl = [Shard(1) if p == Shard(2) else p for p in x_pl]
    fn = sdt.local(lambda *xs: gla_chunked(*xs, chunk=chunk, impl=impl),
                   mesh, (x_pl, s_pl), (x_pl,) * 4 + (u_pl,),
                   (x_pl,) * 4 + (u_grad,))
    return fn(r, k, v, w, u)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16, impl: str = "pallas"
        ) -> torch.Tensor:
    """RWKV6 linear attention, the reference's ``ops.wkv`` signature:
    out only. Its plain route is the chunked form (the reference's is the
    step recurrence; the tests hold the two together)."""
    return gla_chunked(r, k, v, w, u, chunk=chunk, impl=impl)[0]
