"""Device dispatch for the port's kernels (the ``impl="pallas"``
backend of the quantum path and of the model's sequence layers).

A tensor on the card launches the hand-written CUDA kernel, or the
kernel's wrapper raises; a tensor on the CPU takes the kernel's plain
version in ``ref``. The sequence ops also take ``impl="xla"``, which
gives the plain version on any device. There is no other route and no
fallback.
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
    return x.device.type == "cpu"


def _dense(x: torch.Tensor) -> torch.Tensor:
    """The kernels read raw storage: materialise lazy conjugate/negative
    views (``x.conj()`` only sets a bit) and make the layout contiguous."""
    return x.resolve_conj().resolve_neg().contiguous()


def complex_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched complex matmul (B, M, K) @ (B, K, N) -> complex128."""
    if _on_cpu(a):
        return ref.zgemm_ref(a, b)
    return _zgemm.zgemm(_dense(a), _dense(b))


def fidelity(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Re<phi|rho|phi> per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.fidelity_ref(phi, rho)
    return _fid.fidelity_batch(_dense(phi), _dense(rho))


def mse(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """||rho - |phi><phi|||_F^2 per pair -> (N,) float64."""
    if _on_cpu(phi):
        return ref.mse_ref(phi, rho)
    return _fid.mse_batch(_dense(phi), _dense(rho))


def ensemble_commutator_trace(a: torch.Tensor, b: torch.Tensor
                              ) -> torch.Tensor:
    """T[j] = sum_n tr_rest(A_{j,n} B_{j,n}) for keep-major ensembles
    a (J, N, Ea, dk, dr), b (J, N, Eb, dk, dr) -> (J, dk, dk) complex128."""
    if _on_cpu(a):
        return ref.ensemble_commutator_trace_ref(a, b)
    return _zgemm.ensemble_commutator_trace(_dense(a), _dense(b))


def _plain(x: torch.Tensor, impl: str) -> bool:
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl {impl!r}: 'pallas' or 'xla'")
    return impl == "xla" or _on_cpu(x)


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
    if _plain(q, impl):
        out = ref.attention_ref(qf, kf, vf, causal=causal, window=window)
    else:
        out = _fa.flash_attention(_dense(qf), _dense(kf), _dense(vf),
                                  causal=causal, window=window)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def lru_scan(a: torch.Tensor, b: torch.Tensor, *, impl: str = "pallas"
             ) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t, h_0 = 0, over
    axis 1 of (B, S, D) (RG-LRU)."""
    if _plain(a, impl):
        return ref.rglru_scan_ref(a, b)
    return _rg.rglru_scan(_dense(a), _dense(b))


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                impl: str = "pallas"):
    """RWKV6 wkv as chunked gated linear attention: r, k, v, w
    (B, S, H, dh) with w in (0, 1) (keep it fp32), u (H, dh), ``chunk``
    dividing S -> (out (B, S, H, dh) in r's dtype, final state
    (B, H, dh, dh) fp32). The model layer's entry."""
    if _plain(r, impl):
        return ref.gla_chunked_ref(r, k, v, w, u, chunk)
    return _gla.gla_chunked(_dense(r), _dense(k), _dense(v), _dense(w),
                            _dense(u.float()), chunk=chunk)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 16, impl: str = "pallas"
        ) -> torch.Tensor:
    """RWKV6 linear attention, the reference's ``ops.wkv`` signature:
    out only. Its plain route is the chunked form (the reference's is the
    step recurrence; the tests hold the two together)."""
    return gla_chunked(r, k, v, w, u, chunk=chunk, impl=impl)[0]
