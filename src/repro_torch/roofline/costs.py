"""Operations and bytes of the port's hand-written kernels, from the
shapes of their inputs, and the least time an H100 could take for them.

Bytes count each input read once and each output written once;
operations count what these inputs need. The least time is the larger
of the bytes at HBM rate and the operations at the peak for their type.
``chip_smoke.py``'s kernel rows and ``roofline.trace_parse`` both read
these, so each formula has one home.
"""
from __future__ import annotations

from typing import Tuple

# H100 SXM peaks (NVIDIA H100 Tensor Core GPU data sheet, dense, at the
# 700 W limit): HBM3 bytes/s, fp32 FLOP/s outside the tensor cores
# (what the quantum kernels and the scan use), bf16 and TF32 tensor-core
# FLOP/s (the fp32 attention kernels and GLA's tensor-core path run their
# products in 3xTF32 at TF32_FLOPS / 3).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12


def _bound(nbytes: float, ops_ms: float) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, ops_ms), ("bytes" if t_bytes >= ops_ms
                                  else "operations")


# ------------------------------------------------------- quantum kernels
def quantum_work(name, args) -> Tuple[int, int]:
    """(bytes, fp32 operations) of zgemm, the trace, fidelity or mse."""
    if name == "zgemm":
        a, b = args
        bsz, m, k = a.shape
        n = b.shape[2]
        nbytes = 16 * (bsz * m * k + bsz * k * n + bsz * m * n)
        flops = 8 * bsz * m * n * k            # 4 mul + 4 add per complex MAC
    elif name == "ensemble_commutator_trace":
        a, b = args
        j, n, ea, dk, dr = a.shape
        eb, k = b.shape[2], dk * dr
        nbytes = 16 * (a.numel() + b.numel() + j * dk * dk)
        flops = 8 * j * n * (2 * ea * eb * k + dk * dk * eb * dr)
    else:
        phi, rho = args
        n, d = phi.shape
        nbytes = 16 * (phi.numel() + rho.numel()) + 8 * n
        flops = (10 if name == "fidelity" else 12) * n * d * d
    return nbytes, flops


def bound_ms(name, args):
    """Least time for the work on an H100: each input read once, each
    output written once, at HBM rate, against the fp32 operations at the
    fp32 peak; the larger of the two, and which one it is."""
    nbytes, flops = quantum_work(name, args)
    return _bound(nbytes, flops / FP32_FLOPS * 1e3)


# ------------------------------------------------------ sequence kernels
def allowed_pairs(sq, sk, causal, window, q_offset=0):
    """(query, key) pairs the mask allows for one head: query rows at
    positions q_offset.., keys from 0, j < sk, j <= i when causal,
    j > i - window when window > 0."""
    n = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def gla_flops(b, s, h, dh, chunk):
    """fp32 operations of the chunked GLA form at these inputs, as
    (products, the rest): per chunk of L tokens (the last one shorter
    where L does not divide S), the products are the inter term and the
    state update (2 L dh^2 each: a multiply and an add per term) and
    scores @ v over the L(L+1)/2 pairs (2 per value column); the rest is
    the decayed scores of the L(L-1)/2 strictly lower pairs (subtract,
    exp, two multiplies and an add per channel), the bonus (3 per
    token-channel), the per-element log-decay, its cumulative sum and the
    decayed q and k (9 per token-channel), and the state's decay (one
    multiply per entry)."""
    def per_chunk(n):
        return (4 * n * dh * dh + dh * n * (n + 1),
                5 * dh * n * (n - 1) // 2 + 12 * n * dh + dh * dh)
    whole, tail = divmod(s, chunk)
    (p, q), (pt, qt) = per_chunk(chunk), per_chunk(tail)
    return (b * h * (whole * p + (pt if tail else 0)),
            b * h * (whole * q + (qt if tail else 0)))


def gla_least_ms(b, s, h, dh):
    """Least time on an H100 for GLA's operations at these inputs: the
    function does not depend on the chunk, so the least over chunk
    lengths (1 to 64; longer ones only cost more) of the products at the
    3xTF32 rate (three TF32 tensor-core products each, as the kernel's
    tensor-core path runs them) and the rest at the fp32 rate."""
    return min(p / (TF32_FLOPS / 3) + q / FP32_FLOPS
               for p, q in (gla_flops(b, s, h, dh, n) for n in range(1, 65))
               ) * 1e3


def gla_bwd_flops(b, s, h, dh, chunk):
    """fp32 operations of the chunked GLA backward at these inputs, as
    (products, the rest), by the forward's reckoning (``gla_flops``): per
    chunk of L tokens the products are five (L x dh) by (dh x dh)
    products (the states' recompute k_dec^T v, the carried dS's q_dec^T
    dO, and the inter terms of dr, dk and dv, 2 L dh^2 each) and two over
    the L(L+1)/2 pairs (dO v^T and A^T dO, 2 dh a pair each); the rest
    is the decayed scores again and the decayed pair terms of dr and dk
    (13 a strictly lower pair and channel), per token-channel the
    forward's 12 and the bonus terms of dr, dk and du and dw's sums (11),
    and per chunk the decays of the state and of dS and dw's chunk term
    (dh^2 each)."""
    def per_chunk(n):
        return (10 * n * dh * dh + 2 * dh * n * (n + 1),
                13 * dh * n * (n - 1) // 2 + 23 * n * dh + 3 * dh * dh)
    whole, tail = divmod(s, chunk)
    (p, q), (pt, qt) = per_chunk(chunk), per_chunk(tail)
    return (b * h * (whole * p + (pt if tail else 0)),
            b * h * (whole * q + (qt if tail else 0)))


def gla_bwd_bytes(args):
    """Bytes the GLA backward must move at (r, k, v, w, u, dout[,
    dstate]): r, k, v, w, dout, u and dstate read once, dr, dk, dv, dw
    and du written once."""
    r, w, u = args[0], args[3], args[4]
    return (r.element_size() * 7 * r.numel()     # r k v dout; dr dk dv
            + w.element_size() * 2 * w.numel()   # w; dw
            + 4 * 2 * u.numel()
            + sum(4 * x.numel() for x in args[6:] if x is not None))


def gla_bwd_bound_ms(args):
    """Least time for the GLA backward at (r, k, v, w, u, dout[, dstate]):
    ``gla_bwd_bytes`` at HBM rate against its operations as
    ``gla_least_ms`` takes the forward's (the least over chunk lengths 1
    to 64 of the products at the 3xTF32 rate and the rest at the fp32
    rate); the larger."""
    return _bound(gla_bwd_bytes(args), gla_bwd_ops_ms(*args[0].shape))


def attention_work(q, k, v, kw) -> Tuple[int, int, float]:
    """(bytes, operations, peak) of the attention forward at q (B, Sq, H,
    dh), k/v (B, Sk, K, dh): q, k, v read and out written once; QK^T and
    PV over the allowed pairs (2 FLOP a MAC); bf16 tensor cores, or fp32
    storage's products in 3xTF32."""
    b, sq, h, dh = q.shape
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    pairs = allowed_pairs(sq, k.shape[1], kw.get("causal", True),
                          kw.get("window", 0), kw.get("q_offset", 0))
    peak = BF16_FLOPS if q.element_size() == 2 else TF32_FLOPS / 3
    return nbytes, 4 * dh * pairs * b * h, peak


def gla_bytes(args):
    """Bytes of the GLA forward at (r, k, v, w, u): r, k, v read and out
    written in their dtype, w and u read, the final fp32 state written."""
    r, k, v, w, u = args
    b, s, h, dh = r.shape
    return (r.element_size() * 4 * r.numel() + w.element_size() * w.numel()
            + 4 * u.numel() + 4 * b * h * dh * dh)


def scan_work(a) -> Tuple[int, int, float]:
    """(bytes, operations, peak) of the scan h_t = a_t h_{t-1} + b_t:
    a and b read, h written; a multiply and an add an element."""
    peak = BF16_FLOPS if a.element_size() == 2 else FP32_FLOPS
    return a.element_size() * 3 * a.numel(), 2 * a.numel(), peak


def seq_bound_ms(name, args, kw):
    """Least time on an H100 for the function at these inputs: bytes
    (inputs once, outputs once) at HBM rate against the operations at the
    peak for their type (bf16 tensor cores for bf16 attention, the
    3xTF32 rate TF32_FLOPS / 3 for fp32 attention's products, fp32 CUDA
    cores for the scan, ``gla_least_ms`` for GLA), the larger of the
    two."""
    if name == "flash_attention":
        nbytes, flops, peak = attention_work(*args, kw)
    elif name == "gla_chunked":
        b, s, h, dh = args[0].shape
        return _bound(gla_bytes(args), gla_least_ms(b, s, h, dh))
    else:
        nbytes, flops, peak = scan_work(args[0])
    return _bound(nbytes, flops / peak * 1e3)


def attn_bwd_work(q, k) -> Tuple[int, float]:
    """(bytes, peak) of the attention backward at heads-major q (BH, Sq,
    dh), k (BK, Sk, dh): q, o, dO, dQ and k, v, dK, dV crossing HBM once."""
    peak = BF16_FLOPS if q.element_size() == 2 else TF32_FLOPS / 3
    return q.element_size() * (4 * q.numel() + 4 * k.numel()), peak


def attn_bwd_flops(q, k, kw) -> int:
    """The backward's five products, 10 dh FLOP an allowed pair."""
    bh, sq, dh = q.shape
    return 10 * dh * bh * allowed_pairs(sq, k.shape[1], kw["causal"],
                                        kw["window"], kw.get("q_offset", 0))


def attn_bwd_bound_ms(q, k, kw):
    """Least time for the attention backward at these inputs: q, o, dO,
    dQ and k, v, dK, dV crossing HBM once against the five products (10
    dh FLOP an allowed pair) at the peak for the storage type (bf16
    tensor cores, or fp32 in 3xTF32 at TF32_FLOPS / 3)."""
    nbytes, peak = attn_bwd_work(q, k)
    return _bound(nbytes, attn_bwd_flops(q, k, kw) / peak * 1e3)


def gla_bwd_ops_ms(b, s, h, dh):
    """``gla_least_ms`` for the backward's operations."""
    return min(p / (TF32_FLOPS / 3) + q / FP32_FLOPS
               for p, q in (gla_bwd_flops(b, s, h, dh, n)
                            for n in range(1, 65))) * 1e3


def kernel_work(name, args, kw) -> Tuple[int, int, float]:
    """(bytes, operations, operations' least ms) of one launch of the
    hand-written kernel ``name`` at its wrapper's arguments: the
    operations the launch runs (GLA at its own chunk), and the least
    time for them at the peak for their type, as the kernel's row in
    ``chip_smoke.py`` takes it."""
    kw = {"causal": True, "window": 0, **kw}
    if name in ("zgemm", "ensemble_commutator_trace", "fidelity", "mse"):
        nbytes, flops = quantum_work(name, args)
        return nbytes, flops, flops / FP32_FLOPS * 1e3
    if name == "flash_attention":
        # the wrapper's heads-major (BH, S, dh) operands as (BH, S, 1, dh)
        q, k, v = (x if x.dim() == 4 else x.unsqueeze(2) for x in args[:3])
        nbytes, flops, peak = attention_work(q, k, v, kw)
    elif name == "flash_attention_bwd":
        nbytes, peak = attn_bwd_work(args[0], args[1])
        flops = attn_bwd_flops(args[0], args[1], kw)
    elif name == "rglru_scan":
        nbytes, flops, peak = scan_work(args[0])
    elif name == "gla_chunked":
        b, s, h, dh = args[0].shape
        return (gla_bytes(args[:5]), sum(gla_flops(b, s, h, dh, kw["chunk"])),
                gla_least_ms(b, s, h, dh))
    elif name == "gla_chunked_bwd":
        b, s, h, dh = args[0].shape
        return (gla_bwd_bytes(args),
                sum(gla_bwd_flops(b, s, h, dh, kw["chunk"])),
                gla_bwd_ops_ms(b, s, h, dh))
    else:
        raise ValueError(f"no hand-written kernel {name!r}")
    return nbytes, flops, flops / peak * 1e3
