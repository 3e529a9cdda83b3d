"""Aggregation strategy registry and the Byzantine-robust defenses (the
port of ``repro.core.fed.strategies``).

* ``"product"`` — Eq. 6: every node's scaled update unitary multiplied
  onto the global model.
* ``"average"`` — Eq. 8: the data-volume-weighted mean of the uploaded
  generators, exponentiated once per interval step.
* ``"served"`` — ``average`` over a bfloat16 wire: complex uploads
  transit it per real/imaginary part and return in their working dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Aggregation:
    """One server-side aggregation mode: ``combine`` is "product" or
    "average"; ``wire_dtype`` an optional narrow dtype of the uploads on
    the wire (None = full precision)."""
    name: str
    combine: str
    wire_dtype: Optional[str] = None


AGGREGATIONS: Dict[str, Aggregation] = {}


def register_aggregation(agg: Aggregation) -> Aggregation:
    AGGREGATIONS[agg.name] = agg
    return agg


register_aggregation(Aggregation("product", combine="product"))
register_aggregation(Aggregation("average", combine="average"))
register_aggregation(Aggregation("served", combine="average",
                                 wire_dtype="bfloat16"))


def get_aggregation(name: str) -> Aggregation:
    """Look up a registered aggregation mode; unknown names fail loudly."""
    try:
        return AGGREGATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregation {name!r}; registered: "
            f"{sorted(AGGREGATIONS)}") from None


PARTIAL_KINDS: Dict[str, str] = {
    "product": "unitary_chain",   # pods pre-multiply their Eq. 6 slice
    "average": "generator_sum",   # pods pre-sum their Eq. 8 slice
}


def partial_kind(agg: Aggregation) -> str:
    """The pod-level partial a two-level aggregation tree computes for
    this combine; a combine with no registered tree form fails loudly."""
    try:
        return PARTIAL_KINDS[agg.combine]
    except KeyError:
        raise ValueError(
            f"aggregation {agg.name!r} (combine={agg.combine!r}) has no "
            f"registered two-level partial; known combines: "
            f"{sorted(PARTIAL_KINDS)}") from None


def wire_cast(uploads: List[torch.Tensor], agg: Aggregation
              ) -> List[torch.Tensor]:
    """Apply the strategy's wire dtype to a list of uploads. Complex
    uploads round-trip their real and imaginary parts through the wire
    dtype and come back in the working dtype; real ones are cast."""
    if agg.wire_dtype is None:
        return uploads
    wd = getattr(torch, agg.wire_dtype)

    def cast(x):
        if x.is_complex():
            rd = x.real.dtype
            return torch.complex(x.real.to(wd).to(rd),
                                 x.imag.to(wd).to(rd))
        return x.to(wd)

    return [cast(x) for x in uploads]


# ---------------------------------------------------------------------------
# Byzantine-robust defenses
# ---------------------------------------------------------------------------
#   "clip"         (average) — per-matrix Frobenius norm-clip to
#                   clip_norm, non-finite uploads zeroed and de-weighted.
#   "trimmed_mean" (average) — coordinate-wise trimmed mean: drop the
#                   trim_frac smallest/largest values per coordinate.
#   "median"       (average) — coordinate-wise median (trim limit).
#   "screen"       (product) — fidelity-screened Eq. 6: uploads whose
#                   candidate fidelity falls > screen_tol below the
#                   pre-round baseline are quarantined (weight 0).
DEFENSES: Dict[str, str] = {
    "clip": "average",
    "trimmed_mean": "average",
    "median": "average",
    "screen": "product",
}


def validate_defense(name: Optional[str], combine: str) -> Optional[str]:
    """Fail-loud check that a defense exists and matches the combine it
    is defined on."""
    if name is None:
        return None
    try:
        need = DEFENSES[name]
    except KeyError:
        raise ValueError(f"unknown defense {name!r}; registered: "
                         f"{sorted(DEFENSES)}") from None
    if combine != need:
        raise ValueError(
            f"defense {name!r} is defined on combine={need!r} uploads, "
            f"not combine={combine!r}"
            + (" — product aggregation composes with a defense only via "
               "the fidelity-screened variant (defense='screen')"
               if combine == "product" else ""))
    return name


def finite_nodes(uploads: Sequence[torch.Tensor]) -> torch.Tensor:
    """(n,) bool: node i's upload is finite in every coordinate of every
    tensor (each with a leading node axis)."""
    fin = torch.ones((uploads[0].shape[0],), dtype=torch.bool,
                     device=uploads[0].device)
    for x in uploads:
        fin = fin & torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    return fin


def clip_factors(x: torch.Tensor, clip_norm: float,
                 axes: Tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """Per-slice factors min(1, clip_norm / ||x||_F) over ``axes`` (kept
    as size-1 dims so they broadcast back onto x). Real even for complex
    x; non-finite slices get 0."""
    sq = torch.sum(torch.abs(x) ** 2, dim=axes, keepdim=True)
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    f = torch.clamp(clip_norm / torch.clamp(norms, min=1e-30), max=1.0)
    return torch.where(torch.isfinite(norms), f, torch.zeros_like(f))


def _rank_weights(n_eff: torch.Tensor, n: int, kind: str, trim_frac: float,
                  dtype) -> torch.Tensor:
    """Weights over the SORTED valid values (invalid entries sort to the
    top as +inf), (n, *n_eff.shape): rank r of n_eff valid values gets
    trimmed-mean weight 1/(n_eff - 2t) for t <= r < n_eff - t, or median
    weight (the mean of the middle one or two ranks). All-invalid
    columns (n_eff == 0) get zero weights."""
    r = torch.arange(n, device=n_eff.device).reshape(
        (n,) + (1,) * n_eff.dim())
    if kind == "trimmed_mean":
        # never trim away everything: t <= (n_eff - 1) // 2
        t = torch.minimum(
            torch.floor(trim_frac * n_eff.to(torch.float64)).to(r.dtype),
            (n_eff - 1) // 2)
        keep = (r >= t) & (r < n_eff - t)
        w = keep.to(dtype) / torch.clamp(n_eff - 2 * t, min=1).to(dtype)
    elif kind == "median":
        lo, hi = (n_eff - 1) // 2, n_eff // 2
        w = 0.5 * ((r == lo).to(dtype) + (r == hi).to(dtype))
    else:
        raise ValueError(f"unknown rank-weight kind {kind!r}")
    return w * (n_eff > 0).to(dtype)


def robust_combine(x: torch.Tensor, valid: torch.Tensor, kind: str,
                   trim_frac: float) -> torch.Tensor:
    """Coordinate-wise trimmed mean / median over the leading node axis,
    restricted to ``valid`` nodes (weight > 0 and finite uploads).

    valid: (n,), or (n, *B) for independent batches B that prefix x's
    remaining axes (the sessions of a stacked round, each with its own
    valid set). Complex inputs are reduced per real/imaginary part.
    Invalid slots sort to +inf and the rank weights never reach them; a
    0-weight rank is masked out of the sum, so an inf/NaN payload cannot
    leak through 0 * inf."""
    n = x.shape[0]
    n_eff = valid.to(torch.int64).sum(dim=0)

    def real_part(xr):
        vb = valid.reshape(valid.shape + (1,) * (xr.dim() - valid.dim()))
        xs = torch.sort(torch.where(vb, xr, torch.inf), dim=0).values
        w = _rank_weights(n_eff, n, kind, trim_frac, xr.dtype)
        wb = w.reshape(w.shape + (1,) * (xr.dim() - w.dim()))
        return torch.sum(wb * torch.where(wb > 0, xs, 0.0), dim=0)

    if x.is_complex():
        return torch.complex(real_part(x.real), real_part(x.imag))
    return real_part(x)
