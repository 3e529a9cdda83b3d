"""Aggregation strategy registry (the port of
``repro.core.fed.strategies``, without the defenses).

* ``"product"`` — Eq. 6: every node's scaled update unitary multiplied
  onto the global model.
* ``"average"`` — Eq. 8: the data-volume-weighted mean of the uploaded
  generators, exponentiated once per interval step.
* ``"served"`` — ``average`` over a bfloat16 wire: complex uploads
  transit it per real/imaginary part and return in their working dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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
