"""The port's collectives over one mesh axis, each one counted.

Every collective the port makes (the quantum fan-out's gather, the pod
tier's, the classical round's delta sum) goes through ``all_reduce`` or
``all_gather`` here. Each adds its bytes per device to every tally that
``record()`` holds open, by mesh axis and by op, counted as the
reference's HLO parse counts them (``repro.roofline.hlo_parse``): an
all-reduce twice its tensor (a ring's reduce and broadcast phases), an
all-gather its gathered output once.

On torch's ``fake`` backend a collective moves nothing: an all-reduce
leaves each rank's own tensor, a gather leaves the other ranks' parts
zero. The counts are still what the call would move.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List

import torch
import torch.distributed as dist


class Tally:
    """Bytes per device and calls of the collectives made while open."""

    def __init__(self):
        self.bytes_by_axis: Dict[str, float] = defaultdict(float)
        self.bytes_by_op: Dict[str, float] = defaultdict(float)
        self.count_by_op: Dict[str, int] = defaultdict(int)
        self.largest_by_op: Dict[str, float] = defaultdict(float)

    def add(self, axis: str, op: str, nbytes: int) -> None:
        self.bytes_by_axis[axis] += nbytes
        self.bytes_by_op[op] += nbytes
        self.count_by_op[op] += 1
        self.largest_by_op[op] = max(self.largest_by_op[op], nbytes)

    @property
    def total(self) -> float:
        return float(sum(self.bytes_by_op.values()))

    def as_dict(self) -> Dict[str, Dict]:
        return {"bytes_by_axis": dict(self.bytes_by_axis),
                "bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "largest_by_op": dict(self.largest_by_op)}


_OPEN: List[Tally] = []


@contextlib.contextmanager
def record():
    """``with record() as tally:`` counts every collective made inside."""
    tally = Tally()
    _OPEN.append(tally)
    try:
        yield tally
    finally:
        _OPEN.remove(tally)


def _note(axis: str, op: str, nbytes: int) -> None:
    for tally in _OPEN:
        tally.add(axis, op, nbytes)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its real view: the backends reduce reals."""
    return torch.view_as_real(x) if x.is_complex() else x


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate on ``axis`` of ``mesh``."""
    return mesh.get_local_rank(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``x`` (contiguous) in place over the ranks of ``axis``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    dist.all_reduce(_wire(x), group=mesh.get_group(axis))
    _note(axis, "all-reduce", 2 * x.numel() * x.element_size())
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the order of
    their coordinates on ``axis``."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.zeros_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather([_wire(p) for p in parts], _wire(x), group=group)
    _note(axis, "all-gather", len(parts) * x.numel() * x.element_size())
    return torch.cat(parts, dim)


def all_gather_rows(xs: List[torch.Tensor], mesh, axis: str
                    ) -> List[torch.Tensor]:
    """Tensors of one leading row count, each gathered along it over
    ``axis`` as ``all_gather`` would, in ONE collective: every rank's
    rows of all of them packed side by side (complex tensors as their
    real views, which must share one real dtype), gathered, unpacked."""
    rows = xs[0].shape[0]
    reals = [_wire(x.contiguous()) for x in xs]
    if len({r.dtype for r in reals}) != 1 or any(
            x.shape[0] != rows for x in xs):
        raise ValueError("all_gather_rows: one real dtype and one row "
                         "count for every tensor")
    packed = all_gather(torch.cat([r.reshape(rows, -1) for r in reals], 1),
                        mesh, axis)
    out = []
    for x, r, part in zip(xs, reals, packed.split(
            [r[0].numel() for r in reals], dim=1)):
        part = part.reshape((-1,) + r.shape[1:]).contiguous()
        out.append(torch.view_as_complex(part) if x.is_complex() else part)
    return out
