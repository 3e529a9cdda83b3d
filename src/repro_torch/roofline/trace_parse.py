"""Read a ``torch.profiler`` run for the roofline: the port's counterpart
of ``repro.roofline.hlo_parse``, which reads XLA's compiled HLO text.

``profile(fn)`` runs ``fn`` once under the profiler and gives, on the
card, the device time and launch count by op (kernel name) and by
family, and the busy share: the union of the device's kernel and copy
intervals over the call's wall time, both under the profiler. A CPU run
has no device: its ops are the ATen ops the call made (those not inside
another ATen op), counted, with no time (``None``), so no CPU time is
reported as a device number.

``count(fn)`` runs ``fn`` once more to count its work: the dot FLOPs of
the ATen ops (``torch.utils.flop_counter.FlopCounterMode``) and, since
the counter cannot see inside an extension call, each hand-written
kernel's launches, FLOPs, bytes and the least time for those FLOPs at
the peak for their type, from the shapes its wrapper was given
(``roofline.costs``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.roofline import costs

# device kernel name (substring) -> the hand-written kernel it belongs to
KERNEL_NAMES = (
    ("zgemm_kernel", "zgemm"),
    ("ect_partial_kernel", "ensemble_commutator_trace"),
    ("ect_reduce_kernel", "ensemble_commutator_trace"),
    ("state_kernel", "fidelity/mse"),
    ("attn_bwd_", "flash_attention_bwd"),
    ("flash_wgmma_kernel", "flash_attention"),
    ("flash_kernel", "flash_attention"),
    ("nan_scan_kernel", "flash_attention"),
    ("rglru_kernel", "rglru_scan"),
    ("gla_bwd_", "gla_chunked_bwd"),
    ("gla_kernel", "gla_chunked"),
)

# family -> substrings of device kernel names or of CPU op names
FAMILY_MARKS = (
    ("collective", ("nccl", "c10d::", "gloo")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "aten::mm",
              "aten::bmm",
              "aten::addmm", "aten::baddbmm", "aten::matmul", "aten::linear",
              "aten::einsum",
              "aten::_scaled_dot_product")),
    ("copy", ("memcpy", "copy", "aten::cat", "aten::clone",
              "aten::contiguous", "aten::index", "aten::gather")),
    ("fill", ("memset", "fill", "aten::zero", "aten::ones", "aten::zeros")),
)


def family(name: str) -> str:
    """The family of a device kernel or CPU op: the hand-written kernel
    by name, gemm, collective, copy, fill, or elementwise (the rest)."""
    for mark, kernel in KERNEL_NAMES:
        if mark in name:
            return kernel
    low = name.lower()
    for fam, marks in FAMILY_MARKS:
        if any(m.lower() in low for m in marks):
            return fam
    return "elementwise"


@dataclasses.dataclass
class Trace:
    """One profiled call. Times in microseconds, None without a card."""
    device: str
    wall_us: float                        # host clock, under the profiler
    busy_us: Optional[float]
    by_op: Dict[str, Tuple[Optional[float], int]]
    by_family: Dict[str, Tuple[Optional[float], int]]

    @property
    def busy_share(self) -> Optional[float]:
        return None if self.busy_us is None else self.busy_us / self.wall_us

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.by_op.values())


def _group(events, timed: bool):
    by_op: Dict[str, list] = {}
    by_family: Dict[str, list] = {}
    for name, us in events:
        for table, key in ((by_op, name), (by_family, family(name))):
            row = table.setdefault(key, [0.0 if timed else None, 0])
            if timed:
                row[0] += us
            row[1] += 1
    return ({k: tuple(v) for k, v in by_op.items()},
            {k: tuple(v) for k, v in by_family.items()})


def profile(fn: Callable[[], object]) -> Trace:
    """Profile one call of ``fn``: device kernels and copies on the card
    (the allocator's "Buffer" records left out), the call's ATen ops
    without a card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    if not cuda:
        top = [(e.name, 0.0) for e in events
               if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::")
               and not (e.cpu_parent is not None
                        and e.cpu_parent.name.startswith("aten::"))]
        by_op, by_family = _group(top, timed=False)
        return Trace("cpu", wall_us, None, by_op, by_family)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and "Buffer" not in e.name)
    busy, end = 0.0, float("-inf")
    for t_start, t_end, _ in spans:
        busy += max(0.0, t_end - max(t_start, end))
        end = max(end, t_end)
    by_op, by_family = _group(((n, t1 - t0) for t0, t1, n in spans),
                              timed=True)
    return Trace("cuda", wall_us, busy, by_op, by_family)


# ------------------------------------------------------------ the work
# (module of repro_torch.kernels, wrapper, kernel name in roofline.costs)
_WRAPPERS = (
    ("zgemm", "zgemm", "zgemm"),
    ("zgemm", "ensemble_commutator_trace", "ensemble_commutator_trace"),
    ("fidelity", "fidelity_batch", "fidelity"),
    ("fidelity", "mse_batch", "mse"),
    ("flash_attention", "flash_attention", "flash_attention"),
    ("flash_attention", "flash_attention_bwd", "flash_attention_bwd"),
    ("rglru_scan", "rglru_scan", "rglru_scan"),
    ("gla_chunked", "gla_chunked", "gla_chunked"),
    ("gla_chunked", "gla_chunked_bwd", "gla_chunked_bwd"),
)


@dataclasses.dataclass
class Work:
    """What one call computes: ATen dot FLOPs and, per hand-written
    kernel, [launches, FLOPs, bytes, the FLOPs' least ms]."""
    dot_flops: int
    kernels: Dict[str, list]

    @property
    def kernel_flops(self) -> int:
        return sum(k[1] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k[2] for k in self.kernels.values())

    @property
    def kernel_ops_ms(self) -> float:
        return sum(k[3] for k in self.kernels.values())


@contextlib.contextmanager
def kernel_calls():
    """Count each hand-written kernel's launches, FLOPs, bytes and the
    least time for its FLOPs, from the arguments its wrapper is given,
    while open."""
    import importlib
    table: Dict[str, list] = defaultdict(lambda: [0, 0, 0, 0.0])
    saved = []
    for mod_name, attr, kernel in _WRAPPERS:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        orig = getattr(mod, attr)

        def counted(*args, _orig=orig, _k=kernel, **kw):
            nbytes, flops, ops_ms = costs.kernel_work(_k, args, kw)
            row = table[_k]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
            row[3] += ops_ms
            return _orig(*args, **kw)
        setattr(mod, attr, counted)
        saved.append((mod, attr, orig))
    try:
        yield table
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def count(fn: Callable[[], object]) -> Work:
    """Run ``fn`` once, counting its ATen dot FLOPs and its hand-written
    kernels' work."""
    from torch.utils.flop_counter import FlopCounterMode
    with kernel_calls() as table, FlopCounterMode(display=False) as fc:
        fn()
    return Work(int(fc.get_total_flops()), {k: list(v)
                                            for k, v in table.items()})
