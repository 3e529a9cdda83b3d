"""Trace one sharded step of the port: the counterpart of the collective
and memory parts of ``repro.roofline.hlo_parse.parse_hlo`` (and of the
reference's ``compiled.memory_analysis()``).

The reference lowers its jitted step with XLA's SPMD partitioner and
reads the compiled program. The port runs eagerly, so ``trace_step``
runs the step once instead: its arguments are built as DTensors on a
mesh (torch's ``fake`` backend for the production meshes, or a real
one) with fake local tensors (``FakeTensorMode``: shapes and dtypes, no
memory, no data), and the run is watched op by op. On a card the fakes
are ``cuda`` tensors; without one they are CPU tensors, which take the
card's route all the same (``kernels.ops``: a fake tensor takes the
kernels' route), so the trace is the card's step either way. The
hand-written kernels are registered ops whose fakes allocate what their
wrappers allocate.

What it counts, per device (rank 0's shards):

* ``peak_bytes``: the most bytes of local tensors alive at once, from
  the arguments' shards (``argument_bytes``) up, over every tensor an op
  of the step makes: activations, the ones autograd saves for the
  backward (with remat, what its recompute makes), gradients and their
  accumulators, the optimizer's temporaries, the gathered or reduced
  buffers of DTensor's redistributions, and the kernels' outputs and
  workspaces (attention's LSE, D_i and dK/dV partials; the GLA
  backward's checkpoints). A tensor counts from the op that makes its
  storage to the moment the last tensor on that storage is freed; views
  and in-place results add nothing. ``temp_bytes`` = peak - argument
  bytes. Not counted: the caching allocator's rounding and the cuBLAS
  workspace, which ``torch.cuda.max_memory_allocated`` includes.
* every collective that DTensor issues (the ``_c10d_functional`` ops of
  its redistributions) and that ``sharding.collectives`` makes: count
  and bytes by op and by mesh axis, under ``parse_hlo``'s keys, an
  all-reduce counted twice its tensor (``hlo_parse.py:259``), an
  all-gather its gathered output, a reduce-scatter and an all-to-all
  their output;
* ``dot_flops``: the FLOPs of the ATen products the step runs
  (``torch.utils.flop_counter``'s formulas on the local shapes: mm, bmm,
  addmm, baddbmm, convolutions), not those inside the hand-written
  kernels; ``dot_flops_by_op`` splits them by op and operand shapes
  (e.g. "mm (128, 80) (80, 480)"), and ``collective_largest`` gives
  each collective op's largest single call, in the same bytes.

These are the numbers of the port's eager step, op by op, not of XLA's
fused and rescheduled program: they are not the reference's and are not
compared with them for equality.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.sharding import collectives
from repro_torch.sharding import dtensor as sdt

# _c10d_functional op -> (parse_hlo's opcode, bytes counted per byte of
# the op's input (i) or output (o))
_COMMS = {
    "all_reduce": ("all-reduce", "i", 2),
    "all_reduce_coalesced": ("all-reduce", "i", 2),
    "all_gather_into_tensor": ("all-gather", "o", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", "o", 1),
    "reduce_scatter_tensor": ("reduce-scatter", "o", 1),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "o", 1),
    "all_to_all_single": ("all-to-all", "o", 1),
    "broadcast": ("collective-broadcast", "o", 1),
}


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class CollectiveCount(TorchDispatchMode):
    """Counts the functional collectives issued while it is on (DTensor's
    redistributions, those inside its dispatch too), by op and by the
    mesh axis of their group. An op on DTensors is handed on to DTensor's
    dispatch with the mode still on (``NotImplemented``, as
    ``torch.distributed.tensor.debug.CommDebugMode`` does), so the
    collectives DTensor issues for it come back here."""

    def __init__(self, mesh):
        super().__init__()
        self.axis_of = {mesh.get_group(a).group_name: a
                        for a in mesh.mesh_dim_names}
        self.tally = collectives.Tally()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = _COMMS.get(func._opname)
            if kind is not None:
                op, side, factor = kind
                group = (kwargs or {}).get("group_name", args[-1])
                moved = _nbytes(tree_flatten(args[0] if side == "i"
                                             else out)[0])
                self.tally.add(self.axis_of.get(group, str(group)), op,
                               factor * moved)
        return out


def _in_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs each op once more on fakes of the global shapes (in the fake
    mode it finds active) to learn its output's shape: that op
    allocates nothing on a device and is not counted."""
    f = sys._getframe(2)
    while f is not None:
        if "propagate_tensor_meta" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


def _fake_mode_class():
    from torch._subclasses.fake_tensor import FakeTensorMode

    class LiveBytes(FakeTensorMode):
        """A ``FakeTensorMode`` that sees every op on local tensors
        (inside DTensor's dispatch too): it keeps the bytes of live
        storages and the product FLOPs."""

        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.counting = False
            self.depth = 0
            self.live = 0
            self.peak = 0
            self.dot_flops = 0.0
            self.dot_by_op: Dict[str, float] = {}
            self._seen = weakref.WeakSet()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            # NotImplemented: a DTensor operand, which DTensor's dispatch
            # takes on to its shards (seen here op by op)
            if (self.counting and self.depth == 0 and out is not NotImplemented
                    and not _in_propagation()):
                self._note(func, args, kwargs or {}, out)
            return out

        def _note(self, func, args, kwargs, out):
            from torch.utils.flop_counter import flop_registry
            if (func.namespace == "_c10d_functional"
                    and func is not torch.ops._c10d_functional.wait_tensor
                    .default):
                # a collective's buffer is what its wait returns, in place
                # on the card; a fake wait gives a new storage, counted
                # there
                return
            for t in tree_flatten(out)[0]:
                if not isinstance(t, torch.Tensor) or sdt.is_dtensor(t):
                    continue
                st = t.untyped_storage()
                if st in self._seen:
                    continue
                self._seen.add(st)
                n = st.nbytes()
                self.live += n
                weakref.finalize(st, self._free, n)
            self.peak = max(self.peak, self.live)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                n = count(*args, **kwargs, out_val=out)
                self.dot_flops += n
                key = " ".join([func._overloadpacket.__name__] + [
                    str(tuple(a.shape)) for a in args
                    if isinstance(a, torch.Tensor)])
                self.dot_by_op[key] = self.dot_by_op.get(key, 0.0) + n

        def _free(self, n):
            self.live -= n

        def start(self, args) -> int:
            """Count from here, the storages of ``args`` (a tree) held
            already; returns their bytes."""
            held = storage_bytes(args)
            for t in tree_flatten(args)[0]:
                if isinstance(t, torch.Tensor):
                    self._seen.add((t.to_local() if sdt.is_dtensor(t)
                                    else t).untyped_storage())
            self.live = self.peak = held
            self.counting = True
            return held

    return LiveBytes


def storage_bytes(*trees) -> int:
    """Bytes of the distinct local storages of the tensors in ``trees``
    (dicts, lists or tensors; a DTensor's shard)."""
    seen, total = set(), 0
    for tree in trees:
        for t in tree_flatten(tree)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if sdt.is_dtensor(t):
                t = t.to_local()
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


@dataclasses.dataclass
class StepTrace:
    argument_bytes: int
    peak_bytes: int
    dot_flops: float
    tally: collectives.Tally
    dot_flops_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def collective_record(self) -> Dict:
        """``parse_hlo``'s collective keys (with the dot FLOPs)."""
        return collective_record(self.tally, self.dot_flops)


def collective_record(tally: collectives.Tally,
                      dot_flops: Optional[float] = None) -> Dict:
    rec = {"collective_bytes": dict(tally.bytes_by_op),
           "collective_count": dict(tally.count_by_op),
           "collective_bytes_total": tally.total,
           "collective_bytes_by_axis": dict(tally.bytes_by_axis),
           "collective_largest": dict(tally.largest_by_op)}
    if dot_flops is not None:
        rec["dot_flops"] = dot_flops
    return rec


def trace_step(build: Callable, mesh) -> StepTrace:
    """Run ``step(*args)`` once, where ``(step, args) = build()`` is
    called under the trace's fake mode (so its tensors are fake), with
    ``mesh`` the DeviceMesh of the args' DTensors; count as the module's
    docstring says."""
    mode = _fake_mode_class()()
    comms = CollectiveCount(mesh)
    with mode:
        step, args = build()
        argument_bytes = mode.start(args)
        with collectives.record() as own, comms:
            out = step(*args)
        mode.counting = False
        del out
    return StepTrace(argument_bytes, mode.peak, mode.dot_flops,
                     _merged(comms.tally, own), mode.dot_by_op)


def _merged(tally: collectives.Tally, own: collectives.Tally
            ) -> collectives.Tally:
    """``tally`` with the port's own collectives (``own``) added."""
    for op, n in own.bytes_by_op.items():
        tally.bytes_by_op[op] += n
        tally.count_by_op[op] += own.count_by_op[op]
        tally.largest_by_op[op] = max(tally.largest_by_op[op],
                                      own.largest_by_op[op])
    for axis, n in own.bytes_by_axis.items():
        tally.bytes_by_axis[axis] += n
    return tally


def count_collectives(fn: Callable, mesh):
    """(fn(), the collectives it made as ``collective_record``'s dict):
    the same count as ``trace_step``'s, for a run on real tensors."""
    comms = CollectiveCount(mesh)
    with collectives.record() as own, comms:
        out = fn()
    return out, collective_record(_merged(comms.tally, own))

