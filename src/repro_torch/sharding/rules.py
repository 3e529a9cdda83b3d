"""Logical-axis sharding rules (the port of ``repro.sharding.rules``).

Params and activations are annotated with *logical* axis names; a rule
table maps logical names to mesh axes. ``spec_for`` drops any mapping
that does not divide the concrete dimension (e.g. kv_heads=8 on a model
axis of 16 falls back to replicated), so one rule table serves every
architecture and mesh. The table and the algorithm are the reference's.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a plain ``{axis: size}`` mapping,
in mesh-dim order. The mapping form computes specs and per-device
shard shapes with no process group at all (the dry run, the tests).

``spec_for`` returns a tuple with the entries of the reference's
``PartitionSpec``: per tensor dim a mesh axis name, a tuple of names, or
None, trailing Nones dropped. ``sharding_for`` turns it into DTensor
placements, one per mesh dim.

The ambient mesh is torch's own ``DeviceMesh`` context: ``with mesh:``
pushes it on ``torch.distributed.device_mesh._mesh_resources
.mesh_stack``, which ``current_mesh`` reads.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

# Default rule table for the production meshes ('data', 'model') and
# ('pod', 'data', 'model'). 'pod' is the federation axis: parameters are
# NEVER sharded over it by rules (the fed substrate gives them an
# explicit leading node axis instead).
DEFAULT_RULES: Dict[str, Optional[str]] = {
    # parameter axes
    "embed": ("pod", "data"),  # FSDP over data (and pod when present)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    # head_dim falls back to 'model' when heads/kv_heads don't divide it
    # (e.g. qwen1.5's 20 heads on a 16-way axis): spec_for's used-axis
    # tracking makes heads and head_dim mutually exclusive.
    "head_dim": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "rnn": "model",
    "layers": None,
    "conv": None,
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,
    # Megatron-style sequence parallelism at layer boundaries
    "act_seq_sp": "model",
    # decode KV-cache sequence dim (distributed-softmax decode)
    "act_cache_seq": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_embed": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_capacity": "data",
    "act_rnn": "model",
    # KV-cache head_dim: sharded over 'model' when kv_heads doesn't
    # divide it (spec_for's used-axis tracking makes these exclusive)
    "cache_head_dim": "model",
    # context parallelism: query-sequence over 'model' for archs whose
    # head count does not divide the model axis (e.g. qwen1.5's 20 heads)
    "act_seq_cp": "model",
    # federation axis (leading node dim in fed mode)
    "fed_node": "pod",
    None: None,
}

Spec = Tuple  # per dim: None, an axis name, or a tuple of axis names

# Context overrides for the rule table (e.g. federated mode keeps params
# replicated across pods: embed -> 'data' only).
_OVERRIDES: Dict[str, Optional[str]] = {}
_MISSING = object()


class rule_overrides:
    def __init__(self, **kv):
        self.kv = kv
        self.saved: Dict[str, Optional[str]] = {}

    def __enter__(self):
        for k, v in self.kv.items():
            self.saved[k] = _OVERRIDES.get(k, _MISSING)
            _OVERRIDES[k] = v
        return self

    def __exit__(self, *exc):
        for k, old in self.saved.items():
            if old is _MISSING:
                _OVERRIDES.pop(k, None)
            else:
                _OVERRIDES[k] = old
        return False


def active_rules(rules: Optional[Dict[str, Optional[str]]] = None
                 ) -> Dict[str, Optional[str]]:
    base = rules or DEFAULT_RULES
    if not _OVERRIDES:
        return base
    merged = dict(base)
    merged.update(_OVERRIDES)
    return merged


def rule_axes(name: str) -> Tuple[str, ...]:
    """The mesh axes the active rules give the logical axis ``name``
    (none for a rule of None, e.g. ``act_batch`` under the decode's
    override)."""
    return _as_axes(active_rules().get(name))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh-dim order, of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return mesh_shape(mesh).get(axis, 1)


# Names that claim their mesh axis BEFORE positional order (so e.g. a
# cache's kv_heads outranks its seq dim for the 'model' axis).
PRIORITY_NAMES = ("heads", "kv_heads", "act_heads", "act_kv_heads",
                  "experts", "act_experts", "mlp", "act_mlp", "vocab",
                  "act_vocab")


def _as_axes(rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]], mesh,
             rules: Optional[Dict[str, Optional[str]]] = None) -> Spec:
    """The partition spec for ``shape`` given logical ``names``.

    - a rule may name several mesh axes (e.g. act_batch over
      ('pod','data')); axes absent from the mesh are dropped
    - any axis whose (product) size does not divide the dimension is
      dropped: one rule table serves every architecture and mesh
    - PRIORITY_NAMES claim axes before positionally-earlier dims
    """
    rules = active_rules(rules)
    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(names)}")
    sizes = mesh_shape(mesh)
    out: list = [None] * len(shape)
    used = set()

    def try_assign(i: int) -> None:
        axes = [a for a in _as_axes(rules.get(names[i]))
                if a in sizes and a not in used]
        # greedy: use the full axis tuple if divisible, else prefixes
        while axes:
            total = math.prod(sizes[a] for a in axes)
            if shape[i] % total == 0 and total > 1:
                out[i] = tuple(axes) if len(axes) > 1 else axes[0]
                used.update(axes)
                return
            axes.pop(0)  # drop the outermost axis and retry

    for i, name in enumerate(names):
        if name in PRIORITY_NAMES:
            try_assign(i)
    for i, name in enumerate(names):
        if out[i] is None and name not in PRIORITY_NAMES:
            try_assign(i)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shard shape of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides its axes, by ``spec_for``)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in _as_axes(entry))
    return tuple(out)


def sharding_for(shape, names, mesh, rules=None):
    """DTensor placements of ``spec_for``'s spec, one per mesh dim:
    ``Shard(d)`` where the mesh axis splits tensor dim d (on each of the
    axes of a dim that spans several), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    spec = spec_for(shape, names, mesh, rules)
    owner = {a: d for d, entry in enumerate(spec) for a in _as_axes(entry)}
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_shape(mesh))


def tree_specs(shapes_tree: Dict[str, torch.Tensor],
               names_tree: Dict[str, Tuple], mesh, rules=None
               ) -> Dict[str, Spec]:
    """``spec_for`` over parallel flat dicts of tensors and names."""
    return {k: spec_for(v.shape, names_tree[k], mesh, rules)
            for k, v in shapes_tree.items()}


def _mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def constrain(x: torch.Tensor, *names: Optional[str], mesh=None,
              rules: Optional[Dict[str, Optional[str]]] = None
              ) -> torch.Tensor:
    """The reference's sharding constraint by logical names: a DTensor is
    redistributed to the placements the names give on its own mesh
    (the ambient ``with mesh:`` is thread-local: the autograd engine's
    device threads, which recompute remat cycles, do not see it); a
    plain tensor is returned as it is outside a mesh or on a one-rank
    mesh. A plain tensor on a mesh of several ranks holds one rank's
    data, which no placement describes, so it is refused."""
    from torch.distributed.tensor import DTensor
    if mesh is None:
        mesh = x.device_mesh if isinstance(x, DTensor) else current_mesh()
    if mesh is None:
        return x
    if isinstance(x, DTensor):
        return x.redistribute(mesh, sharding_for(x.shape, names, mesh,
                                                 rules))
    if _mesh_size(mesh) == 1:
        return x
    raise ValueError("constrain on a mesh of several ranks needs a "
                     "DTensor; a plain tensor is one rank's data")


def current_mesh():
    """The ambient ``with mesh:`` DeviceMesh (torch's own mesh context),
    or None outside one. Public so callers (e.g. the federated quantum
    round) can pick a fan-out strategy."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = _mesh_resources.mesh_stack
    return stack[-1] if stack else None


def fed_fanout_axis(mesh) -> Optional[str]:
    """The mesh axis backing the 'fed_node' logical axis: the axis the
    federated node fan-out shards over (the quantum round's nodes, the
    classical round's node-indexed trees). None when the mesh does not
    carry it."""
    sizes = mesh_shape(mesh)
    for a in _as_axes(active_rules().get("fed_node")):
        if a in sizes:
            return a
    return None


def num_params(tree: Dict[str, torch.Tensor]) -> int:
    return int(sum(math.prod(x.shape) for x in tree.values()))
