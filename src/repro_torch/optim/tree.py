"""The trees the optimizers walk: dicts, lists and tuples of tensors
(the port's flat model params, the QNN's per-layer unitaries, optimizer
states as NamedTuples), nested; ``None`` is an empty subtree (SGD's
momentum without momentum)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (the same structure), in a tree of that
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):          # a NamedTuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)
