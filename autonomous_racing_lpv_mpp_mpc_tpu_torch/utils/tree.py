"""Trees of tensors (the port's stand-in for ``jax.tree``): a tree is a
tensor, a NamedTuple, a dict, a list or tuple, or a frozen dataclass (a
:class:`ScenarioBatch`, :class:`VehicleParams`) of trees; any other value
(a float parameter, None) is a constant that maps to itself."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every tensor leaf of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure); the structure is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, in :func:`tree_map`'s order
    (dicts in insertion order). Paths are the JAX package's key strings
    joined by "/" (``jax.tree_util`` keys: a field ``.X``, a dict key
    ``['acc']``, an index ``[0]``), so a log saved by either package reads
    back under the same names."""
    if isinstance(tree, torch.Tensor):
        return [("/".join(prefix), tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        keys = [(f".{n}", v) for n, v in zip(tree._fields, tree)]
    elif isinstance(tree, (tuple, list)):
        keys = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        keys = [(f"[{k!r}]", v) for k, v in tree.items()]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        keys = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        return []
    return [item for key, v in keys for item in tree_items(v, prefix + (key,))]
