"""Collective wrappers (the JAX package's ``parallel/collectives.py``).

Every cross-rank communication of the port goes through this module, so
that single-card code paths hold no collective and one module is the audit
point: ``tests/test_torch_parallel.py`` fails on a raw collective of
``torch.distributed`` anywhere else in the package. Each function takes a
process group: one dimension of a :class:`DeviceMesh`
(``mesh.get_group("scenarios")``), or ``None`` for the whole world. A tree
is a tensor, a NamedTuple, a dict or a list of trees (``utils.tree``).
The tensors must lie on the group's device: the card under NCCL, the CPU
under gloo. Every function returns new tensors; none writes its input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_map


def _reduced(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum_tree(tree, group: Optional[dist.ProcessGroup] = None):
    """Sum of every leaf over the group's ranks, replicated on each."""
    return tree_map(lambda x: _reduced(x, dist.ReduceOp.SUM, group), tree)


def pmean_tree(tree, group: Optional[dist.ProcessGroup] = None):
    n = dist.get_world_size(group)
    return tree_map(lambda x: _reduced(x, dist.ReduceOp.SUM, group) / n, tree)


def pmax_scalar(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Elementwise max over the group's ranks (any shape; the name is the
    JAX package's: the solvers use it for stacked scalar residual norms)."""
    return _reduced(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Each rank's ``x`` in group-rank order, stacked along a new ``axis``
    or, with ``tiled``, concatenated along ``axis``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def all_gather_tree(tree, group: Optional[dist.ProcessGroup] = None, *, axis: int = 0,
                    tiled: bool = False):
    return tree_map(lambda x: all_gather(x, group, axis=axis, tiled=tiled), tree)


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    """Wait until every rank of the group has reached this call."""
    dist.barrier(group=group)
