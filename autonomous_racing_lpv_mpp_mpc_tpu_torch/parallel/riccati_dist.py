"""Cross-rank horizon-sharded Riccati factorization (the JAX package's
``parallel/riccati_dist.py``).

The O(N na^3) value-function recursion is split over a process group (the
mesh's ``horizon`` dim), each rank holding a contiguous chunk of stages:

1. each rank runs a local reverse associative scan over its chunk's
   value-composition elements (A, C, J) (``solver.riccati``'s
   ``value_elements`` / ``combine_value``, the algebra of
   ``riccati_factor_assoc``);
2. the chunk aggregates, one (na, na) triple per rank, are all-gathered,
   and each rank composes the aggregates of all later chunks into its
   exclusive suffix;
3. the local suffixes completed with it give every local stage its exact
   V_{k+1}, from which the gains are formed stage by stage.

Leading batch dims are kept (one factorization per lane).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..solver.riccati import (
    LQRCost, LQRDynamics, RiccatiFactors, _reverse_scan, combine_value, factors_from_value, value_elements,
)
from .collectives import all_gather_tree


def riccati_factor_horizon_sharded(dyn: LQRDynamics, cost: LQRCost,
                                   group: Optional[dist.ProcessGroup] = None) -> RiccatiFactors:
    """Distributed factorization of the full-horizon LQR; returns the local
    chunk's factors.

    ``dyn`` holds the rank's chunk: A (..., Nc, na, na), B (..., Nc, na,
    nu), c (..., Nc, na); ``cost`` its rows, Q and q with Nc+1 of them, row
    Nc the terminal value seed, which only the group's last rank uses."""
    nh = dist.get_world_size(group)
    idx = dist.get_rank(group)
    na = dyn.A.shape[-1]
    last = idx == nh - 1
    F, C, Xq = value_elements(dyn, cost)
    # the pad slot: the terminal element (A=0, C=0, J=Q_N) on the last
    # rank, the identity element (A=I, C=0, J=0) elsewhere
    zero = torch.zeros_like(F[..., :1, :, :])
    eye = torch.eye(na, dtype=F.dtype, device=F.device).expand(zero.shape)
    elems = (torch.cat([F, zero if last else eye], dim=-3), torch.cat([C, zero], dim=-3),
             torch.cat([Xq, cost.Q[..., -1:, :, :] if last else zero], dim=-3))
    local = _reverse_scan(combine_value, elems)

    # the chunk aggregate is the suffix at the first local element
    aggs = all_gather_tree(tuple(e[..., :1, :, :] for e in local), group, axis=-3, tiled=True)
    if last:
        J = local[2]
    else:
        # the exclusive suffix of the later chunks, then each local suffix
        # completed with it (the local part is earlier in time)
        later = _reverse_scan(combine_value, tuple(a[..., idx + 1:, :, :] for a in aggs))
        excl = tuple(e[..., :1, :, :] for e in later)
        J = combine_value(excl, local)[2]
    return factors_from_value(dyn, cost, J[..., 1:, :, :])
