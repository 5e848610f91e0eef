"""The rank mesh (the JAX package's ``parallel/mesh.py``, in
``torch.distributed``'s idiom).

One process per device: a rank owns one card (NCCL) or one CPU process
(gloo). The mesh is a :class:`DeviceMesh` with dims ``("scenarios",
"horizon")``: ``scenarios`` splits the scenario batch (the data-parallel
analog), ``horizon`` the horizon's stage blocks of each scenario's solve.
Every collective lives in ``collectives.py``.

A sharded entry point (``scenarios.py``, ``horizon.py``) takes on each
rank that rank's shard of the scenario batch, the contiguous slice
:func:`scenario_sharding` cuts from the global batch (the layout of the JAX
package's multi-process tests: rank r holds lanes ``[r b, (r + 1) b)``),
and returns the local shard of its logs; :func:`host_local_to_global`
gathers such shards back into the global batch on every rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.config import MeshConfig
from ..core.device import resolve_device
from ..utils.tree import tree_map
from .collectives import all_gather

SCENARIO_AXIS = "scenarios"
HORIZON_AXIS = "horizon"


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch build lacks")
        return "nccl"
    return "gloo"


def multihost_init(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, device=None) -> None:
    """Start the process group (nothing if one is up).

    The group comes, in this order, from ``init_method`` (``file://...`` or
    ``tcp://host:port``, with ``world_size`` and ``rank``, else the
    ``WORLD_SIZE`` / ``RANK`` variables), from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or, with
    neither, a group of this process alone (the JAX package's
    single-process mesh). The backend is NCCL on a CUDA ``device``
    (``None``: the card) and gloo on the CPU; a CUDA rank binds its card
    ``LOCAL_RANK`` (else its rank modulo the cards present)."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = _backend(device)
    env = os.environ
    if init_method is not None:
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(env["RANK"]) if rank is None else rank
    elif "MASTER_ADDR" in env and "RANK" in env and "WORLD_SIZE" in env:
        init_method, world_size, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        world_size, rank = 1, 0
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def make_mesh(n_scenario: Optional[int] = None, n_horizon: int = 1, device=None) -> DeviceMesh:
    """A (scenarios, horizon) mesh over every rank, rank-major (rank r sits
    at ``(r // n_horizon, r % n_horizon)``); starts the process group first
    if there is none (:func:`multihost_init`). ``n_scenario`` defaults to
    the world size over ``n_horizon``. Every rank must call it, in the same
    order as any other mesh or group."""
    device = resolve_device(device)
    multihost_init(device=device)
    world = dist.get_world_size()
    if n_scenario is None:
        n_scenario = world // n_horizon
    if n_scenario * n_horizon != world:
        raise ValueError(f"a {n_scenario} x {n_horizon} mesh needs {n_scenario * n_horizon} ranks; "
                         f"the group has {world}")
    ranks = torch.arange(world).reshape(n_scenario, n_horizon)
    return DeviceMesh(device.type, ranks, mesh_dim_names=(SCENARIO_AXIS, HORIZON_AXIS))


def from_config(cfg: MeshConfig, device=None) -> DeviceMesh:
    return make_mesh(cfg.n_scenario, cfg.n_horizon, device=device)


def scenario_sharding(mesh: DeviceMesh, tree):
    """This rank's contiguous slice of a batch-first tree along the
    scenario dim (every tensor leaf with a leading batch dim; the batch must
    divide evenly). Ranks that differ only in their horizon coordinate hold
    the same slice."""
    n = mesh.size(mesh.mesh_dim_names.index(SCENARIO_AXIS))
    i = mesh.get_local_rank(SCENARIO_AXIS)

    def cut(x):
        if x.dim() == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} scenario ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return tree_map(cut, tree)


def host_local_to_global(mesh: DeviceMesh, tree):
    """The global batch on every rank from each rank's scenario shard: the
    shards' batch-first leaves concatenated in scenario-rank order (0-d
    leaves are taken as replicated). The inverse of
    :func:`scenario_sharding`; one all-gather per leaf."""
    group = mesh.get_group(SCENARIO_AXIS)
    if dist.get_world_size(group) == 1:
        return tree
    return tree_map(lambda x: x if x.dim() == 0 else all_gather(x, group, tiled=True), tree)
