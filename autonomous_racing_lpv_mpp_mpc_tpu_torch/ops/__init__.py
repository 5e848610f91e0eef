"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``<wrapper>.launches``."""

from .admm_kernel import admm_kernel_solve, admm_solve_plain
from .fused_kernel import fused_mpc_solve, fused_solve_plain
from .megastep_kernel import (
    MegaCache,
    MegaCarry,
    megastep,
    megastep_init,
    megastep_params,
    megastep_plain,
    megacache_init,
    megastep_refs,
    mpc_core_plain,
)
from .racestep_kernel import RaceMegaCarry, racestep, racestep_init, racestep_plain

__all__ = [
    "MegaCache",
    "MegaCarry",
    "RaceMegaCarry",
    "admm_kernel_solve",
    "admm_solve_plain",
    "fused_mpc_solve",
    "fused_solve_plain",
    "megastep",
    "megastep_init",
    "megastep_params",
    "megastep_plain",
    "megacache_init",
    "megastep_refs",
    "mpc_core_plain",
    "racestep",
    "racestep_init",
    "racestep_plain",
]
