"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting launches in ``<wrapper>.launches``."""

from .admm_kernel import admm_kernel_solve, admm_solve_plain
from .megastep_kernel import (
    MegaCarry,
    megastep,
    megastep_init,
    megastep_params,
    megastep_plain,
    megastep_refs,
)

__all__ = [
    "MegaCarry",
    "admm_kernel_solve",
    "admm_solve_plain",
    "megastep",
    "megastep_init",
    "megastep_params",
    "megastep_plain",
    "megastep_refs",
]
