from .discretize import discretize, discretize_euler, discretize_expm, discretize_order2
from .dynamics import (
    DENOM_EPS,
    DYN_NX,
    KIN_NX,
    NU,
    VX_EPS,
    f_dynamic,
    f_kinematic,
    f_model,
    frenet_denom,
    model_nx,
)
from .lpv import lpv_ab, lpv_ab_dynamic, lpv_ab_kinematic, ltv_abc
from .tires import axle_loads, tire_force, tire_force_linear, tire_force_pacejka

__all__ = [
    "DENOM_EPS", "DYN_NX", "KIN_NX", "NU", "VX_EPS",
    "axle_loads", "discretize", "discretize_euler", "discretize_expm", "discretize_order2",
    "f_dynamic", "f_kinematic", "f_model", "frenet_denom", "lpv_ab",
    "lpv_ab_dynamic", "lpv_ab_kinematic", "ltv_abc", "model_nx", "tire_force",
    "tire_force_linear", "tire_force_pacejka",
]
