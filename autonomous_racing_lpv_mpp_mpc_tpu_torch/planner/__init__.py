"""The planner (the JAX package's ``planner/``): the MPP trajectory
planner and its velocity profile, online replanning, the reference tables
it emits for the tracker, and opponent cars as moving obstacle blocks."""

from .mpp import MPPDiag, plan_mpp
from .online import ReplanLog, replanning_loop

from .opponents import (
    DUMMY_BLOCK,
    OpponentSet,
    collision_trace,
    min_gap_trace,
    opponent_s_at,
    opponents,
    opponents_obstacle_fn,
    pad_blocks,
    sweep_blocks,
)
from .reftable import RefTable, refs_from_table
from .velocity_profile import curvature_speed_limit, velocity_profile

__all__ = [
    "DUMMY_BLOCK",
    "MPPDiag",
    "OpponentSet",
    "RefTable",
    "ReplanLog",
    "collision_trace",
    "curvature_speed_limit",
    "min_gap_trace",
    "opponent_s_at",
    "opponents",
    "opponents_obstacle_fn",
    "pad_blocks",
    "plan_mpp",
    "refs_from_table",
    "replanning_loop",
    "sweep_blocks",
    "velocity_profile",
]
