"""Planner outputs consumed by the tracker (the JAX package's ``planner/``):
reference tables, and opponent cars as moving obstacle blocks."""

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

__all__ = [
    "DUMMY_BLOCK",
    "OpponentSet",
    "RefTable",
    "collision_trace",
    "min_gap_trace",
    "opponent_s_at",
    "opponents",
    "opponents_obstacle_fn",
    "pad_blocks",
    "refs_from_table",
    "sweep_blocks",
]
