from .assembly import (
    N_CON,
    augment_dynamics,
    block_curvatures,
    build_boxqp,
    constraint_rows,
    corridor_from_blocks,
    initial_schedule,
    scheduled_stages,
    shift_schedule,
    steerable_curvature,
    tracker_bounds,
)

__all__ = [
    "N_CON",
    "augment_dynamics",
    "block_curvatures",
    "build_boxqp",
    "constraint_rows",
    "corridor_from_blocks",
    "initial_schedule",
    "scheduled_stages",
    "shift_schedule",
    "steerable_curvature",
    "tracker_bounds",
]
