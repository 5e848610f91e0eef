from .assembly import (
    N_CON,
    augment_dynamics,
    build_boxqp,
    constraint_rows,
    initial_schedule,
    scheduled_stages,
    shift_schedule,
    tracker_bounds,
)

__all__ = [
    "N_CON",
    "augment_dynamics",
    "build_boxqp",
    "constraint_rows",
    "initial_schedule",
    "scheduled_stages",
    "shift_schedule",
    "tracker_bounds",
]
