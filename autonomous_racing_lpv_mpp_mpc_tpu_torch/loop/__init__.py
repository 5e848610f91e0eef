from .closed_loop import ClosedLoopLog, closed_loop, plant_step
from .estimator import DEFAULT_EKF_Q, EKFState, ekf_init, ekf_step, noisy_measurement
from .friction import (
    MU_MAX,
    MU_MIN,
    FrictionState,
    friction_init,
    friction_step,
    measured_axle_forces,
)
from .global_loop import estimate_frenet, f_global, global_plant_step
from .lap_learning import initial_table
from .mpc import (
    MPCCarry,
    MPCDiag,
    constant_refs,
    mpc_init,
    mpc_prepare,
    mpc_prepare_light,
    mpc_step,
    mpc_step_batched,
)
from .race import (
    BatchedRaceLog,
    RaceCarry,
    RaceLog,
    batched_race_sweep,
    corridor_eyb,
    make_racestep_scan,
    mega_race_sweep,
    race_loop,
)

__all__ = [
    "BatchedRaceLog",
    "ClosedLoopLog",
    "DEFAULT_EKF_Q",
    "EKFState",
    "FrictionState",
    "MPCCarry",
    "MPCDiag",
    "MU_MAX",
    "MU_MIN",
    "RaceCarry",
    "RaceLog",
    "batched_race_sweep",
    "closed_loop",
    "constant_refs",
    "corridor_eyb",
    "ekf_init",
    "ekf_step",
    "estimate_frenet",
    "f_global",
    "friction_init",
    "friction_step",
    "global_plant_step",
    "initial_table",
    "make_racestep_scan",
    "measured_axle_forces",
    "mega_race_sweep",
    "mpc_init",
    "mpc_prepare",
    "mpc_prepare_light",
    "mpc_step",
    "mpc_step_batched",
    "noisy_measurement",
    "plant_step",
    "race_loop",
]
