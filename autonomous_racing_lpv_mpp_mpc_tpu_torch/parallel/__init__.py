from .collectives import pmax_scalar, pmean_tree, psum_tree
from .mesh import host_local_to_global, make_mesh, multihost_init, scenario_sharding
from .riccati_dist import riccati_factor_horizon_sharded
from .admm_dist import ShardedBoxQP, admm_solve_horizon_sharded, shard_boxqp
from .scenarios import (
    ScenarioBatch,
    SweepMetrics,
    make_scenario_grid,
    sharded_closed_loop,
    sharded_mega_loop,
    sharded_race_sweep,
    sharded_solve_step,
)

__all__ = [
    "host_local_to_global",
    "make_mesh",
    "multihost_init",
    "scenario_sharding",
    "psum_tree",
    "pmean_tree",
    "pmax_scalar",
    "ScenarioBatch",
    "make_scenario_grid",
    "sharded_closed_loop",
    "sharded_mega_loop",
    "sharded_race_sweep",
    "sharded_solve_step",
    "SweepMetrics",
    "riccati_factor_horizon_sharded",
    "ShardedBoxQP",
    "admm_solve_horizon_sharded",
    "shard_boxqp",
]
