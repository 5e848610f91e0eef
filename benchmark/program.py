"""The program under test, the PyTorch/CUDA port, as the route files call
it: its configuration objects built from a configuration file's numbers,
its track and its reference rows. Nothing here computes a result."""

from __future__ import annotations

PACKAGE = "autonomous_racing_lpv_mpp_mpc_tpu_torch"


def configs(config: dict, backend: str = "plain"):
    """(VehicleParams, MPCConfig, SolverConfig) of the port for a
    configuration file's dict."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core.config import (
        MPCBounds, MPCConfig, MPCWeights, SolverConfig, VehicleParams,
    )

    w = config["weights"]
    cfg = MPCConfig(N=int(config["N"]), dt=float(config["dt"]), model=config["model"], tire=config["tire"],
                    linearization=config["linearization"], discretization=config["discretization"],
                    kappa_speed_cap=bool(config["kappa_speed_cap"]), a_lat_frac=float(config["a_lat_frac"]),
                    weights=MPCWeights(q=tuple(w["q"]), r=tuple(w["r"]), dr=tuple(w["dr"])),
                    bounds=MPCBounds(**config["bounds"]))
    scfg = SolverConfig(**config["solver"], backend=backend)
    return VehicleParams(**config["vehicle"]), cfg, scfg


def track(config: dict, device):
    """The port's compiled track of the configuration: the builder of the
    port's ``track`` module that the configuration's ``track`` names."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch import track as tr

    return getattr(tr, config["track"])(width=float(config["track_width"]), ds=float(config["track_ds"]),
                                        device=device)


def constant_refs(cfg, vx_ref: float, device):
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.mpc import constant_refs as refs

    return refs(cfg, vx_ref, device=device)


def build_kernels() -> None:
    """Build the port's CUDA kernels into its own cache in the checkout
    (``<package>/_build/``, keyed by the sources' hash) and load them."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda

    _cuda.library()
