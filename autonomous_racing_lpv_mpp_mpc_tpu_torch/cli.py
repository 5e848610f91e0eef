"""Experiment command line (the JAX package's ``cli.py``), on the CUDA card:

    python -m autonomous_racing_lpv_mpp_mpc_tpu_torch list
    python -m autonomous_racing_lpv_mpp_mpc_tpu_torch run config2 T=900 max_iter=80 backend=fused
    python -m autonomous_racing_lpv_mpp_mpc_tpu_torch run config1 device=cpu plot=run.png

Overrides are ``key=value`` pairs: solver keys (max_iter, rho, eps_abs,
backend, ...) go to SolverConfig, vehicle keys (m, mu, Cf, ...) to
VehicleParams, anything else to the preset (T, batch, device, ...). A
``backend`` may be a port name (plain, admm, fused) or the JAX package's
(xla, pallas). ``device=cpu`` runs on the CPU; without it every preset
runs on the card and raises where there is none. ``plot=PATH`` renders the
closed-loop figure of the lap presets (needs matplotlib); ``save=PATH``
stores the result dict as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from .bench.presets import PRESETS, run_preset
from .convert import BACKENDS
from .core.config import SolverConfig, VehicleParams


def _coerce(val: str):
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    return val


def _split_overrides(pairs):
    """(SolverConfig keys, VehicleParams keys, the rest), in that order of
    precedence: a key naming a SolverConfig field (``backend`` among them)
    goes there, even where the preset has a knob of the same name."""
    sfields = {f.name for f in dataclasses.fields(SolverConfig)}
    vfields = {f.name for f in dataclasses.fields(VehicleParams)}
    s_kw, v_kw, rest = {}, {}, {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"override must be key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        val = _coerce(v)
        if k in sfields:
            s_kw[k] = val
        elif k in vfields:
            v_kw[k] = val
        else:
            rest[k] = val
    if "backend" in s_kw:
        s_kw["backend"] = BACKENDS.get(s_kw["backend"], s_kw["backend"])
    return s_kw, v_kw, rest


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)

    if cmd == "list":
        for name, fn in sorted(PRESETS.items()):
            print(f"{name}: {(fn.__doc__ or '').strip().splitlines()[0]}")
        return 0

    if cmd == "run":
        if not argv:
            raise SystemExit("usage: run <preset> [key=value ...]")
        name = argv.pop(0)
        s_kw, v_kw, rest = _split_overrides(argv)
        save_path = rest.pop("save", None)
        scfg = SolverConfig(max_iter=60).replace(**s_kw)
        p = VehicleParams(**v_kw)
        result = run_preset(name, p=p, scfg=scfg, **rest)
        print(json.dumps({"preset": name, **result}, indent=2))
        if save_path:
            with open(save_path, "w") as f:
                json.dump({"preset": name, **result}, f, indent=2)
        return 0

    raise SystemExit(f"unknown command {cmd!r}; try 'list' or 'run'")


if __name__ == "__main__":
    raise SystemExit(main())
