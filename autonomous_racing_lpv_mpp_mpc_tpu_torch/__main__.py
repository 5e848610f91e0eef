"""``python -m autonomous_racing_lpv_mpp_mpc_tpu_torch``: the experiment
command line (``cli.py``). Importing this module runs nothing."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
