"""The experiment presets (the JAX package's ``bench``): BASELINE's five
configurations and the flagship programs, runnable by name."""

from .presets import PRESETS, run_preset

__all__ = ["PRESETS", "run_preset"]
