from .scenarios import ScenarioBatch, make_scenario_grid

__all__ = ["ScenarioBatch", "make_scenario_grid"]
