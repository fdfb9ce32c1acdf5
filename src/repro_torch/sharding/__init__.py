"""Logical-axis sharding rules of the port (the solver's problem axis)."""
from repro_torch.sharding.partition import Rules, batch_solve_rules, fit_spec

__all__ = ["Rules", "batch_solve_rules", "fit_spec"]
