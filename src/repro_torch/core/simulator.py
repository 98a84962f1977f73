"""Compatibility shim over ``repro_torch.core.engine`` (the reference's
``repro.core.simulator``).

``simulate`` / ``simulate_sweep`` keep the original simulator's
signatures and return the same ``SimResult`` objects; new code should
import from ``repro_torch.core.engine`` directly and prefer
``simulate_grid`` for anything that sweeps.
"""
from repro_torch.core.engine import (SimResult, simulate,  # noqa: F401
                                     simulate_grid, simulate_sweep)

__all__ = ["SimResult", "simulate", "simulate_grid", "simulate_sweep"]
