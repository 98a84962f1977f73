"""Timed PCS engine, torch port of ``repro.core.engine`` (switch chains,
fan-out fabrics and epoch schedules; no macro-steps yet).

  * ``state``    — machine state, stats layout, config lowering
  * ``channels`` — PM bank + PBC resource model (next-free scalars)
  * ``policy``   — allocation, victim selection, drain policies
  * ``chain``    — switch-chain forwarding through the deep-hop rows
  * ``fabric``   — fan-out fabric leaf windows and spine backpressure
  * ``handlers`` — per-op handlers, Python-branched on op and scheme
  * ``step``     — issue-time merge loop: the eager ``scan_cell``, the
                   plain version of the cell-scan kernel
  * ``grid``     — ``simulate_grid`` / ``simulate_cells`` front-ends and
                   the ``simulate`` / ``simulate_sweep`` wrappers
"""
from repro_torch.core.engine.grid import (  # noqa: F401
    simulate, simulate_cells, simulate_grid, simulate_sweep)
from repro_torch.core.engine import fabric  # noqa: F401
from repro_torch.core.engine.state import SimResult  # noqa: F401

__all__ = ["SimResult", "fabric", "simulate", "simulate_cells",
           "simulate_grid", "simulate_sweep"]
