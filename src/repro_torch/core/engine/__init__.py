"""Timed PCS engine, torch port of ``repro.core.engine`` (switch chains,
fan-out fabrics, epoch schedules and macro-steps).

  * ``state``    — machine state, stats layout, config lowering
  * ``channels`` — PM bank + PBC resource model (next-free scalars)
  * ``policy``   — allocation, victim selection, drain policies
  * ``chain``    — switch-chain forwarding through the deep-hop rows
  * ``fabric``   — fan-out fabric leaf windows and spine backpressure
  * ``handlers`` — per-op handlers, Python-branched on op and scheme
  * ``macro``    — guarded macro-step mini-interpreter (homogeneous-run
                   speculation; bit-exact commit-or-abort) and the
                   dead-run collapse
  * ``step``     — issue-time merge loop: the eager ``scan_cell``, the
                   plain version of the cell-scan kernel
  * ``grid``     — ``simulate_grid`` / ``simulate_cells`` front-ends, the
                   ``simulate`` / ``simulate_sweep`` wrappers and the
                   latest call's macro telemetry

The reference's ``compile_count`` counts XLA programs traced; the eager
engine and the prebuilt kernel trace nothing, so it has no counterpart.
"""
from repro_torch.core.engine.grid import (  # noqa: F401
    last_macro_abort_reasons, last_macro_hit_rate, simulate,
    simulate_cells, simulate_grid, simulate_sweep)
from repro_torch.core.engine import fabric  # noqa: F401
from repro_torch.core.engine.state import SimResult  # noqa: F401

__all__ = ["SimResult", "fabric", "simulate", "simulate_cells",
           "simulate_grid", "simulate_sweep", "last_macro_hit_rate",
           "last_macro_abort_reasons"]
