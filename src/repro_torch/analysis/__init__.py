"""Static invariant analysis of the port (torch counterpart of
``repro.analysis``).

Four passes, each pinning a contract the test suite can only probe
dynamically (and expensively):

  * ``retrace``  — every sweepable config knob is consumed by the plain
    ``scan_cell`` and reaches the cell-scan kernel through its operand
    tables, in the order of the enums the kernel reads them by (no
    baked statics, no knob that no-ops on the card);
  * ``mirror``   — replicated engine expressions (slot/NoPB/macro
    twins, policy guards) stay structurally identical, and handler
    families cover the same stats columns;
  * ``twin``     — engine and untimed oracle consume the same policy
    fields and map their statistics onto each other;
  * ``dtypes``   — the packed carry keeps its dtypes and no f64 -> f32
    time leak happens in a step.

``sweeps`` (the benchmark sweep registry against the telemetry the
figure scripts emit) is ported too, but takes its benchmark directory as
an argument and is not in :data:`PASSES`: the port has no benchmark
scripts yet.

Like the reference's, the analysis runs on the host: the mirror, twin
and kernel-table checks read the port's sources (``src/repro_torch``
and ``kernels/csrc/cell_scan.cu``), and the dynamic half runs the plain
``core/engine/step.py::scan_cell`` on CPU tensors of one small exemplar
cell (``_engine``), as the reference traces its engine abstractly
without a device.  That is by design, not a fallback, so the CLI takes
no device.  It imports neither ``jax`` nor anything of ``repro``.

CLI: ``python -m repro_torch.analysis [--fail-on-findings] [--json PATH]
[--pass NAME]``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.common import Finding

__all__ = ["Finding", "PASSES", "run_all", "run_pass"]


def _retrace() -> List[Finding]:
    from repro_torch.analysis import retrace
    return retrace.check_engine()


def _mirror() -> List[Finding]:
    from repro_torch.analysis import mirror
    return mirror.check()


def _twin() -> List[Finding]:
    from repro_torch.analysis import twin
    return twin.check()


def _dtypes() -> List[Finding]:
    from repro_torch.analysis import dtypes
    return dtypes.check()


PASSES = {
    "retrace": _retrace,
    "mirror": _mirror,
    "twin": _twin,
    "dtypes": _dtypes,
}


def run_pass(name: str) -> List[Finding]:
    return PASSES[name]()


def run_all() -> Dict[str, List[Finding]]:
    """Run every pass; pass name -> findings (empty list when clean)."""
    return {name: fn() for name, fn in PASSES.items()}
