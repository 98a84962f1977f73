"""The cell scan's macro-step instantiations (``MAC``, SPL 1, every D,
FAB and EP), run from their CUDA source on the CPU (``_warp_emul``)
against the eager ``scan_cell`` with macro-steps on, counters included:
commits, every abort reason, dead runs longer than the trace-entry
ring, tenants, more cores than lanes, and each path of a head — settled
on a tie with another core's key, the window gate from the run plan in
the op word (runs cut by the plan and by a stream's end), another core
issuing just before or after a window's second op, a replay that
commits or clears the guard, epoch boundaries settled by the floor and
by the replay, cells whose fabric or chain settles every head (powered
throughout: counted from the run plan alone; or losing power).  The
cases ``macro_reasons``, ``macro_dead``, ``macro_tenants``,
``macro_edges``, ``macro_gates`` and ``macro_epochs`` are in
``test_torch_warp_emul_macro_reasons.py``."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("macro"),))["cell_scan"]


@pytest.mark.parametrize("case", ["macro_commits", "macro_many_cores",
                                  "macro_tie", "macro_window",
                                  "macro_guard"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` with
    macro-steps on, on every output and counter, each case counting the
    abort reasons it is for (``_warp_emul.REASONS``)."""
    we.check_cell_scan_case(lib, chain_batches, case)
