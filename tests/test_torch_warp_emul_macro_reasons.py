"""The cell scan's macro-step instantiations (``MAC``, SPL 1, every D,
FAB and EP) on the cases ``macro_reasons``, ``macro_dead``,
``macro_tenants``, ``macro_edges``, ``macro_gates`` and ``macro_epochs``
(what each must reach: ``_warp_emul.REACH`` and ``REASONS``), run from
their CUDA source on the CPU (``_warp_emul``) against the eager
``scan_cell`` with macro-steps on, counters included.  Split from
``test_torch_warp_emul_macro.py`` so that ``--dist loadfile`` can give
the two halves to two workers."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("macro"),))["cell_scan"]


@pytest.mark.parametrize("case", ["macro_reasons", "macro_dead",
                                  "macro_tenants", "macro_edges",
                                  "macro_gates", "macro_epochs"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` with
    macro-steps on, on every output and counter, each case counting the
    abort reasons it is for (``_warp_emul.REASONS``)."""
    we.check_cell_scan_case(lib, chain_batches, case)
