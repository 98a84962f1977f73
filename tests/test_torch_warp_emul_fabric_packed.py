"""The cell scan's fabric instantiations on the packed two-leaf case,
the longest, run from its CUDA source on the CPU (``_warp_emul``)
against the eager ``scan_cell``.  Split from
``test_torch_warp_emul_fabric.py`` so that ``--dist loadfile`` can give
it a worker of its own."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("fabric"),))["cell_scan"]


@pytest.mark.parametrize("case", ["fabric_l2_packed"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` on every
    output."""
    we.check_cell_scan_case(lib, chain_batches, case)
