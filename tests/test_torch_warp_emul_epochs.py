"""The cell scan's epoch-schedule instantiations (``EP``, macro-steps
off; SPL 1, and SPL 2 at ``D = 3``), run from their CUDA source on the
CPU (``_warp_emul``) against the eager ``scan_cell``.  Its other cases are in
``test_torch_warp_emul_epochs_chain.py``, ``_epochs_d2.py``,
``_epochs_fabric.py`` and ``_epochs_layers.py``."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("epochs"),))["cell_scan"]


@pytest.mark.parametrize("case", ["epochs_d0", "epochs_mixed"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` on every
    output, each case reaching the epochs and instantiation it is for."""
    we.check_cell_scan_case(lib, chain_batches, case)
