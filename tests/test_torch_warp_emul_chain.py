"""The cell scan's switch-chain instantiations (``D >= 1``, no fabric,
schedule or macro-steps), run from their CUDA source on the CPU
(``_warp_emul``) against the eager ``scan_cell``.  The cases about
the chain's batches are in ``test_torch_warp_emul_chain_batches.py``."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("chain"),))["cell_scan"]


@pytest.mark.parametrize("case", ["chain_d1", "chain_d2", "chain_d3",
                                  "chain_wide", "chain_bank"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` on every
    output, each case reaching what it is for in the eager chain
    (``_warp_emul.REACH``)."""
    we.check_cell_scan_case(lib, chain_batches, case)
