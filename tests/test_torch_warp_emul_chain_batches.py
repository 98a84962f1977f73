"""The cell scan's switch-chain instantiations on the cases about the
chain's batches (long runs at SPL 2 and 4, commit gates inside a batch,
a line that must not repeat in a batch), run from their CUDA source on
the CPU (``_warp_emul``) against the eager ``scan_cell``.  Split from
``test_torch_warp_emul_chain.py`` so that ``--dist loadfile`` can give
the two halves to two workers."""
from __future__ import annotations

import pytest

import _warp_emul as we
from _warp_emul import chain_batches  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("chain"),))["cell_scan"]


@pytest.mark.parametrize("case", ["chain_long_spl2", "chain_long_spl4",
                                  "chain_gate", "chain_dup"])
def test_emulated_cell_scan_equals_eager_scan_cell(lib, chain_batches, case):
    """The emulated kernel against the eager ``scan_cell`` on every
    output, each case reaching what it is for in the eager chain
    (``_warp_emul.REACH``)."""
    we.check_cell_scan_case(lib, chain_batches, case)
