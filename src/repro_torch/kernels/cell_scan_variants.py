"""Text-edited variants of the cell scan for A/B runs on the card.

Each variant is ``csrc/cell_scan.cu`` with a few text edits (an edit
whose anchor is not found exactly once raises), written out as a
source that ``chip_smoke.py --against`` builds and holds against the
package's cell scan: outputs equal, kernel times in turns, section
profiles.  Every variant's units are cut to the ones the ``--against``
grids launch — SPL 1 at D = 0, 1 and 3, MAC both ways — so that several
build at once in little time.  Run from the root of the checkout:

    PYTHONPATH=src python -m repro_torch.kernels.cell_scan_variants \
        OUT [--from OLD.cu] [names]

writes ``OUT/<name>.cu`` for each variant named (all by default) of the
package's source, or of ``OLD.cu`` (an earlier revision's, which must
hold the anchors) written as ``OUT/<stem of OLD>_<name>.cu``, then
``python3 chip_smoke.py --against OUT/<name>.cu ...`` on the card.

* ``units``: the source as it is, units cut (the yardstick);
* ``pick_noinline``: the deep read's ``pick`` compiled out of line, so
  that the hop-1 read path's code holds no chain code;
* ``probe_early``: a chain cell's deep tags loaded beside hop 1's own
  loads on every PM read, as before this slice (the source loads them
  once hop 1 has no live entry);
* ``probe_live``: only the live rows' deep tags loaded, each load
  predicated on its row's liveness;
* ``bounds_1``: ``__launch_bounds__(32, 1)`` on every instantiation,
  the ``D = 0`` ones too, which lets ptxas use every register a lane
  may hold instead of spilling (the source gives ``D >= 1`` and ``MAC``
  that);
* ``bounds_heuristic``: ``__launch_bounds__(32)`` on every
  instantiation: ptxas's own register heuristic at ``D >= 1`` too.
"""
from __future__ import annotations

import sys
from pathlib import Path

from repro_torch.kernels import _build

UNITS = ("  X(1, 0, 0) X(1, 1, 0) X(1, 2, 0) X(1, 3, 0) X(2, 0, 0) X(2, 1, 0)       \\\n"
         "  X(2, 2, 0) X(2, 3, 0) X(4, 0, 0) X(4, 1, 0) X(4, 2, 0) X(4, 3, 0)       \\\n"
         "  X(1, 0, 1) X(1, 1, 1) X(1, 2, 1) X(1, 3, 1) X(2, 0, 1) X(2, 1, 1)       \\\n"
         "  X(2, 2, 1) X(2, 3, 1) X(4, 0, 1) X(4, 1, 1) X(4, 2, 1) X(4, 3, 1)",
         "  X(1, 0, 0) X(1, 1, 0) X(1, 3, 0) X(1, 0, 1) X(1, 1, 1) X(1, 3, 1)")
VARIANTS = {
    "units": [],
    "pick_noinline": [("  __device__ int pick(",
                       "  __device__ __noinline__ int pick(")],
    "probe_early": [("      const int bank = bank_of(addr);\n"
                     "      const double pm_start_dir",
                     "      unsigned deep_tm = 0;\n"
                     "      if constexpr (D > 0) deep_tm = ch.probe(addr);\n"
                     "      const int bank = bank_of(addr);\n"
                     "      const double pm_start_dir"),
                    ("ch.pick(ch.probe(addr), ", "ch.pick(deep_tm, ")],
    "probe_live": [("        const int tg = c.dtag[idx(j, s < P ? s : 0)];\n"
                    "        if (j < live_rows && s < pbe[j] && tg == addr)",
                    "        const bool live = j < live_rows;\n"
                    "        const int tg = live ? c.dtag[idx(j, s < P ? s : "
                    "0)] : addr + 1;\n"
                    "        if (live && s < pbe[j] && tg == addr)")],
    "bounds_1": [("__launch_bounds__(32, (D > 0 || MAC) ? 1 : 0)",
                  "__launch_bounds__(32, 1)")],
    "bounds_heuristic": [("__launch_bounds__(32, (D > 0 || MAC) ? 1 : 0)",
                          "__launch_bounds__(32)")],
}


def variant_source(text: str, edits) -> str:
    """``text`` with each ``(anchor, replacement)`` of ``edits`` and the
    units cut applied; raises when an anchor is not found exactly
    once."""
    for anchor, repl in [UNITS] + list(edits):
        if text.count(anchor) != 1:
            raise ValueError(f"anchor found {text.count(anchor)} times: "
                             f"{anchor!r}")
        text = text.replace(anchor, repl)
    return text


def main(out: str, names, source: str | None = None) -> int:
    src = Path(source) if source else _build.CSRC / "cell_scan.cu"
    text = src.read_text()
    prefix = f"{src.stem}_" if source else ""
    Path(out).mkdir(parents=True, exist_ok=True)
    for name in names or VARIANTS:
        path = Path(out) / f"{prefix}{name}.cu"
        path.write_text(variant_source(text, VARIANTS[name]))
        print(path)
    return 0


if __name__ == "__main__":
    args = sys.argv[2:]
    source = None
    if args[:1] == ["--from"]:
        source, args = args[1], args[2:]
    sys.exit(main(sys.argv[1], args, source))
