"""Compare the cell scan's schedule-free machine code with another source's.

Card-only tool (it needs ``nvcc`` and ``cuobjdump``): builds
``csrc/cell_scan.cu`` and the ``cell_scan.cu`` given on the command line
(for example an earlier revision's, saved with ``git show
<rev>:src/repro_torch/kernels/csrc/cell_scan.cu > old.cu``) to cubins with
the package's flags, and compares the SASS of every ``EP = false``
instantiation of the current ``cell_scan_kernel<SPL, D, FAB, EP>``
(D = 0..3 deep-hop rows; FAB both ways for D >= 1) with the other
source's same ``<SPL, D, FAB>`` — named ``cell_scan_kernel<SPL, D, FAB,
false>``, ``cell_scan_kernel<SPL, D, FAB>`` (from before the epoch
schedules' template parameter), ``cell_scan_kernel<SPL, D>`` (FAB =
false, from before the fabric's) or, for D = 0,
``cell_scan_kernel<SPL>`` (from before the chain's) — for SPL = 1, 2, 4,
instruction by instruction:

    PYTHONPATH=src python -m repro_torch.kernels.sass_diff old.cu

Prints each build's seconds, then per (SPL, D, FAB) both instruction
counts and the instructions that differ (branch targets aside, which
only move when code after them changes length), and the ``EP = true``
instantiations' counts.
"""
from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from repro_torch.kernels import _build

CUDA_BIN = Path("/usr/local/cuda/bin")
MAX_DEEP = 3


def sass(src: Path, out: Path) -> dict:
    """``{function name: [instruction, ...]}`` of ``src`` built to ``out``."""
    flags = [f for f in _build.nvcc_flags("cell_scan")
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    t0 = time.time()
    subprocess.run([str(CUDA_BIN / "nvcc"), *flags, f"-I{_build.CSRC}",
                    "-cubin", "-o", str(out), str(src)], check=True)
    print(f"built {src} in {time.time() - t0:.1f} s")
    text = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur is not None and m:
            cur.append(m.group(1).strip())
    return funcs


def _no_target(ins: str) -> str:
    return re.sub(r"0x[0-9a-f]+", "TARGET", ins) if "BRA" in ins else ins


def _find(funcs: dict, names) -> list | None:
    """The first function whose mangled name holds one of ``names``."""
    for name in names:
        for k, v in funcs.items():
            if f"cell_scan_kernel{name}" in k:
                return v
    return None


def _names(spl: int, d: int, fab: int) -> list:
    """The mangled template arguments of ``<spl, d, fab>``, newest first."""
    names = [f"ILi{spl}ELi{d}ELb{fab}ELb0EE", f"ILi{spl}ELi{d}ELb{fab}EE"]
    if not fab:
        names.append(f"ILi{spl}ELi{d}EE")
        if d == 0:
            names.append(f"ILi{spl}EE")
    return names


def main(other: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(Path(other), Path(tmp) / "other.cubin")
        new = sass(_build.CSRC / "cell_scan.cu", Path(tmp) / "this.cubin")
    same = True
    combos = [(spl, d, fab) for spl in (1, 2, 4)
              for d in range(MAX_DEEP + 1) for fab in ((0, 1) if d else (0,))]
    for spl, d, fab in combos:
        names = _names(spl, d, fab)
        o = _find(old, names)
        n = _find(new, names[:1])
        what = f"cell_scan_kernel SPL={spl} D={d} FAB={bool(fab)} EP=false"
        if o is None or n is None:
            print(f"{what}: missing (other {o is not None}, this "
                  f"{n is not None})")
            same = False
            continue
        ops = difflib.SequenceMatcher(
            a=[_no_target(x) for x in o], b=[_no_target(x) for x in n],
            autojunk=False).get_opcodes()
        diff = [op for op in ops if op[0] != "equal"]
        same &= not diff and len(o) == len(n)
        print(f"{what}: other {len(o)} instructions, this {len(n)}, "
              f"differing runs {len(diff)}"
              + ("" if diff or len(o) != len(n) else "; identical"))
        for tag, i1, i2, j1, j2 in diff[:4]:
            print(f"  {tag}: {o[i1:i2][:4]} -> {n[j1:j2][:4]}")
    for spl, d, fab in combos:
        n = _find(new, [f"ILi{spl}ELi{d}ELb{fab}ELb1EE"])
        print(f"cell_scan_kernel SPL={spl} D={d} FAB={bool(fab)} EP=true: "
              f"{len(n or [])} instructions")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
