"""Compare the cell scan's chain-free machine code with another source's.

Card-only tool (it needs ``nvcc`` and ``cuobjdump``): builds
``csrc/cell_scan.cu`` and the ``cell_scan.cu`` given on the command line
(for example an earlier revision's, saved with ``git show
<rev>:src/repro_torch/kernels/csrc/cell_scan.cu > old.cu``) to cubins with
the package's flags, and compares the SASS of the current
``cell_scan_kernel<SPL, 0>`` (no switch chain) with the other source's
``cell_scan_kernel<SPL, 0>`` (or ``cell_scan_kernel<SPL>``, from before
the chain's template parameter) for SPL = 1, 2, 4, instruction by
instruction:

    PYTHONPATH=src python -m repro_torch.kernels.sass_diff old.cu

Prints, per SPL, both instruction counts and the instructions that
differ (branch targets aside, which only move when code after them
changes length).
"""
from __future__ import annotations

import difflib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import _build

CUDA_BIN = Path("/usr/local/cuda/bin")


def sass(src: Path, out: Path) -> dict:
    """``{function name: [instruction, ...]}`` of ``src`` built to ``out``."""
    flags = [f for f in _build.nvcc_flags("cell_scan")
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([str(CUDA_BIN / "nvcc"), *flags, f"-I{_build.CSRC}",
                    "-cubin", "-o", str(out), str(src)], check=True)
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


def main(other: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(Path(other), Path(tmp) / "other.cubin")
        new = sass(_build.CSRC / "cell_scan.cu", Path(tmp) / "this.cubin")
    same = True
    for spl in (1, 2, 4):
        o = next(v for k, v in old.items()
                 if f"cell_scan_kernelILi{spl}ELi0EE" in k
                 or f"cell_scan_kernelILi{spl}EE" in k)
        n = next(v for k, v in new.items()
                 if f"cell_scan_kernelILi{spl}ELi0EE" in k)
        ops = difflib.SequenceMatcher(
            a=[_no_target(x) for x in o], b=[_no_target(x) for x in n],
            autojunk=False).get_opcodes()
        diff = [op for op in ops if op[0] != "equal"]
        same &= not diff and len(o) == len(n)
        print(f"cell_scan_kernel SPL={spl}: other {len(o)} instructions, "
              f"D = 0 {len(n)}, differing runs {len(diff)}"
              + ("" if o != n or diff else "; identical"))
        for tag, i1, i2, j1, j2 in diff[:4]:
            print(f"  {tag}: {o[i1:i2][:4]} -> {n[j1:j2][:4]}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
