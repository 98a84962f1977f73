"""Compare the cell scan's machine code with another source's.

Card-only tool (it needs ``nvcc`` and ``cuobjdump``): builds
``csrc/cell_scan.cu`` and the ``cell_scan.cu`` given on the command line
(for example an earlier revision's, saved with ``git show
<rev>:src/repro_torch/kernels/csrc/cell_scan.cu > old.cu``) to cubins with
the package's flags — a source that lists units
(``_build.unit_sources``) one cubin per unit, all at once, as the
library is built — and compares the SASS of every instantiation of
``cell_scan_kernel<SPL, D, FAB, EP, MAC>`` (SPL = 1, 2, 4; D = 0..3
deep-hop rows; FAB both ways for D >= 1; EP both ways; MAC both ways)
with the other source's same instantiation, instruction by instruction.
An instantiation from before a template parameter existed is found under
its older name: ``cell_scan_kernel<SPL, D, FAB, EP>`` (MAC = false,
before the macro-steps), ``cell_scan_kernel<SPL, D, FAB>`` (EP = false,
before the epoch schedules), ``cell_scan_kernel<SPL, D>`` (FAB = false,
before the fabric) or, for D = 0, ``cell_scan_kernel<SPL>`` (before the
chain); an older source has no ``MAC = true`` one, which is reported
missing::

    PYTHONPATH=src python -m repro_torch.kernels.sass_diff old.cu [--all]

Prints each build's seconds, then per instantiation both instruction
counts, the instructions that differ (branch targets aside, which only
move when code after them changes length), ptxas's registers and stack
frame, and the local-memory instructions (``LDL``/``STL``) in all and
inside the step loop (the longest backward branch's span), the other
source's beside this one's.  Exits 1 when a ``D = 0``, ``MAC = false``
instantiation differs (every instantiation with ``--all``).
"""
from __future__ import annotations

import concurrent.futures
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


def sass(src: Path, out_dir: Path) -> dict:
    """``{function name: {"ins": [instruction, ...], "addr": [offset,
    ...], "regs": n, "stack": bytes}}`` of ``src`` built into
    ``out_dir``, one cubin per unit of a split source."""
    flags = [f for f in _build.nvcc_flags("cell_scan")
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    units = {u: t for u, t in _build.unit_sources(src).items()
             if u != "entry"} or {"all": None}
    t0 = time.time()
    procs = []
    for u, text in units.items():
        cu = src
        if text is not None:
            cu = out_dir / f"{u}.cu"
            cu.write_text(text)
        cubin = out_dir / f"{u}.cubin"
        procs.append((cubin, subprocess.Popen(
            [str(CUDA_BIN / "nvcc"), *flags, f"-I{_build.CSRC}", "-cubin",
             "-o", str(cubin), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    funcs, usage = {}, {}
    for cubin, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -cubin of {src} failed:\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"(?:Function properties for|entry function) '?"
                          r"([\w.]+)", line)
            if m:
                fn = m.group(1)
                usage.setdefault(fn, {})
            m = re.search(r"(\d+) bytes stack frame", line)
            if fn and m:
                usage[fn]["stack"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if fn and m:
                usage[fn]["regs"] = int(m.group(1))
        text = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass",
                               str(cubin)], check=True, capture_output=True,
                              text=True).stdout
        cur = None
        for line in text.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                cur = funcs.setdefault(m.group(1), dict(
                    ins=[], addr=[], **usage.get(m.group(1), {})))
                continue
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if cur is not None and m:
                cur["addr"].append(int(m.group(1), 16))
                cur["ins"].append(m.group(2).strip())
    print(f"built {src} in {time.time() - t0:.1f} s ({len(units)} "
          f"unit{'s' if len(units) > 1 else ''})")
    return funcs


def _no_target(ins: str) -> str:
    return re.sub(r"0x[0-9a-f]+", "TARGET", ins) if "BRA" in ins else ins


def local_memory(f: dict) -> tuple:
    """``(LDL/STL instructions in all, inside the step loop)``: the loop
    is the span of the longest backward branch (the step loop encloses
    every other loop of the step)."""
    lo = hi = -1
    for a, ins in zip(f["addr"], f["ins"]):
        m = re.search(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < a and a - int(m.group(1), 16) > hi - lo:
            lo, hi = int(m.group(1), 16), a
    loc = [a for a, ins in zip(f["addr"], f["ins"])
           if re.search(r"\b(LDL|STL)\b", ins)]
    return len(loc), sum(lo <= a <= hi for a in loc)


def _find(funcs: dict, names) -> dict | None:
    """The first function whose mangled name holds one of ``names``."""
    for name in names:
        for k, v in funcs.items():
            if f"cell_scan_kernel{name}" in k:
                return v
    return None


def _names(spl: int, d: int, fab: int, ep: int, mac: int) -> list:
    """The mangled template arguments of ``<spl, d, fab, ep, mac>``,
    newest first."""
    names = [f"ILi{spl}ELi{d}ELb{fab}ELb{ep}ELb{mac}EE"]
    if mac:
        return names
    names.append(f"ILi{spl}ELi{d}ELb{fab}ELb{ep}EE")
    if not ep:
        names.append(f"ILi{spl}ELi{d}ELb{fab}EE")
        if not fab:
            names.append(f"ILi{spl}ELi{d}EE")
            if d == 0:
                names.append(f"ILi{spl}EE")
    return names


def _usage(f: dict) -> str:
    n, loop = local_memory(f)
    return (f"{f.get('regs')} registers, {f.get('stack')} B stack, "
            f"LDL/STL {n} ({loop} in the step loop)")


def main(other: str, strict_all: bool = False) -> int:
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(2) as ex:
        (Path(tmp) / "other").mkdir()
        (Path(tmp) / "this").mkdir()
        old, new = ex.map(lambda a: sass(*a), (
            (Path(other), Path(tmp) / "other"),
            (_build.CSRC / "cell_scan.cu", Path(tmp) / "this")))
    same = True
    combos = [(spl, d, fab, ep, mac) for mac in (0, 1) for spl in (1, 2, 4)
              for d in range(MAX_DEEP + 1) for fab in ((0, 1) if d else (0,))
              for ep in (0, 1)]
    for spl, d, fab, ep, mac in combos:
        names = _names(spl, d, fab, ep, mac)
        o = _find(old, names)
        n = _find(new, names[:1])
        what = (f"cell_scan_kernel SPL={spl} D={d} FAB={bool(fab)} "
                f"EP={bool(ep)} MAC={bool(mac)}")
        must = strict_all or (d == 0 and not mac)
        if o is None or n is None:
            print(f"{what}: missing (other {o is not None}, this "
                  f"{n is not None})")
            same &= not must
            continue
        ops = difflib.SequenceMatcher(
            a=[_no_target(x) for x in o["ins"]],
            b=[_no_target(x) for x in n["ins"]], autojunk=False).get_opcodes()
        diff = [op for op in ops if op[0] != "equal"]
        ident = not diff and len(o["ins"]) == len(n["ins"])
        same &= ident or not must
        print(f"{what}: other {len(o['ins'])} instructions, this "
              f"{len(n['ins'])}, differing runs {len(diff)}"
              + ("; identical" if ident else "")
              + f"; other {_usage(o)}; this {_usage(n)}")
        if must:
            for tag, i1, i2, j1, j2 in diff[:4]:
                print(f"  {tag}: {o['ins'][i1:i2][:4]} -> "
                      f"{n['ins'][j1:j2][:4]}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], "--all" in sys.argv[2:]))
