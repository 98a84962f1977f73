"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout,
at first use; ``<hash>`` covers the source, every header in ``csrc/``
and the flags, so an edited source rebuilds and an unchanged one loads
as it is.  A source that lists units (``csrc/cell_scan.cu``'s
``CELL_SCAN_UNITS``: one per (SPL, D, MAC) of its kernel, and the
entry point) is split: each unit is a small generated ``.cu`` that defines the
unit's macros and includes the source, compiled to an object by its own
``nvcc``, and the objects are linked into the library.  :func:`build_all`
starts every ``nvcc`` at once.  The sources have a plain C interface (no
PyTorch headers), which keeps a build to seconds; pointers and the
stream cross as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# The package's kernels.  ``csrc/smem_probe.cu`` (a latency probe for
# chip_smoke.py's bound, not a kernel of the port) and the VARIANTS are
# built only when asked for by name.
SOURCES = ("tat_lookup", "cell_scan", "flash_attention",
           "flash_attention_tc", "flash_attention_ws", "ssd_scan",
           "ssd_scan_tc")
# Libraries built from another library's source with extra flags:
# name -> (source, flags, units).  ``units``: the (SPL, D, MAC) units of a
# split source the library keeps (None: all of them); its source is then
# the package's with the units' list cut to those, written beside the
# library.  ``cell_scan_profile`` is the cell scan with its section
# profile compiled in (chip_smoke.py's trace of a step), at SPL 1, the
# only cells it profiles.
VARIANTS = {"cell_scan_profile": ("cell_scan", ("-DCELL_SCAN_PROFILE",),
                                  tuple((1, d, m) for m in (0, 1)
                                        for d in range(4)))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# -fmad=false: the reference's f64 arithmetic is separate adds, maxes and
# products in a fixed order; FMA contraction would change the last bit.
# The attention and SSD kernels are held to a tolerance and keep FMAs.
EXACT_SOURCES = ("tat_lookup", "cell_scan", "smem_probe")


def _source(name: str) -> Tuple[str, Tuple[str, ...]]:
    return VARIANTS.get(name, (name, (), None))[:2]


_UNITS_RE = r"(#define CELL_SCAN_UNITS\(X\))((?:[^\n]*\\\n)*[^\n]*)"


def source_text(name: str) -> str:
    """The text library ``name`` builds from: its source's, the units'
    list cut to the variant's units where it names them."""
    src, _, units = VARIANTS.get(name, (name, (), None))
    text = (CSRC / f"{src}.cu").read_text()
    if units is None:
        return text
    body = " ".join(f"X({s}, {d}, {m})" for s, d, m in units)
    out, n = re.subn(_UNITS_RE, lambda m: f"{m.group(1)} {body}", text)
    if n != 1:
        raise ValueError(f"{src}.cu: no units' list to cut for {name}")
    return out


def nvcc_flags(name: str) -> Tuple[str, ...]:
    src, extra = _source(name)
    return NVCC_FLAGS + (("-fmad=false",) if src in EXACT_SOURCES else ()) \
        + extra


def unit_sources(path: Path) -> Dict[str, str]:
    """The split build's units of the source at ``path``: ``{unit name:
    generated source}``, one ``s<SPL>_d<D>_m<MAC>`` per ``X(SPL, D,
    MAC)`` of its ``CELL_SCAN_UNITS`` list (``s<SPL>_d<D>`` per ``X(SPL,
    D)`` of a source from before the MAC axis) and ``entry``; empty for a
    source without the list, which builds as one unit."""
    text = Path(path).read_text()
    m = re.search(_UNITS_RE, text)
    if not m:
        return {}
    inc = f'#include "{Path(path).resolve()}"\n'
    units = {}
    for s, d, mac in re.findall(r"X\((\d+),\s*(\d+)(?:,\s*(\d+))?\)",
                                m.group(2)):
        name = f"s{s}_d{d}" + (f"_m{mac}" if mac else "")
        units[name] = (f"#define CELL_SCAN_UNIT_SPL {s}\n"
                       f"#define CELL_SCAN_UNIT_D {d}\n"
                       + (f"#define CELL_SCAN_UNIT_MAC {mac}\n" if mac
                          else "") + inc)
    units["entry"] = "#define CELL_SCAN_UNIT_ENTRY\n" + inc
    return units


_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(f"{_source(name)[0]}.cu".encode())
    h.update(source_text(name).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _source_path(name: str) -> Path:
    """The source file library ``name`` builds from: the package's, or a
    variant's cut text written beside the library."""
    src, _, units = VARIANTS.get(name, (name, (), None))
    if units is None:
        return CSRC / f"{src}.cu"
    path = _lib_path(name).with_suffix(".cu")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source_text(name))
    return path


def build_libs(jobs: Sequence[Tuple[Path, Path, Sequence[str]]]) -> None:
    """Build library ``out`` from source ``src`` with ``flags`` for each
    ``(out, src, flags)``: every ``nvcc`` (one per source, or one per
    unit of a split source) starts at once, then the split libraries are
    linked.  Each library's ``nvcc`` output goes to ``out`` with the
    suffix ``.log``; ``-I csrc`` finds the package's headers."""
    nvcc = _nvcc()
    procs, links = [], []
    for out, src, flags in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        units = unit_sources(src)
        if not units:
            procs.append((out, [out.with_suffix(".log")], subprocess.Popen(
                [nvcc, *flags, f"-I{CSRC}", "-o", str(tmp), str(src)],
                stdout=open(out.with_suffix(".log"), "w"),
                stderr=subprocess.STDOUT)))
            links.append((out, tmp, None))
            continue
        udir = out.with_suffix(".units")
        udir.mkdir(exist_ok=True)
        cflags = [f for f in flags if f != "-shared"]
        objs, logs = [], []
        for u, text in units.items():
            cu = udir / f"{u}.cu"
            cu.write_text(text)
            obj, log = udir / f"{u}.o", udir / f"{u}.log"
            objs.append(obj)
            logs.append(log)
            procs.append((out, [log], subprocess.Popen(
                [nvcc, *cflags, f"-I{CSRC}", "-c", "-o", str(obj), str(cu)],
                stdout=open(log, "w"), stderr=subprocess.STDOUT)))
        links.append((out, tmp, (objs, logs)))
    failed = set()
    for out, logs, proc in procs:
        if proc.wait() != 0:
            failed.add(out)
    errors = []
    for out, tmp, split in links:
        if split is not None and out not in failed:
            objs, logs = split
            rc = subprocess.run(
                [nvcc, *[f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")],
                 "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            with open(out.with_suffix(".log"), "w") as f:
                for log in logs:
                    f.write(log.read_text())
                f.write(rc.stdout + rc.stderr)
            if rc.returncode != 0:
                failed.add(out)
        if out in failed:
            errors.append(f"{out.name}:\n" + out.with_suffix(".log")
                          .read_text()[-20000:])
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every missing library, all ``nvcc`` processes at once."""
    build_libs([(_lib_path(n), _source_path(n), nvcc_flags(n))
                for n in names if not _lib_path(n).exists()])


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if any input requires grad: the kernels have no backward, so
    their outputs would carry no ``grad_fn``.  ``None`` inputs pass."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad, and the "
                           f"kernel has no backward; attend or scan with "
                           f"the model's own differentiable math instead")
