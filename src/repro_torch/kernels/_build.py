"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout,
at first use; ``<hash>`` covers the source, every header in ``csrc/``
and the flags, so an edited source rebuilds and an unchanged one loads
as it is.  :func:`build_all` starts one ``nvcc`` per source at once.
The sources have a plain C interface (no PyTorch headers), which keeps
a build to seconds; pointers and the stream cross as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
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
           "flash_attention_tc", "ssd_scan", "ssd_scan_tc")
# Libraries built from another library's source with extra flags:
# name -> (source, flags).  ``cell_scan_profile`` is the cell scan with
# its section profile compiled in (chip_smoke.py's trace of a step).
VARIANTS = {"cell_scan_profile": ("cell_scan", ("-DCELL_SCAN_PROFILE",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# -fmad=false: the reference's f64 arithmetic is separate adds, maxes and
# products in a fixed order; FMA contraction would change the last bit.
# The attention and SSD kernels are held to a tolerance and keep FMAs.
EXACT_SOURCES = ("tat_lookup", "cell_scan", "smem_probe")


def _source(name: str) -> Tuple[str, Tuple[str, ...]]:
    return VARIANTS.get(name, (name, ()))


def nvcc_flags(name: str) -> Tuple[str, ...]:
    src, extra = _source(name)
    return NVCC_FLAGS + (("-fmad=false",) if src in EXACT_SOURCES else ()) \
        + extra


_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{_source(name)[0]}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            [nvcc, *nvcc_flags(name), "-o", str(tmp),
             str(CSRC / f"{_source(name)[0]}.cu")],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


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
