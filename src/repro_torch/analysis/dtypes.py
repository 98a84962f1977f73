"""Pass 4: dtype-packing lint over the engine's carry and its ops (torch
port of ``repro.analysis.dtypes``).

The carry is deliberately packed (``MachineState``'s docstring):
categorical columns in int8, barrier counts in int16, time columns
pinned to float64.  Two silent regressions this pass catches:

  * **packed-column widening** — an init or handler change that
    promotes ``state``/``owner``/... to int32 quietly triples the carry
    (the packing registry below is the contract; the check runs a full
    exemplar cell so a widened column is caught wherever it happens);
  * **float64 -> float32 demotion on a time path** — the engine
    subtracts ns-scale quantities from ~1e9-scale clocks; any aten op
    that takes an f64 tensor and returns an f32 one (``_to_copy``
    among them) quantizes at ~100 ns and breaks the bit-exact
    differentials.  The exemplar runs under every scheme inside a
    :class:`~torch.utils._python_dispatch.TorchDispatchMode` that
    reports each such op at its innermost frame in the code under
    analysis (the widening of the f32 *input* gaps is f32 -> f64 and
    does not match).

The reference's third check, that the jitted grid donates its staged
buffers, has no counterpart: PyTorch has no buffer donation, the port's
grid stages fresh tensors and the kernel writes into the outputs its
wrapper allocates.
"""
from __future__ import annotations

import inspect
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.common import (Finding, find_line, read_source, rel,
                                         REPO_ROOT)

_PKG = REPO_ROOT / "src" / "repro_torch"
_STATE = _PKG / "core" / "engine" / "state.py"

# The packing contract: MachineState column -> dtype it must keep
# through a full cell run.  Mirrors the docstring of
# engine.state.MachineState — this registry is the machine-checked
# form.
EXPECTED_DTYPES: Dict[str, str] = {
    "clock": "float64", "ptr": "int32",
    "tag": "int32", "state": "int8", "lru": "float64", "dd": "float64",
    "ver": "int32", "owner": "int8",
    "aver": "int32", "pm_ver": "int32",
    "pm_busy": "float64", "pbc_busy": "float64",
    "blocked": "bool", "bcount": "int16",
    "stats": "float64",
    "dtag": "int32", "dstate": "int8", "dlru": "float64",
    "ddd": "float64", "dver": "int32", "downer": "int8",
    "dwt": "float64", "hpbc": "float64", "hop_stats": "float64",
    "lpbc": "float64",
}


def check_packing(shapes: Optional[Dict[str, Tuple[str, tuple]]] = None,
                  expected: Optional[Dict[str, str]] = None,
                  anchor_file: Optional[Path] = None) -> List[Finding]:
    """Diff actual carry dtypes against the packing registry."""
    if shapes is None:
        from repro_torch.analysis._engine import final_state_shapes
        shapes = final_state_shapes()
    expected = EXPECTED_DTYPES if expected is None else expected
    anchor_file = _STATE if anchor_file is None else anchor_file
    _, lines = read_source(anchor_file)
    findings = []
    for col, want in expected.items():
        got = shapes.get(col)
        line = find_line(lines, rf"^\s*{col}\s*[:=]") or 1
        if got is None:
            findings.append(Finding(
                file=rel(anchor_file), line=line, rule="dtype-packing",
                message=f"carry column {col!r} is registered but absent "
                        "from the traced state",
                suggestion="update EXPECTED_DTYPES in "
                           "repro_torch.analysis.dtypes"))
            continue
        if got[0] != want:
            findings.append(Finding(
                file=rel(anchor_file), line=line, rule="dtype-packing",
                message=f"carry column {col!r} is {got[0]} after a full "
                        f"cell run; the packing contract pins {want}",
                suggestion="keep literal compares/selects weakly typed "
                           "so the packed dtype survives the handlers"))
    for col in sorted(set(shapes) - set(expected)):
        line = find_line(lines, rf"^\s*{col}\s*[:=]") or 1
        findings.append(Finding(
            file=rel(anchor_file), line=line, rule="dtype-packing",
            message=f"carry column {col!r} is not in the packing "
                    "registry",
            suggestion="register its dtype in EXPECTED_DTYPES "
                       "(repro_torch.analysis.dtypes)"))
    return findings


def _dtypes_in(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        out.add(obj.dtype)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _dtypes_in(x, out)
    elif isinstance(obj, dict):
        _dtypes_in(list(obj.values()), out)
    return out


class _Demotions(TorchDispatchMode):
    """Records, per aten op that takes an f64 tensor and returns an f32
    one, the innermost frame whose file lies under ``roots``."""

    def __init__(self, roots: Sequence[Path], skip: Path):
        super().__init__()
        self.roots = [str(r) for r in roots]
        self.skip = str(skip)
        self.hits: List[Tuple[str, Tuple[str, int]]] = []

    def _where(self) -> Tuple[str, int]:
        f = sys._getframe(1)
        while f is not None:
            name = os.path.abspath(f.f_code.co_filename)
            if (any(name.startswith(r) for r in self.roots)
                    and not name.startswith(self.skip)):
                return rel(name), f.f_lineno
            f = f.f_back
        return "<traced>", 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (torch.float64 in _dtypes_in((args, kwargs), set())
                and torch.float32 in _dtypes_in(out, set())):
            self.hits.append((str(func), self._where()))
        return out


def check_f32_leaks(fn=None, args: tuple = ()) -> List[Finding]:
    """Any f64 -> f32 aten op is a time-column leak: one finding per
    source location.  Default: the exemplar under every scheme; else
    ``fn(*args)``, located in ``fn``'s own file as well."""
    roots = [_PKG]
    if fn is None:
        from repro_torch.analysis import _engine
        _, _, sc = _engine.example_inputs()
        fn, args = _engine.every_scheme, (sc,)
    else:
        roots.append(Path(inspect.getsourcefile(fn)).resolve())
    mode = _Demotions(roots, skip=Path(__file__).resolve().parent)
    with mode:
        fn(*args)
    findings, seen = [], set()
    for op, (file, line) in mode.hits:
        if (file, line) in seen:
            continue
        seen.add((file, line))
        findings.append(Finding(
            file=file, line=line, rule="dtype-f32-leak",
            message=f"float64 value demoted to float32 ({op}) in the "
                    "step: time columns quantize at ~100 ns at clock "
                    "scale",
            suggestion="keep time arithmetic in f64 (widen the f32 "
                       "operand instead)"))
    return findings


def check() -> List[Finding]:
    return check_packing() + check_f32_leaks()
