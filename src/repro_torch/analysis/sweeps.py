"""Pass 5 (satellite): sweep-telemetry registry vs. emitted keys (torch
port of ``repro.analysis.sweeps``).

A benchmark directory's ``_sweeps.py`` is the single source of truth
for the sweep base names; a compile-count check derives its guarded
keys from it.  What nothing else pins is the *emission* side: a figure
script that records ``newthing_sweep_compiles`` without registering the
sweep would sail through that check unguarded, and a registered sweep
whose figure script was retired would fail the bench lane only after a
full run.  This pass AST-parses both sides and diffs them:

  * ``sweep-unregistered`` — a ``sweep_metrics.update(...)`` site emits
    a base name missing from the registry;
  * ``sweep-stale`` — the registry names a sweep no script emits;
  * ``sweep-missing-key`` — a sweep emits only some of the five
    required suffixes (wall_s / compile_s / compiles / cells /
    macro_hit).

``_shared.py`` is the one special case: it records ``grid_*`` into
``grid_metrics`` and the runner re-prefixes those to ``shared_grid_*``,
so ``grid_metrics.update`` sites count as the ``shared_grid`` sweep.

The port has no benchmark scripts yet, so ``bench_dir`` is a required
argument and the pass is not in ``repro_torch.analysis.PASSES``: the
port's benchmark registers it.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.common import Finding, rel

_REGISTRY = "_sweeps.py"
_SUFFIXES = ("wall_s", "compile_s", "compiles", "cells", "macro_hit")


def _registered(bench_dir: Path) -> Tuple[Dict[str, int], int]:
    """SWEEPS entries of the registry module -> line, plus the tuple's
    own line for stale-anchor fallback."""
    path = bench_dir / _REGISTRY
    tree = ast.parse(path.read_text())
    out: Dict[str, int] = {}
    reg_line = 1
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if not any(isinstance(t, ast.Name) and t.id == "SWEEPS"
                   for t in targets):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            reg_line = node.lineno
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value,
                                                              str):
                    out[e.value] = e.lineno
    return out, reg_line


def _emitted(bench_dir: Path
             ) -> Dict[str, Tuple[str, int, Set[str]]]:
    """base -> (file, line, suffixes emitted) over all update sites."""
    out: Dict[str, Tuple[str, int, Set[str]]] = {}
    for path in sorted(bench_dir.glob("*.py")):
        if path.name == _REGISTRY:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update"
                    and isinstance(node.func.value, ast.Name)):
                continue
            recv = node.func.value.id
            if recv not in ("sweep_metrics", "grid_metrics"):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                for suffix in _SUFFIXES:
                    if not kw.arg.endswith(f"_{suffix}"):
                        continue
                    base = kw.arg[:-len(suffix) - 1]
                    if recv == "grid_metrics":
                        # run.py re-prefixes grid_metrics keys with
                        # "shared_" before they reach the report
                        base = f"shared_{base}"
                    file, line, seen = out.get(
                        base, (rel(path), node.lineno, set()))
                    seen.add(suffix)
                    out[base] = (file, line, seen)
                    break
    return out


def check(bench_dir: Path) -> List[Finding]:
    """Diff the sweep registry of ``bench_dir`` against the telemetry
    its figure scripts emit."""
    bench_dir = Path(bench_dir)
    registered, reg_line = _registered(bench_dir)
    emitted = _emitted(bench_dir)
    reg_file = rel(bench_dir / _REGISTRY)
    findings: List[Finding] = []
    for base, (file, line, seen) in sorted(emitted.items()):
        if base not in registered:
            findings.append(Finding(
                file=file, line=line, rule="sweep-unregistered",
                message=f"sweep {base!r} emits telemetry but is not in "
                        f"the {_REGISTRY} SWEEPS registry, so "
                        "check_compiles never guards its compile count",
                suggestion=f"add {base!r} to SWEEPS in "
                           f"{reg_file}"))
            continue
        missing = [s for s in _SUFFIXES if s not in seen]
        if missing:
            findings.append(Finding(
                file=file, line=line, rule="sweep-missing-key",
                message=f"sweep {base!r} never emits required key(s) "
                        f"{', '.join(f'{base}_{s}' for s in missing)}",
                suggestion="record the missing telemetry in the sweep's "
                           "sweep_metrics.update(...) call"))
    for base, line in sorted(registered.items()):
        if base not in emitted:
            findings.append(Finding(
                file=reg_file, line=line or reg_line, rule="sweep-stale",
                message=f"registered sweep {base!r} has no "
                        "sweep_metrics.update emission site in "
                        f"{rel(bench_dir)}/",
                suggestion="remove the stale registry entry or restore "
                           "the sweep's telemetry"))
    return findings
