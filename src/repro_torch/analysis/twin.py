"""Pass 3: oracle-twin contract checker (engine <-> semantics parity;
torch port of ``repro.analysis.twin``).

The paper's correctness argument rests on the timed engine and the
untimed oracle (``core.semantics``) consuming the *same* policy and
producing *matching* statistics (the crash differential pins the
values; this pass pins the contracts statically):

  * every ``DrainPolicy`` / ``AllocPolicy`` / ``Schedule`` field must be
    consumed on BOTH sides — an engine-only field silently no-ops in the
    oracle (the differential then "passes" without testing it), an
    oracle-only field silently no-ops in the engine;
  * every ``S_*`` stats column must map to its oracle ``stats`` twin
    (the S_TWINS registry) or carry an explicit exemption with a
    reason, and vice versa for the oracle's keys;
  * every ``SimResult`` field must be consumed somewhere outside its
    defining module — a result field nobody reads is a contract nobody
    checks.  The corpus is the port's: ``src/repro_torch``, the port's
    tests and their helpers (``tests/test_torch_*.py``,
    ``tests/_torch_*.py``) and ``chip_smoke.py``.

Field consumption is attribute-based and *transitive through
``core.params``*: the engine consumes ``DrainPolicy.threshold`` via
``tenant_drain_counts`` (a params helper called from the lowering), so
params functions reachable from each side's sources count toward that
side.  The registries are the reference's, unchanged.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import (Finding, attribute_names,
                                         find_line, read_source, rel,
                                         REPO_ROOT)

_SRC = REPO_ROOT / "src"
_PKG = _SRC / "repro_torch"
_ENGINE_DIR = _PKG / "core" / "engine"
_SEMANTICS = _PKG / "core" / "semantics.py"
_PARAMS = _PKG / "core" / "params.py"
_STATE = _ENGINE_DIR / "state.py"

# S_* column -> the oracle stats key(s) it must agree with.  A column
# maps to several keys when the oracle splits it (S_READ_CNT is the
# oracle's hits + misses).
S_TWINS: Dict[str, Tuple[str, ...]] = {
    "S_PERSIST_CNT": ("persists",),
    "S_COALESCES": ("coalesces",),
    "S_READ_HITS": ("read_hits",),
    "S_READ_CNT": ("read_hits", "read_misses"),
    "S_PM_WRITES": ("pm_writes",),
    "S_STALL_TIME": ("stalls",),
    "S_SLO_OVER": ("slo_over",),
    "S_ACKED": ("acks",),
}

# Timing-only / engine-only columns with no meaningful untimed twin.
S_EXEMPT: Dict[str, str] = {
    "S_PERSIST_SUM": "latency sum; the untimed oracle has no clock",
    "S_READ_SUM": "latency sum; the untimed oracle has no clock",
    "S_PBCQ_SUM": "PBC queueing wait; timing-only",
    "S_LAT_HIST0": "latency histogram base; timing-only (mass is pinned "
                   "to S_PERSIST_CNT by the differential)",
    "S_DRAM_READS": "volatile traffic never reaches the switch/oracle",
    "S_PI_DETOURS": "PI-buffer routing artifact of the timed path",
    "S_VICTIM_CNT": "oracle twin is its STALLED event count "
                    "(victim_drains in the differential driver)",
    "S_DURABLE": "oracle twin is snapshot_durable(), not a counter",
}

# Oracle stats keys that deliberately have no S_* column.
ORACLE_EXEMPT: Dict[str, str] = {
    "drains": "hop-1 drain emissions; the engine's S_PM_WRITES counts "
              "device arrivals instead (deep hops retain/coalesce)",
}

# SimResult fields that only exist as constructor plumbing.
SIMRESULT_EXEMPT: Dict[str, str] = {}


def _parse(paths: Sequence[Path]) -> List[ast.Module]:
    return [ast.parse(Path(p).read_text()) for p in paths]


def _params_defs() -> Dict[str, ast.AST]:
    """Top-level functions AND methods of core.params by bare name."""
    tree = ast.parse(_PARAMS.read_text())
    defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _called_names(trees: Sequence[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for tree in trees:
        for n in ast.walk(tree):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
    return out


def side_attribute_names(paths: Sequence[Path]) -> Set[str]:
    """Attribute names consumed by one side, expanded transitively
    through the ``core.params`` helpers the side reaches."""
    trees = _parse(paths)
    defs = _params_defs()
    included: List[ast.AST] = []
    frontier = _called_names(trees)
    seen: Set[str] = set()
    while True:
        new = [n for n in frontier if n in defs and n not in seen]
        if not new:
            break
        for n in new:
            seen.add(n)
            included.append(defs[n])
        frontier = _called_names([defs[n] for n in new])
    return attribute_names(trees + included)


def engine_sources() -> List[Path]:
    """The timed engine's side: every module of ``core/engine``."""
    return sorted(_ENGINE_DIR.glob("*.py"))


def oracle_sources() -> List[Path]:
    """The untimed oracle's side."""
    return [_SEMANTICS]


def policy_fields() -> Dict[str, Tuple[str, int]]:
    """``Class.field`` -> (file, line) of every policy field both sides
    must consume.  ``Schedule`` rides with the policies: both sides must
    consume its boundary vector (engine: the epoch_bounds lowering via
    ``PCSConfig.epoch_boundaries``; oracle: ``epoch_at``) AND its values
    (both through ``params.resolve_epoch`` / ``epoch_value``)."""
    import dataclasses

    from repro_torch.core import params

    _, lines = read_source(_PARAMS)
    fields = {}
    for cls in (params.DrainPolicy, params.AllocPolicy, params.Schedule):
        for f in dataclasses.fields(cls):
            line = find_line(lines, rf"^\s*{f.name}\s*[:=]") or 1
            fields[f"{cls.__name__}.{f.name}"] = (rel(_PARAMS), line)
    return fields


def check_policy_fields(
        engine_paths: Optional[Sequence[Path]] = None,
        oracle_paths: Optional[Sequence[Path]] = None,
        fields: Optional[Dict[str, Tuple[str, int]]] = None
        ) -> List[Finding]:
    """Every policy field must be an attribute access on both sides."""
    if engine_paths is None:
        engine_paths = engine_sources()
    if oracle_paths is None:
        oracle_paths = oracle_sources()
    if fields is None:
        fields = policy_fields()

    engine_attrs = side_attribute_names(engine_paths)
    oracle_attrs = side_attribute_names(oracle_paths)
    findings = []
    for qual, (file, line) in fields.items():
        name = qual.split(".")[-1]
        if name not in engine_attrs:
            findings.append(Finding(
                file=file, line=line, rule="twin-policy-engine",
                message=f"policy field {qual} is never consumed by the "
                        "timed engine (engine/ + reachable params "
                        "helpers)",
                suggestion="lower and consume the field in the engine, "
                           "or remove it"))
        if name not in oracle_attrs:
            findings.append(Finding(
                file=file, line=line, rule="twin-policy-oracle",
                message=f"policy field {qual} is never consumed by the "
                        "untimed oracle (semantics.py + reachable "
                        "params helpers)",
                suggestion="implement the field in "
                           "semantics.PersistentBuffer, or remove it"))
    return findings


def engine_stat_columns() -> Dict[str, int]:
    """S_* constants defined in engine/state.py -> line."""
    _, lines = read_source(_STATE)
    out = {}
    for i, raw in enumerate(lines):
        m = re.match(r"^(S_[A-Z0-9_]+)\s*=", raw)
        if m:
            out[m.group(1)] = i + 1
    return out


def oracle_stat_keys() -> Dict[str, int]:
    """Keys of the oracle's ``self.stats`` dict literal -> line."""
    tree = ast.parse(_SEMANTICS.read_text())
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Attribute) and t.attr == "stats"
                   for t in node.targets):
            continue
        if isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    out[k.value] = k.lineno
    return out


def check_stat_twins() -> List[Finding]:
    findings: List[Finding] = []
    columns = engine_stat_columns()
    oracle = oracle_stat_keys()
    state_file = rel(_STATE)
    sem_file = rel(_SEMANTICS)
    for col, line in columns.items():
        if col in S_TWINS:
            for key in S_TWINS[col]:
                if key not in oracle:
                    findings.append(Finding(
                        file=state_file, line=line,
                        rule="twin-stat-missing-oracle",
                        message=f"{col} maps to oracle stats key "
                                f"{key!r}, which semantics.py does not "
                                "define",
                        suggestion="add the key to the oracle stats "
                                   "dict or fix S_TWINS"))
        elif col not in S_EXEMPT:
            findings.append(Finding(
                file=state_file, line=line, rule="twin-stat-unmapped",
                message=f"stats column {col} has no oracle twin in "
                        "S_TWINS and no exemption in S_EXEMPT",
                suggestion="map it to an oracle stats key or exempt it "
                           "with a reason in repro_torch.analysis.twin"))
    mapped = {k for keys in S_TWINS.values() for k in keys}
    for key, line in oracle.items():
        if key not in mapped and key not in ORACLE_EXEMPT:
            findings.append(Finding(
                file=sem_file, line=line,
                rule="twin-oracle-stat-unmapped",
                message=f"oracle stats key {key!r} has no S_* twin in "
                        "S_TWINS and no exemption in ORACLE_EXEMPT",
                suggestion="map an engine column to it or exempt it "
                           "with a reason in repro_torch.analysis.twin"))
    return findings


def simresult_corpus() -> List[Path]:
    """The port's sources, its tests and test helpers and its chip
    smoke, without engine/state.py and without any path that has an
    ``analysis`` component (the analysis and its fixtures)."""
    tests = REPO_ROOT / "tests"
    corpus = (list(_PKG.rglob("*.py")) + sorted(tests.glob("test_torch_*.py"))
              + sorted(tests.glob("_torch_*.py"))
              + [REPO_ROOT / "chip_smoke.py"])
    return [p for p in corpus if p != _STATE and p.exists()
            and "analysis" not in p.relative_to(REPO_ROOT).parts]


def check_simresult_consumed() -> List[Finding]:
    """Every SimResult field must occur outside its defining module."""
    import dataclasses

    from repro_torch.core.engine.state import SimResult

    text = "\n".join(p.read_text() for p in simresult_corpus())
    _, state_lines = read_source(_STATE)
    findings = []
    for f in dataclasses.fields(SimResult):
        if f.name in SIMRESULT_EXEMPT:
            continue
        if not re.search(rf"\b{f.name}\b", text):
            line = find_line(state_lines, rf"^\s*{f.name}\s*[:=]") or 1
            findings.append(Finding(
                file=rel(_STATE), line=line,
                rule="twin-simresult-unconsumed",
                message=f"SimResult.{f.name} is never referenced "
                        "outside engine/state.py",
                suggestion="consume it in a test or the chip smoke, or "
                           "drop the field"))
    return findings


def check() -> List[Finding]:
    return (check_policy_fields() + check_stat_twins()
            + check_simresult_consumed())
