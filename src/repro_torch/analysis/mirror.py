"""Pass 2: AST mirror-site lint over the engine's replicated expressions
(torch port of ``repro.analysis.mirror``).

The engine computes several load-bearing expressions at more than one
site — the slot-at-a-time persist handler, the NoPB handler and the
macro-step's replay must stay *bit-exact* twins (the crash differential
and the macro on/off diff depend on it), and the replay's guard
replicates sub-expressions of ``policy.drain_threshold_preset``.  A
one-character skew at any site silently breaks bit-exactness in ways
only the expensive differential suites catch.

Sites register with a ``# lint: mirror(<group>)`` comment on (or right
above) the statement.  All sites of a group are alpha-renamed
(``common.normalize_stmt``) and diffed pairwise: local names collapse
to positional placeholders, so ``st.stats[...]`` in the handler and
``stats_cur[...]`` in the replay compare structurally.  The registry
below pins the expected site count per group — deleting a marked site
(or its marker) is itself a finding.  The port's groups and counts are
the reference's: where the port's sites had another shape (the replay's
per-column stats adds, its ``_f64`` in the keep-one-free count, the
histogram column inside the handlers' column lists) they were written
as one statement of the handlers' shape.

The second check is column coverage: every ``S_*`` stats column
referenced by one handler family must be referenced by the others or
explicitly exempted with ``# lint: exempt(stats-columns, S_X ...):
reason`` inside one of the family's functions.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.common import (Finding, module_preserved_names,
                                         normalize_stmt, parse_exemptions,
                                         parse_markers, read_source, rel,
                                         statements_by_line, function_spans,
                                         names_used, REPO_ROOT)

_ENGINE = REPO_ROOT / "src" / "repro_torch" / "core" / "engine"

# group -> expected site count across the engine sources.  The counts
# are part of the contract: N sites must exist AND normalize equal.
MIRROR_GROUPS: Dict[str, int] = {
    "lat-bin": 3,        # buffered / NoPB / macro histogram column
    "slo-over": 4,       # over-target predicate (buffered, NoPB, macro x2)
    "slo-cnt": 2,        # running persist count incl. this persist
    "slo-run": 2,        # running over-target count incl. this persist
    "slo-tight": 2,      # tightening predicate
    "rf-tight-thr": 2,   # tight threshold override (policy vs macro guard)
    "rf-tight-pre": 2,   # tight preset override
    "rf-do-drain": 2,    # threshold trigger (policy vs macro guard)
    "rf-k-thresh": 2,    # threshold/preset drain count
    "rf-k-low": 2,       # keep-one-free drain count
    "stats-scatter": 3,  # fused per-persist stats add
}

_MIRROR_FILES = ("handlers.py", "macro.py", "policy.py")

# Handler families for the column-coverage check: qualnames whose S_*
# references are pooled per family.  The port's scheme bodies are
# module-level functions (the reference's are closures of the
# handlers), and the macro window's ops run in ``macro.replay``.
FAMILIES: Dict[str, List[Tuple[str, str]]] = {
    "buffered": [("handlers.py", "_persist_with_buffer"),
                 ("handlers.py", "_read_via_pb")],
    "nopb": [("handlers.py", "_persist_direct"),
             ("handlers.py", "_read_direct")],
    "macro": [("macro.py", "replay")],
}


def check_mirrors(paths: Optional[Sequence[Path]] = None,
                  expected: Optional[Dict[str, int]] = None
                  ) -> List[Finding]:
    """Collect all marked sites and diff each group pairwise."""
    if paths is None:
        paths = [_ENGINE / f for f in _MIRROR_FILES]
        expected = MIRROR_GROUPS if expected is None else expected
    findings: List[Finding] = []
    # group -> [(file, line, normalized dump, raw source)]
    sites: Dict[str, List[Tuple[str, int, str, str]]] = {}
    for path in paths:
        text, lines = read_source(path)
        tree = ast.parse(text)
        preserved = module_preserved_names(tree)
        stmts = statements_by_line(tree)
        for marker in parse_markers(lines):
            stmt = stmts.get(marker.line)
            if stmt is None:
                findings.append(Finding(
                    file=rel(path), line=marker.line,
                    rule="mirror-dangling-marker",
                    message=(f"mirror({marker.group}) marker does not "
                             "attach to a statement"),
                    suggestion="put the marker on the statement's first "
                               "line or the line above it"))
                continue
            if expected is not None and marker.group not in expected:
                findings.append(Finding(
                    file=rel(path), line=marker.line,
                    rule="mirror-unknown-group",
                    message=(f"mirror group {marker.group!r} is not in "
                             "the MIRROR_GROUPS registry"),
                    suggestion="register the group with its expected "
                               "site count in repro_torch.analysis.mirror"))
                continue
            sites.setdefault(marker.group, []).append(
                (rel(path), marker.line,
                 normalize_stmt(stmt, preserved),
                 ast.unparse(stmt)))

    for group, count in (expected or {}).items():
        got = sites.get(group, [])
        if len(got) != count:
            file, line = (got[0][:2] if got
                          else (rel(paths[0]), 1))
            findings.append(Finding(
                file=file, line=line, rule="mirror-missing-site",
                message=(f"mirror group {group!r} has {len(got)} marked "
                         f"site(s); the registry requires {count}"),
                suggestion="mark the missing site(s) with "
                           f"`# lint: mirror({group})` or update the "
                           "registry"))
    for group, group_sites in sites.items():
        if len(group_sites) < 2:
            continue
        ref_file, ref_line, ref_norm, ref_src = group_sites[0]
        for file, line, norm, src in group_sites[1:]:
            if norm != ref_norm:
                findings.append(Finding(
                    file=file, line=line, rule="mirror-skew",
                    message=(f"mirror group {group!r} site diverges "
                             f"from {ref_file}:{ref_line}: "
                             f"`{src}` vs `{ref_src}`"),
                    suggestion="make the expression structurally "
                               "identical to the reference site"))
    return findings


def check_column_coverage(
        families: Optional[Dict[str, List[Tuple[str, str]]]] = None,
        base: Optional[Path] = None) -> List[Finding]:
    """Every S_* column one family references must be referenced (or
    exempted) by every other family."""
    families = FAMILIES if families is None else families
    base = _ENGINE if base is None else base
    findings: List[Finding] = []
    used: Dict[str, Dict[str, int]] = {}     # family -> {col: line}
    exempt: Dict[str, Dict[str, str]] = {}   # family -> {col: reason}
    anchor: Dict[str, Tuple[str, int]] = {}
    for family, funcs in families.items():
        used[family] = {}
        exempt[family] = {}
        for fname, qual in funcs:
            path = base / fname
            text, lines = read_source(path)
            tree = ast.parse(text)
            spans = function_spans(tree)
            if qual not in spans:
                findings.append(Finding(
                    file=rel(path), line=1, rule="mirror-missing-site",
                    message=f"column-coverage family {family!r} names "
                            f"unknown function {qual!r}",
                    suggestion="update FAMILIES in "
                               "repro_torch.analysis.mirror"))
                continue
            lo, hi = spans[qual]
            anchor.setdefault(family, (rel(path), lo))
            for node in ast.walk(tree):
                if (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                        and node.lineno == lo):
                    for col, line in names_used(
                            node, r"S_[A-Z0-9_]+").items():
                        used[family].setdefault(col, line)
            for ex in parse_exemptions(lines):
                if ex.check != "stats-columns" or not lo <= ex.line <= hi:
                    continue
                if not ex.reason:
                    findings.append(Finding(
                        file=rel(path), line=ex.line,
                        rule="mirror-missing-column",
                        message="stats-columns exemption without a "
                                "reason",
                        suggestion="append `: why` to the exempt "
                                   "comment"))
                    continue
                for col in ex.tokens:
                    exempt[family][col] = ex.reason

    union = set()
    for cols in used.values():
        union |= set(cols)
    for family in families:
        missing = sorted(union - set(used[family])
                         - set(exempt[family]))
        if not missing:
            continue
        file, line = anchor.get(family, ("<unknown>", 1))
        findings.append(Finding(
            file=file, line=line, rule="mirror-missing-column",
            message=(f"handler family {family!r} never touches stats "
                     f"column(s) {', '.join(missing)} written by a "
                     "sibling family"),
            suggestion="accumulate the column(s) or exempt them with "
                       "`# lint: exempt(stats-columns, ...): reason` "
                       "inside the family"))
    return findings


def check() -> List[Finding]:
    return check_mirrors() + check_column_coverage()
