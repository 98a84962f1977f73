"""Shared infrastructure of the static-analysis passes (torch port of
``repro.analysis.common``, kept as its own copy: the port imports
nothing of ``repro``).

Findings, source helpers, the ``# lint:`` comment grammar and the
alpha-renaming AST normalizer used by the mirror-site pass.

Comment grammar (DESIGN.md "Static invariant analysis"):

  * ``# lint: mirror(<group>)`` — marks the statement starting on this
    line (or, on a bare comment line, the next statement) as one site of
    mirror group ``<group>``; all sites of a group must normalize to
    the same expression shape.
  * ``# lint: exempt(<check>, TOK1 TOK2 ...): reason`` — exempts the
    listed tokens from ``<check>`` (e.g. ``stats-columns`` column names,
    a sweepable-field name).  The reason is mandatory: an exemption
    without a justification is itself a finding.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]

_MIRROR_RE = re.compile(r"#\s*lint:\s*mirror\(([\w.-]+)\)")
_EXEMPT_RE = re.compile(
    r"#\s*lint:\s*exempt\(([\w.-]+)\s*,\s*([^)]*)\)\s*(?::\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured lint finding: location, rule id, message, fix hint."""

    file: str        # repo-relative path
    line: int        # 1-based line number
    rule: str        # kebab-case rule id (stable; tests assert on it)
    message: str
    suggestion: str = ""

    def render(self) -> str:
        s = f" [{self.suggestion}]" if self.suggestion else ""
        return f"{self.file}:{self.line}: {self.rule}: {self.message}{s}"


def rel(path: "Path | str") -> str:
    """Repo-relative display path (absolute paths outside the repo are
    kept as-is — fixture corpora under a tmpdir stay addressable)."""
    p = Path(path).resolve()
    try:
        return str(p.relative_to(REPO_ROOT))
    except ValueError:
        return str(p)


def read_source(path: "Path | str") -> Tuple[str, List[str]]:
    text = Path(path).read_text()
    return text, text.splitlines()


def find_line(lines: Sequence[str], pattern: str,
              start: int = 0) -> Optional[int]:
    """1-based line number of the first line matching ``pattern``."""
    rx = re.compile(pattern)
    for i in range(start, len(lines)):
        if rx.search(lines[i]):
            return i + 1
    return None


@dataclasses.dataclass(frozen=True)
class MirrorMarker:
    group: str
    line: int          # line the marked statement starts on


@dataclasses.dataclass(frozen=True)
class Exemption:
    check: str
    tokens: Tuple[str, ...]
    reason: str
    line: int


def parse_markers(lines: Sequence[str]) -> List[MirrorMarker]:
    """Collect ``# lint: mirror(...)`` markers.

    A marker trailing code applies to the statement starting on its own
    line; a marker on a bare comment line applies to the next line.
    """
    out = []
    for i, raw in enumerate(lines):
        m = _MIRROR_RE.search(raw)
        if not m:
            continue
        code = raw[:m.start()].strip()
        target = i + 1 if code else i + 2
        out.append(MirrorMarker(group=m.group(1), line=target))
    return out


def parse_exemptions(lines: Sequence[str]) -> List[Exemption]:
    out = []
    for i, raw in enumerate(lines):
        m = _EXEMPT_RE.search(raw)
        if not m:
            continue
        tokens = tuple(t for t in m.group(2).split() if t)
        reason = (m.group(3) or "").strip()
        out.append(Exemption(check=m.group(1), tokens=tokens,
                             reason=reason, line=i + 1))
    return out


# ---------------------------------------------------------------------------
# AST statement lookup + alpha-renaming normalizer (mirror pass)
# ---------------------------------------------------------------------------

def statements_by_line(tree: ast.Module) -> Dict[int, ast.stmt]:
    """Innermost statement starting at each line (smallest span wins)."""
    at: Dict[int, ast.stmt] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        ln = node.lineno
        prev = at.get(ln)
        if prev is None or (_span(node) < _span(prev)):
            at[ln] = node
    return at


def _span(node: ast.stmt) -> int:
    return (getattr(node, "end_lineno", node.lineno) or node.lineno) \
        - node.lineno


def function_spans(tree: ast.Module) -> Dict[str, Tuple[int, int]]:
    """Dotted qualname -> (first line, last line) for every def."""
    spans: Dict[str, Tuple[int, int]] = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}{child.name}"
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    spans[qual] = (child.lineno, child.end_lineno)
                walk(child, qual + ".")
            else:
                walk(child, prefix)

    walk(tree, "")
    return spans


def module_preserved_names(tree: ast.Module) -> set:
    """Names the normalizer must NOT alpha-rename for this module:
    imports, module-level defs/constants, and a few builtins.  ALL_CAPS
    names are additionally preserved everywhere (constants by
    convention, wherever they were defined)."""
    keep = {"int", "float", "bool", "len", "max", "min", "range", "abs"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                keep.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                keep.add(a.asname or a.name)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            keep.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    keep.add(t.id)
    return keep


def _is_const_name(name: str) -> bool:
    return len(name) > 1 and name.isupper()


class _Renamer(ast.NodeTransformer):
    """Alpha-rename local names (and attribute chains rooted at them)
    to positional placeholders in first-occurrence order.

    ``st.stats`` in the handler and ``stats_cur`` in the macro both
    collapse to one placeholder, so structurally mirrored statements
    normalize equal regardless of local naming.
    """

    def __init__(self, preserved: set, prefix: str):
        self.preserved = preserved
        self.prefix = prefix
        self.map: Dict[str, str] = {}

    def _keep(self, name: str) -> bool:
        return name in self.preserved or _is_const_name(name)

    def _placeholder(self, key: str) -> str:
        if key not in self.map:
            self.map[key] = f"{self.prefix}{len(self.map)}"
        return self.map[key]

    @staticmethod
    def _chain(node: ast.Attribute) -> Optional[List[str]]:
        parts = []
        cur: ast.expr = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            parts.append(cur.id)
            return parts[::-1]
        return None

    def visit_Attribute(self, node: ast.Attribute):
        chain = self._chain(node)
        if chain is not None and not self._keep(chain[0]):
            name = self._placeholder(".".join(chain))
            return ast.copy_location(ast.Name(id=name, ctx=ast.Load()),
                                     node)
        return self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if self._keep(node.id):
            return node
        return ast.copy_location(
            ast.Name(id=self._placeholder(node.id), ctx=node.ctx), node)


def normalize_stmt(stmt: ast.stmt, preserved: set) -> str:
    """Canonical dump of one statement under alpha-renaming.

    Assignment targets rename in their own ``_t*`` namespace so that a
    carry-style in-place update (``x = x.at[...]``) and a fresh binding
    (``y = x.at[...]``) normalize identically — the mirror contract is
    about the *computed expression*, not the binding style.
    """
    stmt = ast.parse(ast.unparse(stmt)).body[0]   # drop position noise
    values = _Renamer(preserved, "_v")
    targets = _Renamer(preserved, "_t")
    if isinstance(stmt, ast.Assign):
        stmt.value = values.visit(stmt.value)
        stmt.targets = [targets.visit(t) for t in stmt.targets]
    elif isinstance(stmt, ast.AugAssign):
        stmt.value = values.visit(stmt.value)
        stmt.target = targets.visit(stmt.target)
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        stmt.value = values.visit(stmt.value)
        stmt.target = targets.visit(stmt.target)
    else:
        stmt = values.visit(stmt)
    ast.fix_missing_locations(stmt)
    return ast.dump(stmt)


def names_used(node: ast.AST, pattern: str) -> Dict[str, int]:
    """Names matching ``pattern`` loaded anywhere under ``node``:
    name -> first line seen."""
    rx = re.compile(pattern)
    out: Dict[str, int] = {}
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and rx.fullmatch(n.id):
            out.setdefault(n.id, n.lineno)
    return out


def attribute_names(trees: Iterable[ast.AST]) -> set:
    """Every attribute name accessed anywhere in the given ASTs."""
    out = set()
    for tree in trees:
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute):
                out.add(n.attr)
    return out
