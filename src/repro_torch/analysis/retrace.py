"""Pass 1: the one-program sweep contract over the engine's plain version
and the cell-scan kernel (torch port of ``repro.analysis.retrace``).

The engine's one-launch sweep property holds iff every sweepable config
knob reaches the compiled program as an *operand*.  In the reference
that program is the jaxpr of ``scan_cell``; in the port it is the
cell-scan kernel (``kernels/cell_scan.py``, ``csrc/cell_scan.cu``),
which takes a knob only through its packed operand tables — everything
else is a template parameter ``<SPL, D, FAB, EP, MAC>``.  The classic
regression — "someone turned an operand back into a constant" —
replaces ``sc["x"]`` with a baked Python value, or drops the key from a
table, or reads it under the wrong enum: results stay right for the
baked value, and on the card the knob silently no-ops.

Three checks, each the counterpart of one of the reference's:

  * **declaration** (as the reference's): every ``PCSConfig`` /
    ``DrainPolicy`` / ``AllocPolicy`` / ``Schedule`` field is registered
    here as sweepable (mapping to the ``sc`` keys it lowers to) or
    explicitly static (with a reason), and every registered key is
    emitted by ``scalars_from_config``;
  * **the plain version consumes every key** (for the reference's DCE of
    the traced cell): the exemplar runs under every scheme inside a
    :class:`~torch.overrides.TorchFunctionMode` that carries each
    tensor's source keys through every torch call.  A key is consumed
    when a tensor derived from it reaches an output, or is turned into a
    Python value that steers the step (``bool``, ``int``, ``float``,
    ``.item()``, ``.tolist()``, use as an index).  Copying a dict that
    holds it is not consuming it, so the ``sc`` rebuilt by
    ``state.epoch_rows`` and ``step.resolve_epoch_sc`` counts nothing by
    itself.  An unconsumed key is ``retrace-baked-static``;
  * **the kernel consumes every key** (for "survives DCE of the compiled
    program"; static, over ``kernels/cell_scan.py`` and
    ``csrc/cell_scan.cu``): every lowered key lies in one of the
    wrapper's operand tables or is packed by name in ``pack_configs``
    (``retrace-kernel-unpacked``); each table has the length and order
    of the ``.cu`` enum that names its columns
    (``retrace-kernel-order``); and each enum member is read in the
    kernel beyond its declaration (``retrace-kernel-unread``).
"""
from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.common import Finding, find_line, rel, REPO_ROOT

_WRAPPER = REPO_ROOT / "src" / "repro_torch" / "kernels" / "cell_scan.py"
_KERNEL = (REPO_ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "cell_scan.cu")

# Sweepable fields: dataclass field -> the sc keys its value feeds.
# Registering a field here is the "declared sweepable" contract of
# DESIGN.md — the keys must exist in scalars_from_config's output AND
# be consumed by the plain version and packed for the kernel.
SWEEPABLE_FIELDS: Dict[str, Tuple[str, ...]] = {
    "PCSConfig.crash_at_ns": ("crash_at",),
    "PCSConfig.n_tenants": ("n_tenants",),
    "PCSConfig.n_switches": ("n_switches", "ow_cpu_pm", "ow_cpu_sw1",
                             "ow_sw1_pm"),
    "PCSConfig.n_pbe": ("n_pbe", "threshold_count", "preset_count",
                        "tag_ns", "data_ns"),
    "PCSConfig.pbe_per_hop": ("deep_pbe", "deep_thr", "deep_pre",
                              "deep_tag", "deep_data"),
    "PCSConfig.drain_threshold": ("threshold_count", "t_threshold"),
    "PCSConfig.drain_preset": ("preset_count", "t_preset"),
    "DrainPolicy.threshold": ("threshold_count", "t_threshold",
                              "deep_thr"),
    "DrainPolicy.preset": ("preset_count", "t_preset", "deep_pre"),
    "DrainPolicy.per_tenant": ("drain_scope", "t_threshold", "t_preset"),
    "DrainPolicy.low_water_drains": ("low_water",),
    "DrainPolicy.empty_slack": ("empty_slack",),
    "DrainPolicy.latency_target_ns": ("lat_target",),
    "DrainPolicy.latency_tol": ("lat_tol",),
    "AllocPolicy.victim": ("victim_weighted",),
    "AllocPolicy.tenant_quota": ("quota", "share", "t_threshold",
                                 "t_preset"),
    # fan-out fabric descriptor: lowers to the leaf-partition operands
    # (engine.fabric) plus the spine backpressure watermark; a fabric
    # also forces pbe_per_hop, so the deep_* keys co-vary via that field
    "PCSConfig.fabric": ("n_leaves", "leaf_of_t", "leaf_base", "bp_high"),
    # epoched schedules (params.Schedule): the shared boundary vector
    # lowers to the one epoch_bounds operand; each epoch's values lower
    # through the wrapped knob into the EPOCH_KEYS rows the per-op
    # selection (engine.step.resolve_epoch_sc) indexes.  The exemplar
    # cell is 2-epoch, so the check proves both the boundary vector and
    # the stacked rows are consumed.
    "Schedule.boundaries_ns": ("epoch_bounds",),
    "Schedule.values": ("threshold_count", "preset_count", "quota",
                        "share", "t_threshold", "t_preset", "deep_thr",
                        "deep_pre", "lat_target", "leaf_of_t"),
}

# Statically-shaped / composite fields: changing one legitimately
# recompiles (array shapes) or lowers through child fields.
STATIC_FIELDS: Dict[str, str] = {
    "PCSConfig.scheme": "traced separately as the scheme operand",
    "PCSConfig.n_cores": "array shape (trace row count)",
    "PCSConfig.pm_banks": "array shape (PM bank axis)",
    "PCSConfig.policy": "composite; lowers via DrainPolicy/AllocPolicy",
    "PCSConfig.latency": "composite; lowers via the latency scalar keys",
}

# The wrapper's operand tables -> the csrc/cell_scan.cu enum naming
# their columns, and the enum member the table's run starts at (None:
# the table is the whole enum).  EPOCH_DEEP_KEYS is copied over the
# chain row as one run from DK_THR on.
KERNEL_TABLES: Dict[str, Tuple[str, Optional[str]]] = {
    "SC_KEYS": ("ScKey", None),
    "TENANT_KEYS": ("TenKey", None),
    "CHAIN_KEYS": ("ChKey", None),
    "DEEP_KEYS": ("DeepKey", None),
    "FAB_KEYS": ("FabKey", None),
    "EPOCH_SC_KEYS": ("EpKey", None),
    "EPOCH_DEEP_KEYS": ("DeepKey", "DK_THR"),
}

# Words a column's key and its enum member may differ by: units and the
# per-tenant / per-hop / count qualifiers (``t_threshold`` is TenKey's
# T_THRESHOLD, ``threshold_count`` ScKey's K_THRESHOLD).
_QUALIFIERS = frozenset({"ns", "count", "t", "deep"})


# ---------------------------------------------------------------------------
# the plain version consumes every key (key flow through torch calls)
# ---------------------------------------------------------------------------

# Tensor methods that turn a value into a Python one the step can branch
# or index on.
_STEER = frozenset({"__bool__", "__int__", "__float__", "__index__",
                    "item", "tolist"})
_ATTR = "_analysis_keys"


def _keys_in(obj) -> Set[str]:
    if isinstance(obj, torch.Tensor):
        return getattr(obj, _ATTR, set())
    if isinstance(obj, (list, tuple)):
        out: Set[str] = set()
        for x in obj:
            out |= _keys_in(x)
        return out
    if isinstance(obj, dict):
        return _keys_in(list(obj.values()))
    return set()


def _tag(obj, keys: Set[str]) -> None:
    if isinstance(obj, torch.Tensor):
        setattr(obj, _ATTR, getattr(obj, _ATTR, set()) | keys)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tag(x, keys)


def _in_place(func) -> bool:
    name = getattr(func, "__name__", "")
    return name == "__setitem__" or (name.endswith("_")
                                     and not name.endswith("__"))


class KeyFlow(TorchFunctionMode):
    """Carries every tensor's source keys through each torch call: an
    output gets the union of its inputs' keys, an in-place op's target
    gets its operands', and :data:`_STEER` calls record theirs in
    ``steered``."""

    def __init__(self):
        super().__init__()
        self.steered: Set[str] = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        keys = _keys_in(args) | _keys_in(kwargs)
        if keys and getattr(func, "__name__", "") in _STEER:
            self.steered |= keys
        out = func(*args, **kwargs)
        if keys:
            if _in_place(func) and args:
                _tag(args[0], keys)
            if "out" in kwargs:
                _tag(kwargs["out"], keys)
            _tag(out, keys)
        return out


def _arg_names(args: tuple) -> List[str]:
    """The sorted keys of each dict argument, ``"arg"`` for any other."""
    names: List[str] = []
    for a in args:
        names += sorted(a) if isinstance(a, dict) else ["arg"]
    return names


def _keyed(value, key: str, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=dtype).clone()
    setattr(t, _ATTR, {key})
    return t


def consumed_keys(fn, args: tuple) -> Set[str]:
    """The names of ``args`` (:func:`_arg_names`) that ``fn`` consumes:
    those reaching its outputs and those it steers on.  ``fn`` runs on
    fresh f64 copies of every dict value, each keyed by its name."""
    keyed = tuple({k: _keyed(a[k], k, torch.float64) for k in sorted(a)}
                  if isinstance(a, dict) else _keyed(a, "arg")
                  for a in args)
    with KeyFlow() as flow:
        out = fn(*keyed)
    return _keys_in(out) | flow.steered


def check_traced(fn=None, args: Optional[tuple] = None,
                 names: Optional[Sequence[str]] = None,
                 anchors: Optional[Dict[str, Tuple[str, int]]] = None,
                 consumed: Optional[Set[str]] = None) -> List[Finding]:
    """Core retrace check: every named operand must be consumed.

    Either pass ``fn``/``args`` — a torch function over a dict of
    tensors, whose names default to the sorted keys of each dict
    argument (``"arg"`` for any other) — or a precomputed ``consumed``
    set with its ``names``.
    """
    if consumed is None:
        names = _arg_names(args) if names is None else names
        consumed = consumed_keys(fn, args)
    findings = []
    for name in names:
        if name in consumed:
            continue
        file, line = (anchors or {}).get(name, ("<traced>", 0))
        findings.append(Finding(
            file=file, line=line, rule="retrace-baked-static",
            message=(f"operand {name!r} is dead in the plain version's "
                     "run: no output depends on it and no step branches "
                     "on it (a sweepable knob was baked into a Python "
                     "constant, or its lowering is dead code)"),
            suggestion=f"consume sc[{name!r}] in the step, or drop the "
                       "lowering"))
    return findings


def engine_consumed(extra: Optional[dict] = None) -> Set[str]:
    """The exemplar's keys (and ``extra``'s) that the plain ``scan_cell``
    consumes over its runs under every scheme."""
    from repro_torch.analysis import _engine
    _, _, sc = _engine.example_inputs()
    return consumed_keys(_engine.every_scheme, ({**sc, **(extra or {})},))


# ---------------------------------------------------------------------------
# declaration side
# ---------------------------------------------------------------------------

def _scalar_anchors() -> Dict[str, Tuple[str, int]]:
    """sc key -> (file, line) of its ``key=`` in the lowering."""
    from repro_torch.core.engine import state
    fn = state._scalars_numpy
    src, start = inspect.getsourcelines(fn)
    file = rel(inspect.getsourcefile(fn))
    anchors = {}
    for off, raw in enumerate(src):
        stripped = raw.strip()
        key = stripped.split("=", 1)[0].strip()
        if "=" in stripped and key.isidentifier():
            anchors.setdefault(key, (file, start + off))
    return anchors


def _field_anchor(cls, field: str) -> Tuple[str, int]:
    src, start = inspect.getsourcelines(cls)
    file = rel(inspect.getsourcefile(cls))
    line = find_line([l.rstrip("\n") for l in src],
                     rf"^\s*{field}\s*[:=]")
    return file, start + (line - 1) if line else start


def check_registered_fields(classes: Sequence[type],
                            sweepable: Optional[Dict[str, Tuple[str, ...]]]
                            = None,
                            static: Optional[Dict[str, str]] = None
                            ) -> List[Finding]:
    """Every dataclass field of ``classes`` is registered one way.

    The declaration-side half of the retrace contract, standalone so
    the fixture corpus can run it against a params-like module: a field
    missing from both registries — the classic "added a schedule knob,
    forgot to declare how it lowers" slip — fires
    ``retrace-unregistered-field``.
    """
    import dataclasses

    sweepable = SWEEPABLE_FIELDS if sweepable is None else sweepable
    static = STATIC_FIELDS if static is None else static
    findings: List[Finding] = []
    for cls in classes:
        for f in dataclasses.fields(cls):
            qual = f"{cls.__name__}.{f.name}"
            if qual in sweepable or qual in static:
                continue
            file, line = _field_anchor(cls, f.name)
            findings.append(Finding(
                file=file, line=line, rule="retrace-unregistered-field",
                message=(f"{qual} is neither registered as sweepable "
                         "(SWEEPABLE_FIELDS) nor declared static "
                         "(STATIC_FIELDS) in repro_torch.analysis.retrace"),
                suggestion="register the field with the sc keys it "
                           "lowers to, or declare it static with a "
                           "reason"))
    return findings


# ---------------------------------------------------------------------------
# the kernel consumes every key (static, over the wrapper and the .cu)
# ---------------------------------------------------------------------------

def wrapper_tables(path: Optional[Path] = None
                   ) -> Tuple[Dict[str, Tuple[Tuple[str, ...], int]],
                              Set[str]]:
    """The wrapper's ``*_KEYS`` tuples (name -> (keys, line)) and the keys
    ``pack_configs`` packs by name (``sc["leaf_base"]`` ...)."""
    path = _WRAPPER if path is None else path
    tree = ast.parse(Path(path).read_text())
    tables: Dict[str, Tuple[Tuple[str, ...], int]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_KEYS")
                and isinstance(node.value, ast.Tuple)):
            continue
        tables[node.targets[0].id] = (
            tuple(e.value for e in node.value.elts
                  if isinstance(e, ast.Constant)), node.lineno)
    by_name: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "pack_configs":
            for n in ast.walk(node):
                if (isinstance(n, ast.Subscript)
                        and isinstance(n.slice, ast.Constant)
                        and isinstance(n.slice.value, str)):
                    by_name.add(n.slice.value)
    return tables, by_name


def _strip_comments(text: str) -> str:
    """``text`` with C/C++ comments blanked, line structure kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def kernel_enums(path: Optional[Path] = None
                 ) -> Dict[str, List[Tuple[str, int]]]:
    """Every ``enum Name { ... }`` of the kernel source: name -> its
    members with their lines, without the trailing ``N_*`` count."""
    path = _KERNEL if path is None else path
    text = _strip_comments(Path(path).read_text())
    enums: Dict[str, List[Tuple[str, int]]] = {}
    for m in re.finditer(r"\benum\s+(\w+)\s*\{([^}]*)\}", text):
        members = []
        off = m.start(2)
        for part in m.group(2).split(","):
            name = part.split("=")[0].strip()
            if name:
                line = text.count("\n", 0, off + part.index(name)) + 1
                members.append((name, line))
            off += len(part) + 1
        if members and members[-1][0].startswith("N_"):
            members.pop()
        enums[m.group(1)] = members
    return enums


def _column_words(name: str) -> frozenset:
    return frozenset(name.lower().split("_")) - _QUALIFIERS


def _member_column(member: str) -> frozenset:
    """A member's column words: its name without the enum's prefix
    (``K_PBC_READ_OCC`` -> pbc, read, occ)."""
    return _column_words(member.split("_", 1)[1])


def check_kernel(wrapper: Optional[Path] = None,
                 source: Optional[Path] = None,
                 keys: Optional[Sequence[str]] = None,
                 anchors: Optional[Dict[str, Tuple[str, int]]] = None
                 ) -> List[Finding]:
    """The kernel's operand tables carry every lowered key, in the order
    of the enums the kernel reads them by, and the kernel reads every
    enum member."""
    wrapper = _WRAPPER if wrapper is None else Path(wrapper)
    source = _KERNEL if source is None else Path(source)
    if keys is None:
        from repro_torch.analysis._engine import scalar_keys
        keys = scalar_keys()
    anchors = _scalar_anchors() if anchors is None else anchors
    tables, by_name = wrapper_tables(wrapper)
    enums = kernel_enums(source)
    findings: List[Finding] = []

    packed = set(by_name)
    for table, _ in tables.values():
        packed |= set(table)
    for key in keys:
        if key in packed:
            continue
        file, line = anchors.get(key, (rel(wrapper), 1))
        findings.append(Finding(
            file=file, line=line, rule="retrace-kernel-unpacked",
            message=(f"sc[{key!r}] is lowered but lies in none of the "
                     f"cell-scan kernel's operand tables ({rel(wrapper)}): "
                     "the kernel never sees the knob"),
            suggestion="add the key to the table whose enum the kernel "
                       "reads it by (and the member to that enum)"))

    for name, (enum, start) in KERNEL_TABLES.items():
        if name not in tables:
            findings.append(Finding(
                file=rel(wrapper), line=1, rule="retrace-kernel-order",
                message=f"operand table {name} is missing from the "
                        "wrapper",
                suggestion="update KERNEL_TABLES in "
                           "repro_torch.analysis.retrace"))
            continue
        table, t_line = tables[name]
        members = [m for m, _ in enums.get(enum, [])]
        if start is not None:
            members = members[members.index(start):][:len(table)] \
                if start in members else []
        fault = None
        if len(members) != len(table):
            fault = (f"{name} has {len(table)} keys but enum {enum} "
                     f"{'from ' + start + ' on ' if start else ''}has "
                     f"{len(members)} member(s)")
        else:
            for i, (key, member) in enumerate(zip(table, members)):
                if _column_words(key) != _member_column(member):
                    fault = (f"{name}[{i}] is {key!r} but member {i} of "
                             f"enum {enum}{' from ' + start if start else ''}"
                             f" is {member}")
                    break
        if fault:
            findings.append(Finding(
                file=rel(wrapper), line=t_line, rule="retrace-kernel-order",
                message=fault + f" ({rel(source)}): the kernel reads the "
                                "column under another knob's name",
                suggestion="keep the table and the enum in one order"))

    text = _strip_comments(source.read_text())
    spans = [(m.start(), m.end())
             for m in re.finditer(r"\benum\s+\w+\s*\{[^}]*\}", text)]
    body = "".join(text[a:b] for a, b in zip([0] + [e for _, e in spans],
                                             [s for s, _ in spans]
                                             + [len(text)]))
    for enum in sorted({e for e, _ in KERNEL_TABLES.values()}):
        for member, line in enums.get(enum, []):
            if not re.search(rf"\b{member}\b", body):
                findings.append(Finding(
                    file=rel(source), line=line,
                    rule="retrace-kernel-unread",
                    message=(f"enum {enum} member {member} is never read "
                             "in the kernel: its column is packed but "
                             "the knob no-ops on the card"),
                    suggestion="read the column where the plain version "
                               "reads the key, or drop it from the table "
                               "and the lowering"))
    return findings


def check_engine() -> List[Finding]:
    """Run the retrace pass against the real engine and kernel."""
    from repro_torch.analysis._engine import scalar_keys
    from repro_torch.core import params

    findings: List[Finding] = []
    anchors = _scalar_anchors()
    keys = scalar_keys()

    # 1. registry <-> lowering agreement
    for field, targets in SWEEPABLE_FIELDS.items():
        cls_name, fname = field.split(".")
        cls = getattr(params, cls_name)
        for key in targets:
            if key not in keys:
                file, line = _field_anchor(cls, fname)
                findings.append(Finding(
                    file=file, line=line, rule="retrace-missing-lowering",
                    message=(f"sweepable field {field} is registered to "
                             f"lower to sc[{key!r}], but "
                             "scalars_from_config emits no such key"),
                    suggestion="lower the field in scalars_from_config "
                               "or fix the registry entry"))

    # 2. every policy/config/schedule dataclass field is registered
    findings += check_registered_fields(
        [getattr(params, n)
         for n in ("PCSConfig", "DrainPolicy", "AllocPolicy", "Schedule")])

    # 3. the plain version consumes every lowered key
    findings += check_traced(names=keys, consumed=engine_consumed(),
                             anchors=anchors)

    # 4. the kernel's tables carry them, in its enums' order, all read
    findings += check_kernel(keys=keys, anchors=anchors)
    return findings
