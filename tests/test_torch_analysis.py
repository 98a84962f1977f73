"""The port's static invariant analysis (``repro_torch.analysis``)
against the reference's (``repro.analysis``) on the CPU.

Every pass fires, with its rule id, at the planted line of its fixture
(``tests/fixtures/analysis/`` and ``tests/fixtures/analysis/torch/``)
or of a temporary copy of the port's sources; both packages give the
same findings on the shared fixtures; the port's consumed-key set and
final carry equal the reference's DCE-live set and final state; the
real tree is clean.  Every comparison is exact.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import (_engine, common, dtypes, mirror, retrace,
                                  run_all, sweeps, twin)
from repro_torch.core.engine import handlers, step

FIX = Path(__file__).resolve().parent / "fixtures" / "analysis"
TFIX = FIX / "torch"
ROOT = Path(__file__).resolve().parents[1]
PORT_ENGINE = ROOT / "src" / "repro_torch" / "core" / "engine"
REF_ENGINE = ROOT / "src" / "repro" / "core" / "engine"
MIRROR_SOURCES = [d / f for d in (REF_ENGINE, PORT_ENGINE)
                  for f in ("handlers.py", "macro.py", "policy.py")]


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


def where(findings):
    """(file, line, rule, message) of each finding: the suggestions name
    the package that makes them."""
    return [(f.file, f.line, f.rule, f.message) for f in findings]


def swap_handler(monkeypatch, op: int, fn) -> None:
    """Run ``fn`` in place of the step loop's handler of ``op``."""
    table = list(handlers.HANDLERS)
    table[op] = fn
    monkeypatch.setattr(step, "HANDLERS", table)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ common and mirror
@pytest.mark.parametrize("path", MIRROR_SOURCES,
                         ids=lambda p: f"{p.parts[-4]}-{p.name}")
def test_common_helpers_match_reference(ref, path):
    rc = ref.analysis.common
    text, lines = common.read_source(path)
    assert [dataclasses.astuple(m) for m in common.parse_markers(lines)] \
        == [dataclasses.astuple(m) for m in rc.parse_markers(lines)]
    assert [dataclasses.astuple(e) for e in common.parse_exemptions(lines)] \
        == [dataclasses.astuple(e) for e in rc.parse_exemptions(lines)]
    tree = ast.parse(text)
    assert common.function_spans(tree) == rc.function_spans(tree)
    keep = common.module_preserved_names(tree)
    assert keep == rc.module_preserved_names(tree)
    stmts = common.statements_by_line(tree)
    assert sorted(stmts) == sorted(rc.statements_by_line(tree))
    for line, stmt in sorted(stmts.items()):
        assert common.normalize_stmt(stmt, keep) \
            == rc.normalize_stmt(stmt, keep), (path.name, line)


def test_port_markers_cover_reference_groups(ref):
    """The port's registry is the reference's, and every group's marked
    sites normalize equal on the port's tree."""
    assert mirror.MIRROR_GROUPS == ref.analysis.mirror.MIRROR_GROUPS
    assert mirror.check() == []


def test_mirror_fixture_matches_reference(ref):
    path = FIX / "mirror_bad.py"
    expected = {"pair": 2, "same": 2, "ghost": 1}
    got = mirror.check_mirrors(paths=[path], expected=expected)
    want = ref.analysis.mirror.check_mirrors(paths=[path], expected=expected)
    assert where(got) == where(want)
    assert [(f.rule, f.line) for f in got] == [
        ("mirror-unknown-group", 26), ("mirror-dangling-marker", 45),
        ("mirror-missing-site", 1), ("mirror-skew", 11)]


def test_mirror_column_coverage_fixture_matches_reference(ref):
    families = {"a": [("mirror_bad.py", "fam_a")],
                "b": [("mirror_bad.py", "fam_b")],
                "c": [("mirror_bad.py", "fam_c")]}
    got = mirror.check_column_coverage(families=families, base=FIX)
    want = ref.analysis.mirror.check_column_coverage(families=families,
                                                     base=FIX)
    assert where(got) == where(want)
    assert [f.rule for f in got] == ["mirror-missing-column"] * 2


@pytest.fixture
def engine_copy(tmp_path):
    """A temporary copy of the port's three mirror sources."""
    for f in ("handlers.py", "macro.py", "policy.py"):
        shutil.copy(PORT_ENGINE / f, tmp_path / f)
    return tmp_path


def _edit(path: Path, old: str, new: str) -> int:
    """Replace the one line holding ``old``; returns its line number."""
    lines = path.read_text().splitlines(keepends=True)
    hits = [i for i, l in enumerate(lines) if old in l]
    assert len(hits) == 1, (path.name, old, hits)
    lines[hits[0]] = lines[hits[0]].replace(old, new)
    path.write_text("".join(lines))
    return hits[0] + 1


def test_mirror_planted_skew_fires_once(engine_copy):
    line = _edit(engine_copy / "policy.py",
                 "do_drain = dirty_cnt >= thr", "do_drain = dirty_cnt > thr")
    paths = [engine_copy / f for f in ("handlers.py", "macro.py",
                                       "policy.py")]
    got = mirror.check_mirrors(paths=paths, expected=mirror.MIRROR_GROUPS)
    assert [(f.rule, Path(f.file).name, f.line) for f in got] \
        == [("mirror-skew", "policy.py", line)]
    assert "'rf-do-drain'" in got[0].message


def test_mirror_removed_marker_fires(engine_copy):
    _edit(engine_copy / "macro.py", "  # lint: mirror(slo-tight)", "")
    paths = [engine_copy / f for f in ("handlers.py", "macro.py",
                                       "policy.py")]
    got = mirror.check_mirrors(paths=paths, expected=mirror.MIRROR_GROUPS)
    assert [f.rule for f in got] == ["mirror-missing-site"]
    assert "'slo-tight' has 1 marked site(s)" in got[0].message


def test_mirror_removed_exemption_fires(engine_copy):
    _edit(engine_copy / "macro.py",
          "# lint: exempt(stats-columns, S_STALL_TIME S_VICTIM_CNT)",
          "# (removed)")
    got = mirror.check_column_coverage(base=engine_copy)
    replay = common.function_spans(
        ast.parse((engine_copy / "macro.py").read_text()))["replay"][0]
    assert [(f.rule, f.line) for f in got] == [("mirror-missing-column",
                                               replay)]
    assert "'macro'" in got[0].message
    assert "S_STALL_TIME, S_VICTIM_CNT" in got[0].message


# ------------------------------------------------------------------ twin
def test_twin_policy_fixture_matches_reference(ref):
    kw = dict(engine_paths=[FIX / "engine_bad.py"],
              oracle_paths=[FIX / "oracle_bad.py"],
              fields={"Fake.alpha": ("fake.py", 10),
                      "Fake.beta": ("fake.py", 20)})
    got = twin.check_policy_fields(**kw)
    want = ref.analysis.twin.check_policy_fields(**kw)
    assert where(got) == where(want)
    assert [(f.rule, f.line) for f in got] == [("twin-policy-oracle", 10),
                                               ("twin-policy-engine", 20)]


def _consumed_fields(side_names, paths, fields):
    attrs = side_names(paths)
    return {q for q in fields if q.split(".")[-1] in attrs}


def test_twin_policy_consumers_match_reference(ref):
    rt = ref.analysis.twin
    fields = twin.policy_fields()
    want_fields = [f"{c.__name__}.{f.name}"
                   for c in (ref.params.DrainPolicy, ref.params.AllocPolicy,
                             ref.params.Schedule)
                   for f in dataclasses.fields(c)]
    assert list(fields) == want_fields
    for port_paths, ref_paths in (
            (twin.engine_sources(), sorted(rt._ENGINE_DIR.glob("*.py"))),
            (twin.oracle_sources(), [rt._SEMANTICS])):
        got = _consumed_fields(twin.side_attribute_names, port_paths, fields)
        want = _consumed_fields(rt.side_attribute_names, ref_paths, fields)
        assert got == want == set(fields)


def test_twin_stat_columns_match_reference(ref):
    rt = ref.analysis.twin
    assert list(twin.engine_stat_columns()) == list(rt._engine_stat_columns())
    assert list(twin.oracle_stat_keys()) == list(rt._oracle_stat_keys())
    for name in ("S_TWINS", "S_EXEMPT", "ORACLE_EXEMPT", "SIMRESULT_EXEMPT"):
        assert getattr(twin, name) == getattr(rt, name), name
    assert twin.check() == []


def test_twin_simresult_corpus_is_the_ports():
    corpus = twin.simresult_corpus()
    assert ROOT / "chip_smoke.py" in corpus
    assert ROOT / "tests" / "_torch_ref.py" in corpus
    assert PORT_ENGINE / "step.py" in corpus
    assert PORT_ENGINE / "state.py" not in corpus
    parts = [p.relative_to(ROOT).parts for p in corpus]
    assert not [q for q in parts if "analysis" in q or "repro" in q]


# --------------------------------------------------------------- retrace
def test_retrace_registries_and_keys_match_reference(ref):
    ra = ref.analysis
    assert retrace.SWEEPABLE_FIELDS == ra.retrace.SWEEPABLE_FIELDS
    assert retrace.STATIC_FIELDS == ra.retrace.STATIC_FIELDS
    assert _engine.scalar_keys() == ra.engine.scalar_keys()


def test_consumed_keys_equal_reference_dce_live_set(ref):
    ra = ref.analysis
    with ref.stand_in():
        closed, names = ra.engine.trace_engine(return_state=False)
    live = {n for n, used in zip(names, ra.retrace._dce_unused(closed))
            if used and n != "scheme"}
    assert retrace.engine_consumed() == live == set(_engine.scalar_keys())


def test_retrace_fixtures_fire_as_the_reference(ref):
    mod = load(TFIX / "retrace_fixtures.py", "torch_retrace_fixtures")
    cases = [(mod.baked, {"used": 1.0, "baked": 2.0}, ["baked"]),
             (mod.all_live, {"a": 1.0, "b": 2.0}, []),
             (mod.epoch_baked, {"quota": np.arange(2.0), "crash_at": 1.0,
                                "epoch_bounds": np.full((1,), 9.9e9)},
              ["epoch_bounds"])]
    for fn, sc, dead in cases:
        got = retrace.check_traced(fn=fn, args=(sc,))
        want = ref.analysis.retrace.check_traced(fn=fn, args=(sc,))
        assert [f.rule for f in got] == [f.rule for f in want] \
            == ["retrace-baked-static"] * len(dead)
        for f, w, name in zip(got, want, dead):
            assert f"'{name}'" in f.message and f"'{name}'" in w.message


def test_retrace_steering_counts_and_dict_copies_do_not():
    mod = load(TFIX / "retrace_fixtures.py", "torch_retrace_fixtures")
    assert retrace.check_traced(fn=mod.steered,
                                args=({"x": 1.0, "gate": 1.0},)) == []
    got = retrace.check_traced(fn=mod.rebuilt,
                               args=({"used": 1.0, "copied": 2.0},))
    assert [f.rule for f in got] == ["retrace-baked-static"]
    assert "'copied'" in got[0].message


def test_retrace_registered_fields_fixture():
    mod = load(FIX / "params_bad.py", "params_bad")
    got = retrace.check_registered_fields(
        [mod.BadPolicy],
        sweepable={"BadPolicy.threshold": ("threshold_count",)}, static={})
    assert [f.rule for f in got] == ["retrace-unregistered-field"]
    assert "BadPolicy.quota_schedule" in got[0].message
    assert got[0].file.endswith("params_bad.py") and got[0].line == 12


def test_retrace_engine_flags_planted_and_baked_keys(monkeypatch):
    """The real engine path fires too: a lowered key nothing reads, and
    a handler that bakes ``sc["dram_ns"]`` into a constant."""
    keys = _engine.scalar_keys()
    got = retrace.check_traced(names=keys + ["planted"],
                               consumed=retrace.engine_consumed(
                                   {"planted": 1.0}))
    assert [f.rule for f in got] == ["retrace-baked-static"]
    assert "'planted'" in got[0].message

    def baked_dram_read(ctx, st):
        stats = st.stats.clone()
        stats[ctx.tenant, handlers.S_DRAM_READS] += 1.0
        return st._replace(clock=handlers._set(st.clock, ctx.c, ctx.t + 80.0),
                           stats=stats)
    swap_handler(monkeypatch, 1, baked_dram_read)
    got = retrace.check_traced(names=keys, consumed=retrace.engine_consumed())
    assert [f.rule for f in got] == ["retrace-baked-static"]
    assert "'dram_ns'" in got[0].message


def test_retrace_kernel_tables_clean_and_whole():
    tables, by_name = retrace.wrapper_tables()
    packed = set(by_name).union(*(set(k) for k, _ in tables.values()))
    assert set(_engine.scalar_keys()) <= packed
    assert by_name == {"leaf_base", "leaf_of_t", "epoch_bounds"}
    assert retrace.check_kernel() == []
    assert retrace.check_engine() == []


@pytest.fixture
def kernel_copy(tmp_path):
    src = ROOT / "src" / "repro_torch" / "kernels"
    shutil.copy(src / "cell_scan.py", tmp_path / "cell_scan.py")
    shutil.copy(src / "csrc" / "cell_scan.cu", tmp_path / "cell_scan.cu")
    return tmp_path / "cell_scan.py", tmp_path / "cell_scan.cu"


def test_retrace_kernel_unread_member_fires_once(kernel_copy):
    wrapper, source = kernel_copy
    _edit(source, "t + sc[K_DRAM_NS]", "t + 80.0")
    got = retrace.check_kernel(wrapper=wrapper, source=source)
    decl = next(i + 1 for i, l in enumerate(source.read_text().splitlines())
                if "K_DRAM_NS" in l)
    assert [(f.rule, f.line) for f in got] == [("retrace-kernel-unread",
                                               decl)]
    assert "K_DRAM_NS" in got[0].message


def test_retrace_kernel_unpacked_key_fires_once(kernel_copy):
    wrapper, source = kernel_copy
    _edit(wrapper, '"dram_ns", "fwd_margin"', '"fwd_margin"')
    got = retrace.check_kernel(wrapper=wrapper, source=source)
    unpacked = by_rule(got, "retrace-kernel-unpacked")
    assert len(unpacked) == 1 and "'dram_ns'" in unpacked[0].message
    # the table no longer has its enum's length either
    assert [f.rule for f in got] == ["retrace-kernel-unpacked",
                                     "retrace-kernel-order"]
    assert "SC_KEYS has 26 keys" in got[1].message


def test_retrace_kernel_order_fires_once(kernel_copy):
    wrapper, source = kernel_copy
    line = _edit(wrapper, '"nvm_read", "nvm_write"', '"nvm_write", "nvm_read"')
    got = retrace.check_kernel(wrapper=wrapper, source=source)
    assert [f.rule for f in got] == ["retrace-kernel-order"]
    assert "SC_KEYS[14] is 'nvm_write'" in got[0].message
    assert "K_NVM_READ" in got[0].message
    assert got[0].line == line - 3      # the table's first line


def test_retrace_kernel_epoch_deep_run_order(kernel_copy):
    wrapper, source = kernel_copy
    _edit(wrapper, 'EPOCH_DEEP_KEYS = ("deep_thr", "deep_pre")',
          'EPOCH_DEEP_KEYS = ("deep_pre", "deep_thr")')
    got = retrace.check_kernel(wrapper=wrapper, source=source)
    assert [f.rule for f in got] == ["retrace-kernel-order"]
    assert "EPOCH_DEEP_KEYS[0] is 'deep_pre'" in got[0].message


# ---------------------------------------------------------------- dtypes
def test_dtype_packing_fixture_matches_reference(ref):
    kw = dict(shapes={"a": ("int32", (4,)), "c": ("int8", (2,))},
              expected={"a": "int8", "b": "float64"},
              anchor_file=FIX / "grid_bad.py")
    got = dtypes.check_packing(**kw)
    want = ref.analysis.dtypes.check_packing(**kw)
    assert where(got) == where(want)
    assert [f.rule for f in got] == ["dtype-packing"] * 3
    assert dtypes.EXPECTED_DTYPES == ref.analysis.dtypes.EXPECTED_DTYPES


def test_final_state_shapes_match_reference(ref):
    with ref.stand_in():
        want = ref.analysis.engine.final_state_shapes()
    got = _engine.final_state_shapes()
    assert list(got) == list(want)
    for col in want:
        assert got[col] == want[col], col
    assert dtypes.check_packing(shapes=got) == []


def test_dtype_f32_leak_fixture_fires_at_its_line():
    mod = load(TFIX / "leak_fixture.py", "torch_leak_fixture")
    got = dtypes.check_f32_leaks(fn=mod.leak,
                                 args=(torch.tensor(1.0, dtype=torch.float64),))
    assert [f.rule for f in got] == ["dtype-f32-leak"]
    assert got[0].file.endswith("leak_fixture.py") and got[0].line == 8
    assert "_to_copy" in got[0].message


def test_dtype_f32_leak_engine_clean_and_planted(monkeypatch):
    assert dtypes.check_f32_leaks() == []

    def demoting_dram_read(ctx, st):
        t = (ctx.t + ctx.sc["dram_ns"]).to(torch.float32)
        return st._replace(clock=handlers._set(st.clock, ctx.c,
                                               t.to(torch.float64)))
    swap_handler(monkeypatch, 1, demoting_dram_read)
    got = dtypes.check_f32_leaks()
    # located at the innermost frame of the port: the step's handler call
    assert [(f.rule, Path(f.file).name) for f in got] \
        == [("dtype-f32-leak", "step.py")]


# ---------------------------------------------------------------- sweeps
@pytest.mark.parametrize("bench", ["bench_bad", "bench_bad_fabric"])
def test_sweeps_fixtures_match_reference(ref, bench):
    got = sweeps.check(FIX / bench)
    want = ref.analysis.sweeps.check(bench_dir=FIX / bench)
    assert [(f.file, f.line, f.rule) for f in got] \
        == [(f.file, f.line, f.rule) for f in want]
    assert [f.message.split("'")[1] for f in got] \
        == [f.message.split("'")[1] for f in want]
    assert len(got) == (3 if bench == "bench_bad" else 1)


# ------------------------------------------------- scan_cell(return_state)
@pytest.mark.parametrize("scheme", _engine.schemes())
def test_scan_cell_return_state_keeps_outputs(scheme):
    off = _engine.run_cell(scheme)
    on = _engine.run_cell(scheme, return_state=True)
    assert len(on) == len(off) + 1
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_scan_cell_final_state_matches_reference(ref):
    import jax
    import jax.numpy as jnp

    from repro.core.engine.step import scan_cell
    with ref.stand_in():
        (ops, addrs, gaps, lengths, mlen), statics, sc = \
            ref.analysis.engine._example_inputs()
    # the reference's scan runs a fixed step count: enough for the 64 ops
    statics = dict(statics, n_steps=64)
    with ref.x64():
        cell = jax.jit(lambda scheme, sc: scan_cell(
            ops, addrs, gaps, lengths, scheme, sc, mlen=mlen,
            return_state=True, **statics))
        out = cell(jnp.asarray(2, jnp.int32),
                   {k: jnp.asarray(v, jnp.float64) for k, v in sc.items()})
        want = {k: np.asarray(v) for k, v in out[-1]._asdict().items()}
    got = _engine.run_cell(2, return_state=True)
    assert float(got[0]) == float(out[0])
    for k, v in got[-1]._asdict().items():
        a = v.numpy()
        assert a.dtype == want[k].dtype and a.shape == want[k].shape, k
        assert np.array_equal(a, want[k]), k


# -------------------------------------------------------- whole package
def test_real_tree_all_passes_clean():
    results = run_all()
    assert list(results) == ["retrace", "mirror", "twin", "dtypes"]
    assert [f.render() for fs in results.values() for f in fs] == []


def test_cli_clean_and_json_schema(ref, tmp_path):
    out = tmp_path / "analysis.json"
    assert cli.main(["--fail-on-findings", "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    fake = {"mirror": [common.Finding("f.py", 3, "mirror-skew", "m", "s")]}
    want = ref.analysis.main._summary(
        {"mirror": [ref.analysis.common.Finding("f.py", 3, "mirror-skew",
                                                "m", "s")]})
    assert cli._summary(fake) == want
    assert set(got) == set(want)
    assert got["total_findings"] == 0
    assert sorted(got["passes"]) == ["dtypes", "mirror", "retrace", "twin"]
    for p in got["passes"].values():
        assert p == {"findings": 0, "rules": {}}


def test_cli_exits_1_on_a_planted_fault(engine_copy, tmp_path, monkeypatch):
    _edit(engine_copy / "macro.py",
          'over_j = _f64(lat_j > sc["lat_target"])',
          'over_j = _f64(lat_j >= sc["lat_target"])')
    monkeypatch.setattr(mirror, "_ENGINE", engine_copy)
    out = tmp_path / "analysis.json"
    assert cli.main(["--fail-on-findings", "--pass", "mirror",
                     "--json", str(out)]) == 1
    got = json.loads(out.read_text())
    assert got["total_findings"] == 1
    assert got["passes"]["mirror"]["rules"] == {"mirror-skew": 1}
    assert cli.main(["--pass", "mirror"]) == 0      # report-only mode


def test_cli_crashed_pass_is_a_finding(monkeypatch, tmp_path):
    def broken():
        raise RuntimeError("boom")
    monkeypatch.setitem(cli.PASSES, "twin", broken)
    out = tmp_path / "analysis.json"
    assert cli.main(["--fail-on-findings", "--pass", "twin",
                     "--json", str(out)]) == 1
    got = json.loads(out.read_text())
    assert got["findings"][0]["rule"] == "twin-pass-error"
    assert "RuntimeError: boom" in got["findings"][0]["message"]


def test_analysis_imports_no_jax_and_no_repro():
    """Statically: no module of the package imports ``jax`` or ``repro``;
    and in a fresh process a full run loads neither."""
    pkg = ROOT / "src" / "repro_torch" / "analysis"
    for path in sorted(pkg.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (path, n)
    code = ("import sys, repro_torch.analysis as A\n"
            "from repro_torch.analysis import __main__, sweeps\n"
            "assert A.run_all() and __main__.main(['--pass', 'mirror']) == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
