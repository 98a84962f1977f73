"""CLI for the port's static invariant analysis (runs on the host).

    PYTHONPATH=src python -m repro_torch.analysis [options]

Options:
    --fail-on-findings   exit 1 when any finding survives (CI mode)
    --json PATH          write a machine-readable summary
    --pass NAME          run a single pass (repeatable); default: all
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.analysis import PASSES, run_pass
from repro_torch.analysis.common import Finding


def _summary(results: Dict[str, List[Finding]]) -> dict:
    passes = {}
    for name, findings in results.items():
        rules: Dict[str, int] = {}
        for f in findings:
            rules[f.rule] = rules.get(f.rule, 0) + 1
        passes[name] = {
            "findings": len(findings),
            "rules": dict(sorted(rules.items())),
        }
    return {
        "total_findings": sum(len(v) for v in results.values()),
        "passes": passes,
        "findings": [
            {"pass": name, "file": f.file, "line": f.line,
             "rule": f.rule, "message": f.message,
             "suggestion": f.suggestion}
            for name, findings in results.items() for f in findings
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant analysis over the port's engine, "
                    "its oracle and the cell-scan kernel's operand tables")
    parser.add_argument("--fail-on-findings", action="store_true",
                        help="exit 1 when any finding survives")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="write the findings summary as JSON")
    parser.add_argument("--pass", dest="passes", action="append",
                        choices=sorted(PASSES), default=None,
                        help="run only this pass (repeatable)")
    args = parser.parse_args(argv)

    names = args.passes or list(PASSES)
    results: Dict[str, List[Finding]] = {}
    for name in names:
        try:
            results[name] = run_pass(name)
        except Exception as e:  # a crashed pass is itself a finding
            results[name] = [Finding(
                file="<analysis>", line=0, rule=f"{name}-pass-error",
                message=f"pass crashed: {type(e).__name__}: {e}",
                suggestion="fix the pass (repro_torch/analysis) or "
                           "the contract it checks")]

    total = 0
    for name in names:
        findings = results[name]
        total += len(findings)
        status = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"analysis: {name}: {status}")
        for f in findings:
            print(f"  {f.render()}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(_summary(results), fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"analysis: wrote {args.json}")

    if total:
        print(f"analysis: {total} finding(s) across "
              f"{sum(1 for n in names if results[n])} pass(es)",
              file=sys.stderr)
        return 1 if args.fail_on_findings else 0
    print(f"analysis: all {len(names)} pass(es) clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
