"""CLI for the port's protocol-invariant analyzer.

    PYTHONPATH=src python -m repro_torch.analysis               # report
    PYTHONPATH=src python -m repro_torch.analysis --check       # gate
    PYTHONPATH=src python -m repro_torch.analysis --explain R2  # contract + bug
    PYTHONPATH=src python -m repro_torch.analysis --json out.json

``--check`` exits non-zero on any NEW finding, any STALE baseline
suppression, or any suppression without a reason.  ``--root DIR`` scans
an arbitrary tree (used by the fixture tests) with fixture-mode
defaults: every module in R2 scope, no allowlist, no baseline.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import AnalysisConfig, RULES, run_analysis
from .baseline import diff, load_baseline, write_baseline


def _explain(rule_id: str) -> int:
    rule = RULES.get(rule_id.upper())
    if rule is None:
        print(f"unknown rule {rule_id!r}; known: {', '.join(sorted(RULES))}")
        return 2
    print(f"{rule.id} — {rule.title} [{rule.severity}]")
    print()
    print("CONTRACT")
    print(f"  {rule.contract}")
    print()
    print("MOTIVATING BUG")
    print(f"  {rule.motivation}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.analysis")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero on new/stale/unreasoned findings")
    p.add_argument("--explain", metavar="RULE",
                   help="print a rule's contract and motivating bug")
    p.add_argument("--json", metavar="PATH",
                   help="write the full findings report as JSON")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline "
                        "(reasons must then be filled in by hand)")
    p.add_argument("--root", help="scan this tree instead of "
                                  "src/repro_torch "
                                  "(fixture mode: no allowlist/baseline)")
    p.add_argument("--tests-root", help="tests dir for R1 coverage")
    p.add_argument("--chaos", help="chaos module for R1 coverage")
    p.add_argument("--baseline", help="baseline path override")
    p.add_argument("--rules", help="comma-separated rule subset, e.g. R1,R3")
    args = p.parse_args(argv)

    if args.explain:
        return _explain(args.explain)

    if args.root:
        cfg = AnalysisConfig(
            src_root=os.path.abspath(args.root),
            display_root=os.path.abspath(args.root),
            tests_root=args.tests_root,
            chaos_path=args.chaos,
            baseline_path=args.baseline,
        )
    else:
        cfg = AnalysisConfig.for_repo()
        if args.tests_root:
            cfg.tests_root = args.tests_root
        if args.chaos:
            cfg.chaos_path = args.chaos
        if args.baseline:
            cfg.baseline_path = args.baseline

    rules = tuple(r.strip().upper()
                  for r in args.rules.split(",")) if args.rules else None
    findings = run_analysis(cfg, rules=rules)
    baseline = load_baseline(cfg.baseline_path)
    new, suppressed, stale, unreasoned = diff(findings, baseline)

    if args.json:
        report = {
            "findings": [f.to_dict() for f in findings],
            "new": [f.fingerprint for f in new],
            "suppressed": [f.fingerprint for f in suppressed],
            "stale_suppressions": stale,
            "unreasoned_suppressions": unreasoned,
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if args.write_baseline:
        if not cfg.baseline_path:
            print("no baseline path configured")
            return 2
        write_baseline(cfg.baseline_path, findings)
        print(f"wrote {len(findings)} suppression(s) to "
              f"{cfg.baseline_path} — fill in the reasons")
        return 0

    for f in new:
        print(f"NEW        {f.render()}  [fp {f.fingerprint}]")
    for f in suppressed:
        print(f"suppressed {f.render()}  [fp {f.fingerprint}]")
    for e in stale:
        print(f"STALE      {e['rule']} {e['path']} [{e['anchor']}] — "
              f"suppression no longer matches any finding "
              f"[fp {e['fingerprint']}]")
    for e in unreasoned:
        print(f"UNREASONED {e['rule']} {e['path']} [{e['anchor']}] — "
              f"suppression has no reason [fp {e['fingerprint']}]")

    n_rules = len(rules) if rules else len(RULES)
    print(f"\nanalysis: {n_rules} rule(s), {len(findings)} finding(s) "
          f"({len(new)} new, {len(suppressed)} suppressed, "
          f"{len(stale)} stale, {len(unreasoned)} unreasoned)")

    if args.check and (new or stale or unreasoned):
        print("check: FAIL")
        return 1
    if args.check:
        print("check: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
