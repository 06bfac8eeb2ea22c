"""Protocol-invariant static analyzer for the port's registry/store tree
(a copy of ``repro/analysis`` pointed at ``src/repro_torch``).

Pure-``ast`` (never imports the analyzed code), stdlib-only, seconds to
run: it needs neither torch nor jax.  See ``rules.RULES`` for the five
contracts (R1-R5) and ``python -m repro_torch.analysis --explain R2`` for
the historical bug behind each one.  Findings diff against
``baseline.json`` (fingerprint-keyed, reasoned suppressions); ``--check``
fails on any NEW finding and on any stale suppression.

R1's test index is the port's own tests (``tests/test_torch_*.py``): a
fault point that only the JAX package's tests drive is not covered here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .ast_utils import ModuleIndex, index_module
from .findings import Finding, sort_findings
from .rules import CRASH_SEAM_ALLOWLIST, RULES, RuleContext, SeamExemption

__all__ = [
    "AnalysisConfig", "run_analysis", "RULES", "Finding",
    "CRASH_SEAM_ALLOWLIST", "SeamExemption",
]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclass
class AnalysisConfig:
    src_root: str
    display_root: str
    tests_root: str | None = None
    # file-name pattern of the test modules R1 reads under tests_root
    tests_glob: str = "*.py"
    chaos_path: str | None = None
    baseline_path: str | None = None
    # None => every scanned module is in R2 scope (fixture mode).
    protocol_dirs: tuple[str, ...] | None = None
    # Dirs (relative to src_root) where '# noqa: BLE001' must map to an
    # allowlist entry.  Empty => noqa consistency not enforced.
    ble_dirs: tuple[str, ...] = ()
    allowlist: tuple[SeamExemption, ...] = ()
    exclude_dirs: tuple[str, ...] = ("__pycache__", "analysis")

    @classmethod
    def for_repo(cls) -> "AnalysisConfig":
        src_root = os.path.dirname(_PKG_DIR)            # src/repro_torch
        repo_root = os.path.dirname(os.path.dirname(src_root))
        tests = os.path.join(repo_root, "tests")
        chaos = os.path.join(src_root, "ft", "chaos.py")
        return cls(
            src_root=src_root,
            display_root=repo_root,
            tests_root=tests if os.path.isdir(tests) else None,
            tests_glob="test_torch_*.py",
            chaos_path=chaos if os.path.exists(chaos) else None,
            baseline_path=os.path.join(_PKG_DIR, "baseline.json"),
            protocol_dirs=("core", "ft", "serve", "ckpt"),
            ble_dirs=("core", "ft", "serve"),
            allowlist=CRASH_SEAM_ALLOWLIST,
        )


def run_analysis(config: AnalysisConfig,
                 rules: tuple[str, ...] | None = None) -> list[Finding]:
    src = ModuleIndex(config.src_root, config.display_root,
                      exclude_dirs=config.exclude_dirs)
    tests = None
    if config.tests_root and os.path.isdir(config.tests_root):
        tests = ModuleIndex(
            config.tests_root, config.display_root,
            exclude_dirs=config.exclude_dirs + ("fixtures",),
            file_glob=config.tests_glob)
    chaos = None
    if config.chaos_path and os.path.exists(config.chaos_path):
        ap = os.path.abspath(config.chaos_path)
        chaos = index_module(
            ap,
            os.path.relpath(ap, config.display_root),
            os.path.relpath(ap, config.src_root))

    ctx = RuleContext(config, src, tests, chaos)
    findings: list[Finding] = []
    for rule_id, rule in sorted(RULES.items()):
        if rules is not None and rule_id not in rules:
            continue
        findings.extend(rule.check(ctx))
    return sort_findings(findings)
