"""Finding: one protocol-invariant violation, stably fingerprinted.

A finding is anchored by ``(rule, path, anchor)`` — *not* by line number —
so the fingerprint survives unrelated edits above the violation.  The
anchor is the enclosing qualified name (``RelayNode._fan_children``) or,
for coverage rules, the fault-point name itself (``chaos-missing:wire.commit``).
Line numbers are carried for display only.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    rule: str       # "R1".."R5"
    severity: str   # "error" | "warning"
    path: str       # display-root-relative module path
    line: int       # 1-based, display only (not part of the fingerprint)
    anchor: str     # line-independent anchor within the module
    message: str

    @property
    def fingerprint(self) -> str:
        raw = f"{self.rule}|{self.path}|{self.anchor}".encode()
        return hashlib.sha256(raw).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "anchor": self.anchor,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.rule} {self.severity:<7} {self.path}:{self.line} "
                f"[{self.anchor}] {self.message}")


def sort_findings(findings: list[Finding]) -> list[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.anchor))
