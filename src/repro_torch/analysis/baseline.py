"""Baseline diffing: fingerprint-keyed, reasoned suppressions.

``baseline.json`` holds the findings the tree has consciously accepted —
each entry MUST carry a non-empty ``reason``.  ``--check`` fails on:

* **new** findings (present in the tree, absent from the baseline),
* **stale** suppressions (baselined fingerprint no longer produced —
  the debt was paid; the entry must be deleted in the same PR),
* **unreasoned** suppressions (entry without a reason string).

Fingerprints anchor on ``(rule, path, qualname-or-point)`` — not line
numbers — so unrelated edits never churn the baseline.
"""
from __future__ import annotations

import json
import os

from .findings import Finding

VERSION = 1


def load_baseline(path: str | None) -> dict[str, dict]:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("suppressions", [])
    return {e["fingerprint"]: e for e in entries}


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [dict(f.to_dict(), reason="TODO: justify this suppression")
               for f in findings]
    payload = {"version": VERSION, "suppressions": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def diff(findings: list[Finding], baseline: dict[str, dict]):
    """-> (new_findings, suppressed_findings, stale_entries, unreasoned)."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    seen: set[str] = set()
    for f in findings:
        seen.add(f.fingerprint)
        if f.fingerprint in baseline:
            suppressed.append(f)
        else:
            new.append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in seen]
    unreasoned = []
    for fp, e in sorted(baseline.items()):
        if fp not in seen:
            continue
        reason = str(e.get("reason", "")).strip()
        if not reason or reason.startswith("TODO"):
            unreasoned.append(e)
    return new, suppressed, stale, unreasoned
