"""The port's protocol-invariant analyzer (``repro_torch.analysis``, a copy
of ``repro.analysis`` pointed at ``src/repro_torch``) on the reference's
fixtures: each rule flags its violating tree and stays silent on the clean
twin, with exactly the findings the JAX package's analyzer gives on the
same tree. Then the committed self-scan gate over the port's tree, whose
R1 test index is the port's own tests (``tests/test_torch_*.py``): no R1
finding is left, and the baseline holds only the scrub cursor's R3
suppression, the reference's reasoned one."""
import json
import os
import subprocess
import sys

import pytest

from repro import analysis as ja
from repro_torch import analysis as ta
from repro_torch.analysis.baseline import diff, load_baseline

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_TREES = sorted(os.listdir(FIXTURES))

#: anchors (or anchor prefixes: R5's unlocked anchor embeds a line number)
#: every violating fixture must produce, and nothing but these
EXPECTED_ANCHORS = {
    "R1": {"chaos-missing:wire.recv", "test-missing:wire.recv",
           "dead-spec:ghost.point"},
    "R2": {"swallow:pull"},
    "R3": {"undominated-write:publish"},
    "R4": {"unleased-retention:cleanup:remove_image"},
    "R5": {"stale-holdings:LayerStore.remove_tag",
           "unlocked-holdings:LayerStore.note_holding"},
}


def fixture_cfg(pkg, name: str):
    root = os.path.join(FIXTURES, name)
    tests = os.path.join(root, "tests")
    chaos = os.path.join(root, "chaos.py")
    return pkg.AnalysisConfig(
        src_root=os.path.join(root, "src"),
        display_root=root,
        tests_root=tests if os.path.isdir(tests) else None,
        chaos_path=chaos if os.path.exists(chaos) else None,
    )


def run_rule(name: str, rule: str):
    return ta.run_analysis(fixture_cfg(ta, name), rules=(rule,))


def test_rule_registry_is_the_references():
    assert sorted(ta.RULES) == sorted(ja.RULES) == ["R1", "R2", "R3", "R4",
                                                     "R5"]
    for rid, rule in ta.RULES.items():
        ref = ja.RULES[rid]
        assert (rule.title, rule.severity) == (ref.title, ref.severity)
        assert rule.contract and rule.motivation and rule.severity


@pytest.mark.parametrize("name", FIXTURE_TREES)
def test_findings_on_each_fixture_equal_the_references(name):
    got = ta.run_analysis(fixture_cfg(ta, name))
    want = ja.run_analysis(fixture_cfg(ja, name))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


@pytest.mark.parametrize("rule", sorted(EXPECTED_ANCHORS))
def test_rule_flags_violating_fixture(rule):
    findings = run_rule(f"{rule.lower()}_bad", rule)
    anchors = {f.anchor for f in findings}
    for want in EXPECTED_ANCHORS[rule]:
        assert any(a == want or a.startswith(want + ":") for a in anchors), \
            f"{rule} missed {want!r}; got {sorted(anchors)}"
    for got in anchors:
        assert any(got == w or got.startswith(w + ":")
                   for w in EXPECTED_ANCHORS[rule]), \
            f"{rule} over-reported {got!r}"
    assert all(f.rule == rule for f in findings)


@pytest.mark.parametrize("rule", sorted(EXPECTED_ANCHORS))
def test_rule_passes_clean_fixture(rule):
    findings = run_rule(f"{rule.lower()}_clean", rule)
    assert findings == [], [f.render() for f in findings]


def test_fingerprints_anchor_not_line():
    a = run_rule("r2_bad", "R2")
    assert len(a) == 1
    f = a[0]
    clone = type(f)(f.rule, f.severity, f.path, f.line + 40, f.anchor,
                    "different message")
    assert clone.fingerprint == f.fingerprint


def test_repo_config_names_the_ports_tree_and_tests():
    cfg = ta.AnalysisConfig.for_repo()
    ref = ja.AnalysisConfig.for_repo()
    assert cfg.src_root == os.path.join(REPO_ROOT, "src", "repro_torch")
    assert cfg.tests_glob == "test_torch_*.py"
    assert (cfg.protocol_dirs, cfg.ble_dirs) == (ref.protocol_dirs,
                                                 ref.ble_dirs)
    assert [e.where for e in cfg.allowlist] == [
        e.where.replace("src/repro/", "src/repro_torch/", 1)
        for e in ref.allowlist]


def test_self_scan_matches_committed_baseline():
    """The gate itself, in-process: a full 5-rule run over src/repro_torch
    gives no finding that is not a reasoned suppression in the committed
    baseline, which holds the R3 scrub-cursor entry alone."""
    cfg = ta.AnalysisConfig.for_repo()
    findings = ta.run_analysis(cfg)
    baseline = load_baseline(cfg.baseline_path)
    new, suppressed, stale, unreasoned = diff(findings, baseline)
    assert new == [], [f.render() for f in new]
    assert stale == [] and unreasoned == []
    assert [(e["rule"], e["path"], e["anchor"]) for e in baseline.values()] \
        == [("R3", "src/repro_torch/ft/scrub.py",
             "undominated-write:save_cursor")]


def test_port_fault_point_coverage_is_closed_by_port_tests():
    """R1 with the port's own tests as the index: every fault point has
    chaos and test coverage and no spec is dead. With the whole tests/
    directory as the index the reference's tests would vouch for the
    port's seams; the index is the port's tests alone."""
    cfg = ta.AnalysisConfig.for_repo()
    assert ta.run_analysis(cfg, rules=("R1",)) == []
    cfg.tests_glob = "*.py"
    anchors = {f.anchor for f in ta.run_analysis(cfg, rules=("R1",))}
    assert anchors == {"dead-spec:x", "dead-spec:y"}      # tests/test_chaos.py


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300)


def test_cli_check_fails_on_violating_tree(tmp_path):
    out_json = str(tmp_path / "findings.json")
    r = _cli("--root", os.path.join(FIXTURES, "r2_bad"), "--rules", "R2",
             "--check", "--json", out_json)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "NEW" in r.stdout and "swallow:pull" in r.stdout
    report = json.load(open(out_json))
    assert report["new"] and report["findings"]


def test_cli_check_passes_clean_tree_and_repo():
    r = _cli("--root", os.path.join(FIXTURES, "r2_clean"), "--rules",
             "R2", "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "check: clean" in r.stdout
    full = _cli("--check")
    assert full.returncode == 0, full.stdout + full.stderr
    assert "check: clean" in full.stdout and "1 suppressed" in full.stdout


def test_cli_explain_every_rule():
    for rule_id in ta.RULES:
        r = _cli("--explain", rule_id)
        assert r.returncode == 0
        assert "CONTRACT" in r.stdout and "MOTIVATING BUG" in r.stdout
    assert _cli("--explain", "R9").returncode == 2
