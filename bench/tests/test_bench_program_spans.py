"""The per-layer metrics that read the port's own spans
(``bench/program_spans.py``): each reads a value from a tiny traced run on
the CPU, and nothing from spans that lie outside the run's own spans.

``BENCHMARK.json`` does not declare them yet: declaring one adds a case to
the parametrized reader tests of ``test_bench_metrics.py``, which need an
``expect`` entry in ``fixtures/trace_small.json`` for it. ``PENDING`` holds
the entries a benchmark change would append; the tiny runs here use the
declaration with them appended, as the harness then would."""
import time

import pytest

from bench import program_spans, spec
from bench.harness import run_cell
from bench.tests.test_bench_declaration import NAME, UNIT
from bench.tests.tiny import TINY
from bench.trace import Recorder, Trace


def _entry(name, unit, layer, moves, cell, source="host_clock"):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": [cell]}


_SERVE, _DEPLOY = "yi-6b.serve", "minicpm3-4b.deploy"
_STORE, _FOLLOW = "checkpoint manager and store", "follower and registry"
PENDING = [
    _entry("prefill_ms.serve", "ms", "engine", "serve_tokens_per_s", _SERVE),
    _entry("decode_step_ms.serve", "ms", "engine", "serve_tokens_per_s",
           _SERVE),
    _entry("decode_dispatch_share.serve", "%", "engine",
           "serve_tokens_per_s", _SERVE),
    _entry("decode_dispatch_share.deploy", "%", "engine",
           "serve_tokens_per_s.deploy", _DEPLOY),
    _entry("detect_ms.deploy", "ms", _STORE, "deploy_s", _DEPLOY),
    _entry("inject_ms.deploy", "ms", _STORE, "deploy_s", _DEPLOY),
    _entry("flush_ms.deploy", "ms", _STORE, "deploy_s", _DEPLOY),
    _entry("retain_ms.deploy", "ms", _STORE, "deploy_s", _DEPLOY),
    _entry("pull_ms.deploy", "ms", _FOLLOW, "deploy_s", _DEPLOY),
    _entry("verify_ms.deploy", "ms", _FOLLOW, "deploy_s", _DEPLOY),
    _entry("load_ms.deploy", "ms", _FOLLOW, "deploy_s", _DEPLOY),
    _entry("refresh_ms.deploy", "ms", _FOLLOW, "deploy_s", _DEPLOY),
    _entry("refreshed_per_changed.deploy", "ratio", _FOLLOW, "deploy_s",
           _DEPLOY, source="program_counter"),
    _entry("verified_per_changed.deploy", "ratio", _FOLLOW, "deploy_s",
           _DEPLOY, source="program_counter"),
]
READERS = {cell: [m["name"] for m in PENDING if m["workloads"] == [cell]]
           for cell in (_SERVE, _DEPLOY)}
METRICS = [(cell, m) for cell, ms in READERS.items() for m in ms]


def _declaration():
    decl = spec.declaration()
    return {**decl, "per_layer": decl["per_layer"] + PENDING}


@pytest.fixture(scope="module")
def runs():
    """One tiny traced run of each cell -> (its trace, its metrics)."""
    out = {}
    for cell in READERS:
        res, ctx = run_cell(cell, 3000000001, 0.6, True, "cpu",
                            time.perf_counter(), decl=_declaration(),
                            overrides=TINY[cell])
        assert res["correct"]
        out[cell] = (Trace(ctx.rec, ctx.window.seconds), res["metrics"])
    return out


@pytest.mark.parametrize("entry", PENDING, ids=lambda e: e["name"])
def test_pending_entry_keeps_the_declarations_rules(entry):
    decl = spec.declaration()
    layer_names = {m["name"] for m in decl["end_to_end"] + decl["per_layer"]}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["name"] not in layer_names
    assert entry["layer"] in {m["layer"] for m in decl["per_layer"]}
    (cell,) = entry["workloads"]
    assert entry["moves"] in {m["name"] for m in spec.end_to_end(decl, cell)}
    assert callable(spec.reader(entry["name"]).read)


@pytest.mark.parametrize("cell,metric", METRICS)
def test_reader_reads_a_tiny_traced_run(runs, cell, metric):
    trace, metrics = runs[cell]
    got = spec.reader(metric).read(trace)
    assert got is not None and got > 0
    assert metrics[metric]["value"] == pytest.approx(got)
    if "share" in metric:
        assert got <= 100
    if metric.endswith("_ms.serve") or metric.endswith("_ms.deploy"):
        # a stage is a part of the benchmark span around its call
        outer = "generate" if metric.startswith(("prefill", "decode")) \
            else ("save" if metric.startswith(
                ("detect", "inject", "flush", "retain")) else "follow")
        assert got <= max(trace.durations(outer)) * 1e3


def test_the_deploy_stages_add_up(runs):
    trace, _ = runs["minicpm3-4b.deploy"]
    n = len(trace.durations("save"))
    for name in ("ckpt.save", "ckpt.detect", "store.inject", "store.flush",
                 "ckpt.retain", "follower.sync", "follower.pull",
                 "follower.verify", "follower.load", "engine.refresh"):
        assert len(program_spans.spans(trace, name)) == n, name
    # the replica re-hashes and loads the changed leaves and each save's
    # int32 step, and puts the leaves (not the step) on the device
    refreshed = spec.reader("refreshed_per_changed.deploy").read(trace)
    verified = spec.reader("verified_per_changed.deploy").read(trace)
    assert 1 <= refreshed < verified


def test_each_batch_has_one_prefill_and_its_decode_steps(runs):
    trace, _ = runs["yi-6b.serve"]
    batches = len(trace.durations("generate"))
    steps = TINY["yi-6b.serve"]["traffic"]["new_tokens"]
    assert len(program_spans.spans(trace, "engine.prefill")) == batches
    assert len(program_spans.spans(trace, "engine.decode_step")) == \
        batches * steps


@pytest.mark.parametrize("cell,metric", METRICS)
def test_reader_ignores_spans_outside_the_runs_own(runs, cell, metric):
    trace, _ = runs[cell]
    rec = Recorder()
    # the same counters, but the run's spans moved an hour earlier: the
    # port's spans of the run lie outside them
    rec.spans = [(n, t0 - 3600.0, t1 - 3600.0) for n, t0, t1 in
                 trace._rec.spans]
    rec.counters.update(trace.counters)
    assert spec.reader(metric).read(Trace(rec, trace.window_s)) is None
