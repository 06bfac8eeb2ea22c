"""The per-layer metrics that read the port's own spans
(``bench/program_spans.py``): each reads a value from a tiny traced run on
the CPU, and nothing from spans that lie outside the run's own spans; and
every declared per-layer entry keeps the declaration's rules."""
import time

import pytest

from bench import program_spans, spec
from bench.harness import run_cell
from bench.tests.test_bench_declaration import NAME, UNIT
from bench.tests.tiny import overrides
from bench.trace import Recorder, Trace

DECL = spec.declaration()
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


# the metrics declared to read the port's spans (or their attributes)
METRICS = [(w["name"], m["name"]) for w in DECL["workloads"]
           for m in spec.per_layer(DECL, w["name"])
           if m["source"] == "program_span"]
CELLS = sorted({cell for cell, _ in METRICS})
UNITS = {m["name"]: m["unit"] for m in DECL["per_layer"]}
LAUNCHES = [(cell, m) for cell, m in METRICS if UNITS[m] == "launches"]


def _traced_tiny_run(cell):
    res, ctx = run_cell(cell, 3000000001, 0.6, True, "cpu",
                        time.perf_counter(), decl=DECL,
                        overrides=overrides(cell))
    assert res["correct"], res["checks"]
    return Trace(ctx.rec, ctx.window.seconds), res["metrics"]


@pytest.fixture(scope="module")
def runs():
    """One tiny traced run of each cell -> (its trace, its metrics)."""
    return {cell: _traced_tiny_run(cell) for cell in CELLS}


@pytest.mark.parametrize("entry", DECL["per_layer"], ids=lambda e: e["name"])
def test_per_layer_entry_keeps_the_declarations_rules(entry):
    e2e = {m["name"] for m in DECL["end_to_end"]}
    names = [m["name"] for m in DECL["end_to_end"] + DECL["per_layer"]]
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert names.count(entry["name"]) == 1
    assert entry["source"] in SOURCES
    assert entry["better"] in ("lower", "higher")
    assert 1 <= len(entry["layer"]) <= 200 and "\n" not in entry["layer"]
    assert entry["moves"] in e2e
    for cell in entry.get("workloads", [w["name"] for w in DECL["workloads"]]):
        spec.cell(DECL, cell)
        assert entry["moves"] in {m["name"] for m in
                                  spec.end_to_end(DECL, cell)}
    assert callable(spec.reader(entry["name"]).read)


@pytest.mark.parametrize("cell,metric", METRICS)
def test_reader_reads_a_tiny_traced_run(runs, cell, metric):
    trace, metrics = runs[cell]
    got = spec.reader(metric).read(trace)
    assert got is not None and got >= 0
    if UNITS[metric] != "launches":
        # a count of kernel launches reads 0 on the CPU's plain route;
        # test_launches_read_one_a_layer_on_the_kernels_route counts them
        assert got > 0
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
    steps = overrides("yi-6b.serve")["traffic"]["new_tokens"]
    assert len(program_spans.spans(trace, "engine.prefill")) == batches
    assert len(program_spans.spans(trace, "engine.decode_step")) == \
        batches * steps


class _Counted:
    """Stands in for the flash kernel's entry point on the CPU: counts
    each call in ``launches`` and runs the real one (its plain version)."""

    def __init__(self, real):
        self.real = real
        self.launches = 0

    def __call__(self, *a, **k):
        self.launches += 1
        return self.real(*a, **k)


@pytest.mark.parametrize("cell,metric", LAUNCHES)
def test_launches_read_one_a_layer_on_the_kernels_route(monkeypatch, cell,
                                                        metric):
    """With the kernel's route taken on the CPU (its device type set to
    the CPU's, every head dim taken), each prefill launches it once a
    layer, and the reader reads that."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(flash_ops, "takes", lambda q, k, v: True)
    monkeypatch.setattr(flash_ops, "flash_attention",
                        _Counted(flash_ops.flash_attention))
    trace, metrics = _traced_tiny_run(cell)
    layers = overrides(cell)["config"]["num_hidden_layers"]
    assert flash_ops.flash_attention.launches > 0
    assert spec.reader(metric).read(trace) == layers
    assert metrics[metric]["value"] == layers


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
