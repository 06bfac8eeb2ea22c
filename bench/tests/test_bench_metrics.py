"""Every per-layer reader on a recorded trace, the device profile's busy
time and idle attribution, and the breakdown's shape.

A declared metric's expected reading on the recorded trace is a file of
its own, ``fixtures/expect/<metric>.json``: a number, or null where the
trace holds nothing for the metric. So declaring a metric adds a file
and edits none."""
import json
import os

import pytest

from bench import spec, trace
from bench.trace import Recorder, Trace

DECL = spec.declaration()


def _fixtures() -> str:
    return os.path.join(spec.BENCH, "tests", "fixtures")


class _Event:
    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e["name"]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.e["device"] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self.e["start"]

    def end_ns(self):
        return self.e["end"]

    def is_user_annotation(self):
        return self.e["ann"]


def load_recorded(monkeypatch):
    """The recorded trace -> (the fixture, its Trace, its device
    profile), with the profiler's events read from the fixture."""
    with open(os.path.join(_fixtures(), "trace_small.json")) as f:
        fx = json.load(f)
    monkeypatch.setattr(trace, "_events",
                        lambda prof: [_Event(e) for e in fx["events"]])
    rec = Recorder()
    rec.spans = [tuple(s) for s in fx["spans"]]
    rec.counters.update(fx["counters"])
    prof = trace.device_profile(None, {s[0] for s in fx["spans"]})
    return fx, Trace(rec, fx["window_s"], prof), prof


@pytest.fixture
def recorded(monkeypatch):
    return load_recorded(monkeypatch)


def expected_reading(metric: str):
    """The metric's expected reading on the recorded trace, from its
    file; a declared metric without one fails, naming the file to add."""
    path = os.path.join(_fixtures(), "expect", f"{metric}.json")
    if not os.path.exists(path):
        pytest.fail(f"{metric} is declared but has no expected reading on "
                    f"the recorded trace: add "
                    f"{os.path.relpath(path, spec.ROOT)} (a number, or "
                    f"null where the trace holds nothing for it)")
    with open(path) as f:
        return json.load(f)


def check_recorded_reading(metric: str, tr) -> None:
    got = spec.reader(metric).read(tr)
    want = expected_reading(metric)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_device_profile_unions_intervals_and_charges_idle_to_spans(recorded):
    fx, _, prof = recorded
    assert prof["window_s"] == pytest.approx(0.1)
    assert prof["busy_s"] == pytest.approx(fx["expect"]["busy_s"])
    assert prof["idle_by_span"] == pytest.approx(fx["expect"]["idle_by_span"])
    assert prof["kernels"]["sm90_gemm_bf16"][0] == 3
    assert "generate" not in prof["kernels"]


def test_breakdown_lists_the_longest(recorded):
    _, _, prof = recorded
    b = trace.breakdown(prof)
    assert b["device_ops"][0][0] == "sm90_gemm_bf16"
    assert b["idle_gaps"][0] == ["generate", pytest.approx(0.022)]
    assert len(b["device_ops"]) <= trace.TOP


@pytest.mark.parametrize("metric", [m["name"] for m in DECL["per_layer"]])
def test_reader_on_the_recorded_trace(recorded, metric):
    _, tr, _ = recorded
    check_recorded_reading(metric, tr)


def test_a_metric_without_an_expect_file_names_the_file(recorded):
    with pytest.raises(pytest.fail.Exception,
                       match="add bench/tests/fixtures/expect/no_such.metric.json"):
        expected_reading("no_such.metric")


@pytest.mark.parametrize("metric", [m["name"] for m in DECL["per_layer"]])
def test_reader_with_nothing_to_read_returns_none(metric):
    assert spec.reader(metric).read(Trace(Recorder(), 1.0, None)) is None
