"""Every per-layer reader on a recorded trace, the device profile's busy
time and idle attribution, and the breakdown's shape."""
import json
import os

import pytest

from bench import spec, trace
from bench.trace import Recorder, Trace

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trace_small.json")
DECL = spec.declaration()


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


@pytest.fixture
def recorded(monkeypatch):
    with open(FIXTURE) as f:
        fx = json.load(f)
    monkeypatch.setattr(trace, "_events",
                        lambda prof: [_Event(e) for e in fx["events"]])
    rec = Recorder()
    rec.spans = [tuple(s) for s in fx["spans"]]
    rec.counters.update(fx["counters"])
    prof = trace.device_profile(None, {s[0] for s in fx["spans"]})
    return fx, Trace(rec, fx["window_s"], prof), prof


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
    fx, tr, _ = recorded
    got = spec.reader(metric).read(tr)
    if metric == "mfu.train":
        assert got is None          # the fixture trains nothing
    else:
        assert got == pytest.approx(fx["expect"][metric])


@pytest.mark.parametrize("metric", [m["name"] for m in DECL["per_layer"]])
def test_reader_with_nothing_to_read_returns_none(metric):
    assert spec.reader(metric).read(Trace(Recorder(), 1.0, None)) is None
