"""On the card: one short run of each cell through the command, its last
line the result the benchmark contract asks for. Skips without a CUDA
device; run with ``python -m pytest bench/tests/test_bench_card.py`` on
the card's machine."""
import json
import subprocess
import sys

import pytest

from bench import spec
from bench.tests.tiny import ROOT

CELLS = [w["name"] for w in spec.declaration()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_prints_a_correct_result(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"] for m in
                                    spec.declaration()[kind]}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
