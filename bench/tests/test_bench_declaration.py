"""BENCHMARK.json resolves by name to the benchmark's files, and keeps the
benchmark contract's shape rules."""
import json
import os
import re

import pytest

from bench import spec
from bench.tests.tiny import ROOT

DECL = spec.declaration()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DECL["workloads"]]


def test_top_level_keys_and_paths():
    assert set(DECL) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DECL["paths"] == ["bench"]
    assert DECL["command"] == ["python3", "bench/run.py"]
    assert 1 <= DECL["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in DECL[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in DECL[kind]}) == len(DECL[kind])
    metrics = DECL["end_to_end"] + DECL["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DECL["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DECL["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in DECL["end_to_end"]}
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = spec.cell(DECL, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    conf = spec.config(DECL, w["config"])
    mix = spec.traffic(w["traffic"])
    assert callable(spec.driver(mix).run)
    ref, flops = spec.family(conf)
    assert callable(ref.hidden) and callable(flops.serve_flops)
    assert spec.limits(cell)
    e2e = {m["name"] for m in spec.end_to_end(DECL, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(DECL, cell)
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]).read)
        # the metric moves an end-to-end metric that this cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("entry", DECL["configs"], ids=lambda e: e["name"])
def test_config_file_is_what_the_port_runs(entry):
    """The file's sizes are the port's (the weight layout is checked
    against the port's parameter tree at full width, on the meta
    device)."""
    from bench.harness import port_config
    conf = spec.config(DECL, entry["name"])
    assert entry["file"].startswith("bench/configs/")
    assert conf["source"] == entry["source"]
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    widths = re.compile(r"(size|_dim|_rank|heads|head_dim|experts_per_tok)$")
    assert not [k for k in entry["reduced"] if widths.search(k)]
    cfg = port_config(conf)
    assert cfg.n_layers == conf["num_hidden_layers"]
    assert cfg.d_model == conf["hidden_size"]


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A cell, configuration, mix and metric added as files and entries
    resolve without an edit to any file that is there."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True)
    with open(os.path.join(ROOT, "bench/configs/yi-6b.json")) as f:
        conf = json.load(f)
    (bench / "configs" / "new-model.json").write_text(json.dumps(conf))
    (bench / "traffic" / "new_mix.json").write_text(json.dumps(
        {**spec.traffic("long_docs"), "clients": 4}))
    (bench / "limits" / "new-model.new_mix.json").write_text(
        json.dumps({"served_logit_gap": 1.0}))
    (bench / "metrics" / "tokens.new.py").write_text(
        "def read(trace):\n    return trace.counters.get('tokens')\n")
    decl = json.loads(json.dumps(DECL))
    decl["configs"].append({**decl["configs"][1], "name": "new-model",
                            "file": "bench/configs/new-model.json"})
    decl["workloads"].append({"name": "new-model.new_mix",
                              "config": "new-model", "traffic": "new_mix",
                              "chips": 1, "why": "a test"})
    decl["per_layer"].append({"name": "tokens.new", "unit": "tokens",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine",
                              "moves": "serve_tokens_per_s",
                              "workloads": ["new-model.new_mix"]})
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    monkeypatch.setattr(spec, "BENCH", str(bench))
    assert spec.config(decl, "new-model")["arch"] == "yi-6b"
    assert spec.traffic("new_mix")["clients"] == 4
    assert spec.limits("new-model.new_mix") == {"served_logit_gap": 1.0}
    names = [m["name"] for m in spec.per_layer(decl, "new-model.new_mix")]
    assert "tokens.new" in names
    assert spec.reader("tokens.new").read(
        type("T", (), {"counters": {"tokens": 7}})()) == 7
