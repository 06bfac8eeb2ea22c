"""BENCHMARK.json resolves by name to the benchmark's files, and keeps the
benchmark contract's shape rules; every key of a configuration file is
applied or described; a new configuration, mix, cell and metric need new
files and appended entries alone."""
import hashlib
import json
import os
import re
import shutil

import pytest

from bench import spec
from bench.tests import tiny
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


def test_every_declared_cell_and_family_has_its_tiny_files():
    assert tiny.missing_files() == []


@pytest.mark.parametrize("entry", DECL["configs"], ids=lambda e: e["name"])
def test_every_config_key_is_applied_or_described(entry):
    from bench.harness import port_fields
    try:
        port_fields(spec.config(DECL, entry["name"]))
    except ValueError as e:
        pytest.fail(f"{entry['file']}: {e}")


@pytest.mark.parametrize("extra,match", [
    ({"attention_bias": False}, r"\['attention_bias'\] set no ModelConfig "
                                r"field and are not described"),
    ({"descriptive": {"hidden_size": "the width"}},
     r"\['hidden_size'\] are applied to ModelConfig and listed as "
     r"descriptive"),
    ({"descriptive": {"attention_bias": ""}, "attention_bias": False},
     "needs its reason"),
    ({"tie_word_embeddings": True}, "tie_word_embeddings must be false"),
    ({"sliding_window": 4096, "use_sliding_window": False},
     "sliding_window covers only some layers"),
    ({"sliding_window": 4096, "max_window_layers": 28,
      "descriptive": {"max_window_layers": "layers past it use the window"}},
     "sliding_window covers only some layers"),
    ({"sliding_window": 4096, "descriptive": {"layer_types": "per layer"},
      "layer_types": ["sliding_attention", "full_attention"]},
     "sliding_window covers only some layers"),
    ({"sliding_window": 4096, "model_type": "gemma2"},
     "sliding_window covers only some layers"),
], ids=["undescribed", "applied-and-descriptive", "no-reason", "tied-head",
        "window-off", "window-layers", "window-pattern", "window-alternating"])
def test_a_config_the_port_would_not_run_as_stated_is_refused(extra, match):
    """Refused on every run, by ``port_config``, before anything is built."""
    from bench.harness import port_config, port_fields
    conf = {**spec.config(DECL, "yi-6b"), **extra}
    with pytest.raises(ValueError, match=match):
        port_fields(conf)
    with pytest.raises(ValueError, match=match):
        port_config(conf)


def test_a_window_over_every_layer_is_applied():
    from bench.harness import port_fields
    conf = {**spec.config(DECL, "yi-6b"), "sliding_window": 4096,
            "use_sliding_window": True}
    assert port_fields(conf)["window"] == 4096
    # a window the file turns off sets none
    conf = {**conf, "sliding_window": None, "use_sliding_window": False}
    assert port_fields(conf)["window"] is None


def test_every_port_field_is_a_model_config_field():
    import dataclasses
    from bench.harness import PORT_FIELDS
    from repro_torch.models.config import ModelConfig
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(PORT_FIELDS.values()) <= known


def test_expert_keys_map_to_the_ports_fields():
    from bench.harness import port_fields
    conf = {"arch": "deepseek-v2-lite", "hidden_size": 2048,
            "n_routed_experts": 64, "num_experts_per_tok": 6,
            "moe_intermediate_size": 1408, "sliding_window": 4096}
    assert port_fields(conf) == {"d_model": 2048, "n_experts": 64,
                                 "top_k": 6, "d_ff_expert": 1408,
                                 "window": 4096}
    assert port_fields({"arch": "mixtral-8x7b", "num_local_experts": 8}) \
        == {"n_experts": 8}


def test_a_port_field_the_port_lacks_is_refused():
    from bench.harness import port_config, port_fields
    conf = {"arch": "yi-6b", "n_shared_experts": 2,
            "port_fields": {"n_shared_experts": "n_shared"}}
    with pytest.raises(ValueError, match="n_shared"):
        port_fields(conf)
    with pytest.raises(ValueError, match="n_shared"):
        port_config({**spec.config(DECL, "yi-6b"), **conf})
    # a field the port has is applied through the file's own map
    assert port_fields({"arch": "yi-6b", "router_aux_loss_coef": 0.02,
                        "port_fields": {"router_aux_loss_coef":
                                        "router_aux_coef"}}) == \
        {"router_aux_coef": 0.02}


def _digests(root) -> dict:
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _write(path, text) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration, a mix, a cell with its tiny sizes, and a per-layer
    metric with its expected reading, added as new files and appended
    entries in BENCHMARK.json: they resolve, the cell's tiny run is
    correct and reads the metric, and the metric reads the recorded trace
    as its file expects, with every file under bench/ as it was."""
    from bench.harness import port_fields
    from bench.tests.test_bench_metrics import (check_recorded_reading,
                                                load_recorded)
    from bench.trace import Recorder, Trace
    real = os.path.join(ROOT, "bench")
    before = _digests(real)
    bench = tmp_path / "bench"
    shutil.copytree(real, bench, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    monkeypatch.setattr(spec, "BENCH", str(bench))

    cell = "new-model.new_mix"
    with open(os.path.join(ROOT, "bench/configs/yi-6b.json")) as f:
        conf = json.load(f)
    conf["attention_bias"] = False
    with pytest.raises(ValueError, match="attention_bias"):
        port_fields(conf)
    conf["descriptive"] = {"attention_bias": "the port's projections have "
                                             "no bias, nor the reference's"}
    assert port_fields(conf) == port_fields(spec.config(DECL, "yi-6b"))
    added = {
        "configs/new-model.json": json.dumps(conf),
        "traffic/new_mix.json": json.dumps(
            {**spec.traffic("long_docs"), "clients": 4,
             "metric_suffix": ".new"}),
        f"limits/{cell}.json": json.dumps({"served_logit_gap": 0.12}),
        "metrics/tokens.new.py":
            "def read(trace):\n    return trace.counters.get('tokens')\n",
        "tests/fixtures/expect/tokens.new.json": "65536\n",
    }
    for rel, text in added.items():
        _write(bench / rel, text)
    decl = json.loads(json.dumps(DECL))
    decl["configs"].append({**decl["configs"][1], "name": "new-model",
                            "file": "bench/configs/new-model.json"})
    decl["workloads"].append({"name": cell, "config": "new-model",
                              "traffic": "new_mix", "chips": 1,
                              "why": "a test"})
    for name, better in (("serve_tokens_per_s.new", "higher"),
                         ("request_p95_s.new", "lower")):
        decl["end_to_end"].append(
            {"name": name, "unit": "tokens/s" if better == "higher" else "s",
             "better": better, "bound": 0.05, "source": "host_clock",
             "workloads": [cell]})
    decl["per_layer"].append({"name": "tokens.new", "unit": "tokens",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine",
                              "moves": "serve_tokens_per_s.new",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(decl))
    assert spec.declaration() == decl
    # until its tiny file is added, the cell's tests name the file
    assert tiny.missing_files(decl) == \
        [f"no tiny sizes: add bench/tests/tiny/{cell}.json"]
    with pytest.raises(FileNotFoundError, match=f"tests/tiny/{cell}.json"):
        tiny.overrides(cell, decl)
    with open(os.path.join(real, "tests/tiny/yi-6b.serve.json")) as f:
        small = json.load(f)
    _write(bench / "tests" / "tiny" / f"{cell}.json", json.dumps(small))
    added[f"tests/tiny/{cell}.json"] = None
    assert tiny.missing_files(decl) == []

    assert spec.config(decl, "new-model")["arch"] == "yi-6b"
    assert spec.traffic("new_mix")["clients"] == 4
    assert spec.limits(cell) == {"served_logit_gap": 0.12}
    assert "tokens.new" in [m["name"] for m in spec.per_layer(decl, cell)]
    out, _ = tiny.tiny_run(cell, decl=decl)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_tokens_per_s.new",
                                   "request_p95_s.new", "setup_s"}
    out, ctx = tiny.tiny_run(cell, traced=True, decl=decl)
    assert out["correct"], out["checks"]
    assert out["metrics"]["tokens.new"]["value"] == ctx.rec.counters["tokens"]
    _, tr, _ = load_recorded(monkeypatch)
    check_recorded_reading("tokens.new", tr)
    assert spec.reader("tokens.new").read(Trace(Recorder(), 1.0, None)) is None

    copy = _digests(bench)
    assert {k: copy[k] for k in before} == before
    assert set(copy) - set(before) == set(added)
    assert _digests(real) == before
