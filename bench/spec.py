"""Everything the harness finds by name: the declaration in
``BENCHMARK.json`` and the files that belong to one configuration, traffic
mix, cell or per-layer metric.

    bench/configs/<config>.json     sizes, source, cuts, precision, store
    bench/traffic/<mix>.json        the mix's parameters and its driver
    bench/drivers/<driver>.py       the loop a window runs
    bench/limits/<cell>.json        the limit of each number compared
    bench/metrics/<metric>.py       one per-layer metric's reader
    bench/reference/<family>.py     the plain reference of a family
    bench/flops/<family>.py         the operation counts of a family

A later configuration, mix, cell or metric is new files and new entries
in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def declaration() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(decl: dict, name: str) -> dict:
    for w in decl["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in decl['workloads']]}")


def config(decl: dict, name: str) -> dict:
    for c in decl["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH, "traffic", f"{name}.json"))


def limits(cell_name: str) -> Dict[str, float]:
    return _json(os.path.join(BENCH, "limits", f"{cell_name}.json"))


def driver(mix: dict):
    return importlib.import_module(f"bench.drivers.{mix['driver']}")


def family(conf: dict):
    """(reference module, operation-count module) of a config's family."""
    fam = conf["family"]
    return (importlib.import_module(f"bench.reference.{fam}"),
            importlib.import_module(f"bench.flops.{fam}"))


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(decl: dict, cell_name: str) -> List[dict]:
    return [m for m in decl["end_to_end"] if _applies(m, cell_name)]


def per_layer(decl: dict, cell_name: str) -> List[dict]:
    return [m for m in decl["per_layer"] if _applies(m, cell_name)]


def reader(metric_name: str):
    """The module of ``bench/metrics/<metric>.py``; its ``read(trace)``
    returns the metric's number, or None when the run has nothing for
    it."""
    path = os.path.join(BENCH, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
