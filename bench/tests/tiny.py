"""Tiny sizes of each cell, widths cut so that a run takes seconds on the
CPU, and a run at them with the chip check left out. The sizes are files,
found by name, so a new cell or family needs new files and no edit here:

    bench/tests/tiny/<cell>.json           the cell's "config" (laid over
                                           its family's widths), "traffic"
                                           and "limits", and "why"
    bench/tests/tiny/family/<family>.json  a family's tiny widths
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import spec  # noqa: E402


def _file(*parts: str) -> dict:
    """The tiny file at ``parts`` under the benchmark's directory, or a
    FileNotFoundError that names the file to add."""
    path = os.path.join(spec.BENCH, "tests", "tiny", *parts)
    if not os.path.exists(path):
        rel = os.path.relpath(path, spec.ROOT)
        raise FileNotFoundError(f"no tiny sizes: add {rel}")
    with open(path) as f:
        return json.load(f)


def family(name: str) -> dict:
    """A family's tiny widths (Hugging Face key names)."""
    return _file("family", f"{name}.json")


def overrides(cell: str, decl=None) -> dict:
    """The cell's tiny overrides as ``run_cell`` takes them: its family's
    widths under its own config keys, its traffic and its limits."""
    decl = decl or spec.declaration()
    conf = spec.config(decl, spec.cell(decl, cell)["config"])
    own = _file(f"{cell}.json")
    return {"config": {**family(conf["family"]), **own["config"]},
            "traffic": own["traffic"], "limits": own["limits"]}


def missing_files(decl=None) -> list:
    """The tiny files that the declared cells and their families lack,
    each named in a message that says to add it."""
    decl = decl or spec.declaration()
    wanted = {(f"{w['name']}.json",) for w in decl["workloads"]}
    wanted |= {("family", f"{spec.config(decl, c['name'])['family']}.json")
               for c in decl["configs"]}
    out = []
    for parts in sorted(wanted):
        try:
            _file(*parts)
        except FileNotFoundError as e:
            out.append(str(e))
    return out


def tiny_run(cell, seed=5, seconds=0.6, readings=(), traced=False,
             decl=None):
    """A run of ``cell`` at tiny sizes on the CPU, the chip check left out."""
    from bench.harness import run_cell
    return run_cell(cell, seed, seconds, traced, "cpu", time.perf_counter(),
                    decl=decl, overrides=overrides(cell, decl),
                    readings=readings)
