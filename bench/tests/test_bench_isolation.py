"""Nothing the benchmark runs imports JAX or the JAX package: by the
sources, and by what a run leaves in ``sys.modules`` (top-level names
compared whole: ``repro_torch`` is the port, ``repro`` the JAX package)."""
import ast
import os
import subprocess
import sys

from bench.tests.tiny import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_under_bench_imports_jax_or_the_jax_package():
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                found += [(path, n) for n in names
                          if n.split(".")[0] in BANNED]
    assert found == []


def test_a_run_loads_no_banned_module():
    code = (
        "import sys, runpy\n"
        "mod = runpy.run_path('bench/run.py', run_name='bench_run')\n"
        "from bench.tests.tiny import tiny_run\n"
        "tiny_run('minicpm3-4b.deploy', seconds=0.3)\n"
        "tiny_run('yi-6b.train', seconds=0.3)\n"
        "print('BANNED', mod['banned_modules']())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BANNED []" in out.stdout


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "yi-6b.serve", "--seed", "3000000001", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
