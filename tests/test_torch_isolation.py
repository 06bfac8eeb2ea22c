"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports the JAX package, JAX or ml_dtypes; the slice runs in a process where
those cannot be imported; and the port's entry points refuse to drop to the
CPU when no card is present and none was asked for."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
BANNED = ("repro", "jax", "jaxlib", "ml_dtypes")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out.extend(os.path.join(d, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_banned_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import pkgutil, importlib, tempfile
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import torch
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import load_params, make_prompts, serve
from repro_torch.models import init_params
from repro_torch.serve import changed_tensor_paths
cfg = get_smoke_config("yi-6b")
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
root = tempfile.mkdtemp()
mgr = CheckpointManager(root, cfg.name, CheckpointPolicy(use_fingerprints=True,
                                                         chunk_bytes=4096))
mgr.save(0, params, {})
loaded, _ = load_params(cfg, root, "cpu")
eng, res, _ = serve(cfg, loaded, make_prompts(cfg, 2, 8), 4, "cpu")
params["final_norm"] = params["final_norm"] * 2
r = mgr.save(1, params, {})
assert r.layers_injected == 2 and r.layers_built == 0, r
plan = changed_tensor_paths(mgr.store, "ckpt", mgr.tag_of(0), mgr.tag_of(1))
assert plan == {"params/final_norm", "opt/__step__"}, plan
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("slice-ok", res.tokens.shape)
"""


def test_slice_runs_with_jax_and_repro_unimportable():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "slice-ok (2, 4)" in proc.stdout


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _smoke():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = get_smoke_config("yi-6b")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_engine_without_a_device_refuses_the_cpu(no_gpu):
    from repro_torch.serve import Engine
    cfg, params = _smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    assert Engine(cfg, params, device="cpu").device.type == "cpu"


def test_launch_serve_defaults_to_the_card(no_gpu):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
    cfg, _ = _smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_params(cfg, None, None)


def test_restore_without_a_device_refuses_the_cpu(no_gpu, tmp_path):
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    cfg, params = _smoke()
    mgr = CheckpointManager(str(tmp_path), cfg.name,
                            CheckpointPolicy(chunk_bytes=4096))
    mgr.save(0, params, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore()
    assert mgr.restore(device="cpu")[2] == 0


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
