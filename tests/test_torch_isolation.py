"""The port stands alone: no file of ``src/repro_torch``, nor ``chip_smoke.py``
nor the port's examples, nor the port's children that
``test_torch_crash.py`` kills, imports the JAX package, JAX or ml_dtypes; the
serving slice, the moe and mla families, the follower, the training
quickstart, the scrub and chaos CLIs, the multi-tenant, elastic-restart
and prompt-tuning examples run in a process where those cannot be
imported, and the port's analyzer where torch cannot be imported either;
so do a 2-rank train step on a mesh and ``reshard_restore``; and the
port's entry points (``make_mesh`` among them) refuse to drop to the CPU
when no card is present and none was asked for."""
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


QUICKSTART = os.path.join(ROOT, "examples", "quickstart_torch.py")
MULTITENANT = os.path.join(ROOT, "examples", "serve_multitenant_torch.py")
ELASTIC = os.path.join(ROOT, "examples", "elastic_restart_torch.py")
FINETUNE = os.path.join(ROOT, "examples", "finetune_lora_ckpt_torch.py")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), QUICKSTART, MULTITENANT,
           ELASTIC, FINETUNE]
    for d, _, files in os.walk(PORT):
        out.extend(os.path.join(d, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _imports(path):
    with open(path) as f:
        yield from _imports_in(f.read(), path)


def _imports_in(source, name):
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_banned_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


CRASH = os.path.join(ROOT, "tests", "test_torch_crash.py")


def _crash_port_children():
    """The port's child scripts of ``test_torch_crash.py``, read from its
    module-level string literals without importing it: ``PORT_PARTS``
    joined, then each ``BODIES`` entry -> {body: script}."""
    with open(CRASH) as f:
        tree = ast.parse(f.read(), CRASH)
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                continue
    parts = "".join(consts[p] for p in consts["PORT_PARTS"])
    return {case: parts + body for case, body in consts["BODIES"].items()}


@pytest.mark.parametrize("body", sorted(_crash_port_children()))
def test_killed_port_child_imports_nothing_banned(body):
    """A port child that ``test_torch_crash.py`` kills imports only the
    port (it also runs with the banned modules blocked)."""
    script = _crash_port_children()[body]
    bad = [m for m in _imports_in(script, body) if m.split(".")[0] in BANNED]
    assert bad == [], f"the {body} child imports {bad}"
    assert "import repro_torch" in script or "from repro_torch" in script


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
                                                         chunk_bytes=4096,
                                                         async_write=False))
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


_BLOCKED_FAMILIES = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import numpy as np
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params, prefill
from repro_torch.serve import Engine
for arch in ("mixtral-8x7b", "minicpm3-4b"):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    _, logits = prefill(cfg, params, torch.as_tensor(prompts))
    assert logits.shape == (2, cfg.vocab) and bool(logits.isfinite().all())
    res = Engine(cfg, params, max_len=24, device="cpu").generate(
        prompts.astype(np.int32), 6)
    print(arch, cfg.family, res.tokens.shape)
assert "jax" not in sys.modules or sys.modules["jax"] is None
"""


def test_moe_and_mla_serve_with_jax_and_repro_unimportable():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_FAMILIES], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mixtral-8x7b moe (2, 6)" in proc.stdout
    assert "minicpm3-4b mla (2, 6)" in proc.stdout


_BLOCKED_FOLLOWER = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import tempfile
import numpy as np
import torch
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import CheckpointFollower, Engine
cfg = get_smoke_config("yi-6b")
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
root = tempfile.mkdtemp()
mgr = CheckpointManager(root + "/train", cfg.name, CheckpointPolicy(
    use_fingerprints=True, chunk_bytes=4096, async_write=False),
    registry=root + "/registry")
mgr.save(0, params, {})
smart = CheckpointFollower(remote=root + "/train", local=root + "/replica")
passive = CheckpointFollower(remote=None, registry=root + "/registry",
                             local=root + "/edge")
eng = Engine(cfg, smart.poll().params, device="cpu")
assert passive.poll().step == 0 and passive.last_plan.negotiations == 0
params["final_norm"] = params["final_norm"] * 2
mgr.save(1, params, {})
upd = smart.poll_and_refresh(eng)
assert upd.changed_params == {"final_norm"} and eng.last_refresh_leaves == 1
assert passive.poll().changed_params == {"final_norm"}
res = eng.generate(np.ones((2, 8), np.int32), 4)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("follower-ok", res.tokens.shape)
"""


def test_follower_polls_with_jax_and_repro_unimportable():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_FOLLOWER], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "follower-ok (2, 4)" in proc.stdout


_BLOCKED_QUICKSTART = r"""
import runpy, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.argv = [sys.argv[1], "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--save-every", "1"]
runpy.run_path(sys.argv[0], run_name="__main__")
assert "jax" not in sys.modules or sys.modules["jax"] is None
"""


def test_training_quickstart_runs_with_jax_and_repro_unimportable():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_QUICKSTART,
                           QUICKSTART], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "quickstart OK" in proc.stdout


_BLOCKED_STORE_SURFACE = r"""
import runpy, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
example = sys.argv[1]
for argv in (["--soak"], ["--seeds", "0", "--scenarios", "fanout",
                          "--modes", "bitrot"]):
    module = "repro_torch.ft.scrub" if argv == ["--soak"] else \
        "repro_torch.ft.chaos"
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (module, e.code)
sys.argv = [example, "--device", "cpu"]
runpy.run_path(example, run_name="__main__")
assert "jax" not in sys.modules or sys.modules["jax"] is None
"""


def test_store_surface_runs_with_jax_and_repro_unimportable():
    """``python -m repro_torch.ft.scrub --soak``, a one-cell chaos matrix
    and ``examples/serve_multitenant_torch.py --device cpu``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_STORE_SURFACE,
                           MULTITENANT], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "detector catches 100% of seeded bit-rot" in proc.stdout
    assert "1/1 cells converged" in proc.stdout
    assert "multitenant OK" in proc.stdout


_BLOCKED_EXAMPLES = r"""
import runpy, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
for example in sys.argv[1:]:
    sys.argv = [example, "--device", "cpu"]
    runpy.run_path(example, run_name="__main__")
assert "jax" not in sys.modules or sys.modules["jax"] is None
"""


def test_new_examples_run_with_jax_and_repro_unimportable():
    """``examples/elastic_restart_torch.py`` and
    ``examples/finetune_lora_ckpt_torch.py``, ``--device cpu``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_EXAMPLES, ELASTIC,
                           FINETUNE], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "bitwise identical to run A: True" in proc.stdout
    assert "elastic_restart OK" in proc.stdout
    assert "finetune_lora_ckpt OK" in proc.stdout


_BLOCKED_ANALYZER = r"""
import runpy, sys
for name in ("torch", "numpy", "jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.argv = ["repro_torch.analysis", "--check"]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
assert sys.modules["torch"] is None
"""


def test_analyzer_checks_with_torch_and_jax_unimportable():
    """``python -m repro_torch.analysis --check`` is pure ``ast`` and
    stdlib: it runs where neither torch nor jax (nor numpy) imports."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_ANALYZER], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "check: clean" in proc.stdout


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


def test_quickstart_defaults_to_the_card(no_gpu):
    import runpy
    mod = runpy.run_path(QUICKSTART)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod["main"](["--steps", "1"])


def test_train_step_without_a_device_refuses_the_cpu(no_gpu):
    from repro_torch.train import TrainConfig, make_train_step
    cfg, _ = _smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, TrainConfig(), 2, 8)
    assert make_train_step(cfg, TrainConfig(), 2, 8,
                           device="cpu").microbatches == 1


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


def test_make_mesh_without_a_device_refuses_the_cpu(no_gpu):
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"), device="cuda")


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_BLOCKED_MESH = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from repro_torch.launch.local_ranks import join_from_env
rank, world = join_from_env(timeout_s=60)
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
from repro_torch.ckpt import reshard_restore
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import full_tree, spec_tree
from repro_torch.train import TrainConfig, make_train_step
cfg = get_smoke_config("yi-6b")
mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
b = make_train_step(cfg, TrainConfig(), 4, 16, mesh=mesh)
p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
p, o, met = b.fn(p, init_opt_state(p), SyntheticTokens(cfg.vocab, 4, 16)
                 .batch_at(0))
mgr = CheckpointManager(sys.argv[1], cfg.name,
                        CheckpointPolicy(async_write=False))
mgr.save(1, p, o)
got = reshard_restore(mgr, mesh, spec_tree(b.in_shardings[0]))
assert all(torch.equal(a, c) for a, c in
           zip(tree_leaves(full_tree(p)), tree_leaves(full_tree(got[0]))))
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("mesh-ok", rank, float(met["loss"]) > 0)
"""


def test_mesh_step_and_reshard_run_with_jax_and_repro_unimportable(tmp_path):
    from repro_torch.launch.local_ranks import spawn_ranks
    script = tmp_path / "body.py"
    script.write_text(_BLOCKED_MESH)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    outs = spawn_ranks(2, [sys.executable, str(script),
                           str(tmp_path / "store")], str(tmp_path / "ranks"),
                       120, env)
    assert [o.strip() for o in outs] == ["mesh-ok 0 True", "mesh-ok 1 True"]
