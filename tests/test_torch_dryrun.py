"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and the production meshes.

* ``model_flops_for`` equals the reference's for all ten archs x their
  applicable shapes, and ``cells`` the reference's list, exactly.
* ``make_production_mesh`` gives the reference's shapes and axis names in
  fake worlds of 256 and 512 ranks (a subprocess).
* A cell run through ``main`` in a subprocess where JAX, ml_dtypes and the
  JAX package cannot be imported (yi-6b cut by ``--set`` to one layer,
  ``decode_32k`` on a fake 2x2 mesh) writes ``ok: true`` in the
  reference's schema, and ``benchmarks/roofline_table.py::build_table``
  reads the file as it is (its ``DRYRUN`` pointed at the port's results).
* A cell that fails writes ``ok: false`` with its error and ``main``
  exits 1.
* The products torch 2.11's DTensor refused in the dry-run (a flatten of
  (B, S) sharded over both mesh axes, of mamba2's P-sharded head weights,
  of minicpm3's 40 heads split over 16 ranks) take the mesh-local path
  (``models/layers.py::_local_contract``) and give the plain product's
  global shape; on a fake world of 256 (their values are held by
  ``tests/test_torch_distributed.py``'s granite step under "sp").
* A checkpointed body recomputed in backward on another thread (autograd
  runs CUDA backward on a thread of its own) sees the activation rules of
  its forward: unbound, the card's recompute skipped every ``constrain``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import SHAPES as PORT_SHAPES  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 240
_BLOCK = ("import sys\nfor _m in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
          "    sys.modules[_m] = None\n")


def _reference_dryrun():
    """``repro.launch.dryrun``: its first statement sets XLA_FLAGS to 512
    host devices, which is put back at once (JAX reads it at its first
    use, not here)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def test_cells_equal_the_reference():
    ref = _reference_dryrun()
    for sel in ("pod", "multipod", "both"):
        assert dryrun.cells(sel) == ref.cells(sel)


def test_model_flops_equal_the_reference():
    ref = _reference_dryrun()
    from repro.configs import SHAPES, get_config
    cells = dryrun.cells("pod")
    assert len(cells) == 33
    for arch, shape, _ in cells:
        assert dryrun.model_flops_for(port_config(arch), PORT_SHAPES[shape]) \
            == ref.model_flops_for(get_config(arch), SHAPES[shape]), \
            (arch, shape)


def _run(code, timeout=TIMEOUT_S):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", _BLOCK + code], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_production_meshes_in_fake_worlds():
    proc = _run("""
import json, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
out = []
for multi_pod, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi_pod, device="cpu")
    out.append([list(m.shape), list(m.mesh_dim_names), m.size()])
    dist.destroy_process_group()
try:
    make_production_mesh(device="cpu")
except RuntimeError as e:
    out.append(str(e)[:40])
print("RESULT " + json.dumps(out))
""")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    assert json.loads(line[-1][7:]) == [
        [[16, 16], ["data", "model"], 256],
        [[2, 16, 16], ["pod", "data", "model"], 512],
        "a (16, 16) mesh needs 256 ranks; start t"]


_MAIN = """
from repro_torch.launch import dryrun
dryrun.RESULTS_DIR = sys.argv[1]
sys.exit(dryrun.main(sys.argv[2:]))
"""


def _main(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", _BLOCK + _MAIN,
                           str(tmp_path), *args], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def test_a_cell_writes_the_reference_schema_and_the_table_reads_it(
        tmp_path, monkeypatch):
    proc = _main(tmp_path, "--arch", "yi-6b", "--shape", "decode_32k",
                 "--mesh", "2x2", "--set", "n_layers=1", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    path = tmp_path / "yi-6b__decode_32k__2x2.json"
    d = json.loads(path.read_text())
    assert d["ok"] is True and d["device"] == "cpu"
    from repro.roofline.analyze import CellResult as RefCell
    fields = {f.name for f in dataclasses.fields(RefCell)}
    assert fields <= set(d), fields - set(d)
    assert set(d["terms"]) == {"compute_s", "memory_s", "collective_s",
                               "dominant", "useful_flops_ratio",
                               "roofline_fraction"}
    assert (d["arch"], d["shape"], d["mesh"], d["recipe"], d["n_devices"]) \
        == ("yi-6b", "decode_32k", "2x2", "decode", 4)
    cfg = port_config("yi-6b").replace(n_layers=1)
    assert d["model_flops"] == dryrun.model_flops_for(
        cfg, PORT_SHAPES["decode_32k"])
    assert d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
    assert d["coll_bytes"]["total"] > 0 and d["temp_bytes"] > 0
    assert d["arg_bytes"] > 0 and d["out_bytes"] > 0

    from benchmarks import roofline_table
    monkeypatch.setattr(roofline_table, "DRYRUN", str(tmp_path))
    rows = roofline_table.build_table()["rows"]
    assert len(rows) == 1 and rows[0]["ok"]
    row = rows[0]
    assert row["flops_per_device"] == d["flops_per_device"]
    assert row["dominant"] == d["terms"]["dominant"]
    assert row["compile_s"] == d["compile_seconds"] > 0


def test_a_failing_cell_writes_its_error_and_exits_1(tmp_path):
    proc = _main(tmp_path, "--arch", "no-such-arch", "--shape", "decode_32k",
                 "--mesh", "2x2", "--device", "cpu")
    assert proc.returncode == 1
    d = json.loads((tmp_path / "no-such-arch__decode_32k__2x2.json")
                   .read_text())
    assert d["ok"] is False and d["error"]
    assert "FAIL" in proc.stdout


_LOCAL_PRODUCTS = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.sharding.ctx import activation_ctx
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device="cpu")
out = {}
with FakeTensorMode(), activation_ctx({}, mesh):
    def dt(shape, pl):
        return distribute_tensor(torch.empty(shape, dtype=torch.bfloat16),
                                 mesh, pl, src_data_rank=None)
    cases = {
        "dense_bs": (layers.dense, 1, dt((32, 4096, 256), [Shard(0), Shard(1)]),
                     dt((256, 512), [Replicate(), Replicate()])),
        "proj_p": (layers.proj_heads, 1, dt((32, 256), [Shard(0), Replicate()]),
                   dt((256, 24, 64), [Replicate(), Shard(2)])),
        "unproj_uneven": (layers.unproj_heads, 2,
                          dt((128, 1, 40, 64), [Shard(0), Shard(2)]),
                          dt((40, 64, 256), [Replicate(), Replicate()])),
        "plain": (layers.dense, 1, dt((32, 4096, 256), [Shard(0), Replicate()]),
                  dt((256, 512), [Replicate(), Shard(1)])),
    }
    for name, (fn, nc, x, w) in cases.items():
        y = fn(x, w)
        out[name] = [layers._flattens_a_shard(x, w, nc), list(y.shape),
                     [str(p) for p in y.placements]]
print("RESULT " + json.dumps(out))
"""


def test_products_refused_by_torch_2_11_take_the_local_path():
    proc = _run(_LOCAL_PRODUCTS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    got = json.loads(line[-1][7:])
    assert got["dense_bs"][:2] == [True, [32, 4096, 512]]
    assert got["proj_p"][:2] == [True, [32, 24, 64]]
    assert got["unproj_uneven"][:2] == [True, [128, 1, 256]]
    assert got["plain"][:2] == [False, [32, 4096, 512]]
    # the local path keeps the shards it can: (B, S) over both axes, P
    # over "model", and the uneven heads contracted into a pending sum
    assert got["dense_bs"][2] == ["S(0)", "S(1)"]
    assert got["proj_p"][2] == ["S(0)", "S(2)"]
    assert got["unproj_uneven"][2] == ["S(0)", "P(sum)"]


def test_a_recompute_on_another_thread_sees_the_forward_rules():
    import threading

    from repro_torch.models.layers import recomputed
    from repro_torch.sharding.ctx import activation_ctx, current_rules
    seen = []

    def body(x):
        seen.append(dict(current_rules()))
        return (x * 2.0).sin()

    x = torch.ones(4, requires_grad=True)
    with activation_ctx({"act_hidden": ("data", None)}):
        y = recomputed(body, x).sum()
    errors = []

    def backward():
        try:
            y.backward()
        except Exception as e:     # reported below, on the test's thread
            errors.append(e)
    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and errors == []
    assert seen == [{"act_hidden": ("data", None)}] * 2
    assert current_rules() == {}
