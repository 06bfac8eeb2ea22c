"""The port's sharded paths on a 2x2 mesh against the JAX package's on the
same mesh.

Reference side: one subprocess with ``--xla_force_host_platform_device_count
=4`` runs the JAX package on a 2x2 ("data", "model") mesh, once for the
file, and saves its inputs and outputs to ``.npz`` (as
``tests/test_distributed.py`` runs it; no file of the JAX package changes).
Port side: 4 gloo ranks on the CPU, once for the file, start from the
reference's initial weights and save rank 0's results.

* the train step on f32 copies of yi-6b's smoke config (recipe ``tp``, two
  steps), musicgen-medium at ``microbatches`` 1 and 4, and granite's
  ``moe_local`` under ``recipe="sp"`` with ``capacity_factor`` 8.0: loss,
  grad norm and every updated leaf (params, master, m, v) within 1e-5
  relative to the leaf's largest value;
* ``compressed_psum`` over "data": the mean and the new error feedback,
  bit for bit;
* ``make_global_batch``: the block each rank holds is the one JAX's
  ``NamedSharding`` gives the device at the same mesh position."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch.local_ranks import spawn_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
TIMEOUT_S = 240
CASES = ("yi", "musicgen1", "musicgen4", "granite")

# name -> (arch, TrainConfig kwargs, config overrides, steps)
_CASES = """
CASES = {
    "yi": ("yi-6b", {}, {}, 2),
    "musicgen1": ("musicgen-medium", {"microbatches": 1}, {}, 1),
    "musicgen4": ("musicgen-medium", {"microbatches": 4}, {}, 1),
    "granite": ("granite-moe-3b-a800m", {"recipe": "sp"},
                {"capacity_factor": 8.0}, 1),
}
B, S = 8, 16
BATCH_SPECS = {
    "tp": ({"tokens": ("data", None)}, (8, 16)),
    "dp": ({"tokens": (("data", "model"), None)}, (8, 16)),
    "seq": ({"x": ("data", "model", None)}, (4, 6, 3)),
    "rep": ({"x": (None, None)}, (4, 6)),
}


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def compression_inputs():
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((2, 5000)) *
         10.0 ** rng.integers(-4, 2, (2, 5000))).astype(np.float32)
    err = (rng.standard_normal((2, 5000)) * 1e-3).astype(np.float32)
    return g, err
"""

_JAX = """
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.data import SyntheticTokens, make_global_batch
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import init_params
from repro.optim import init_opt_state
from repro.optim.compression import compressed_psum
from repro.sharding.ctx import shard_map_fn
from repro.train import TrainConfig, make_train_step

mesh = make_mesh((2, 2), ("data", "model"))
res = {}
for name, (arch, tkw, ckw, steps) in CASES.items():
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32", **ckw)
    params = init_params(cfg, jax.random.PRNGKey(0))
    for k, v in flat(params).items():
        res[f"{name}/init/{k}"] = np.asarray(v)
    opt = init_opt_state(params)
    ds = SyntheticTokens(cfg.vocab, B, S, seed=3)
    with mesh_context(mesh):
        bundle = make_train_step(cfg, TrainConfig(**tkw), mesh, B, S)
        for s in range(steps):
            params, opt, met = bundle.fn(params, opt, ds.batch_at(s))
    res[f"{name}/recipe"] = np.array(bundle.recipe.name)
    for k in ("loss", "grad_norm"):
        res[f"{name}/{k}"] = np.asarray(met[k])
    for k, v in flat({"params": params, "master": opt["master"],
                      "m": opt["m"], "v": opt["v"]}).items():
        res[f"{name}/out/{k}"] = np.asarray(v)

g, err = compression_inputs()
shard_map = shard_map_fn()
kw = dict(mesh=mesh, in_specs=(P("data"), P("data")),
          out_specs=(P("data"), P("data")))
body = lambda a, b: tuple(x[None] for x in compressed_psum(a[0], b[0], "data"))
try:
    fn = shard_map(body, check_rep=False, **kw)
except TypeError:
    fn = shard_map(body, check_vma=False, **kw)
mean, new_err = jax.jit(fn)(jnp.asarray(g), jnp.asarray(err))
res["comp/mean"], res["comp/err"] = np.asarray(mean), np.asarray(new_err)

pos = {d.id: ij for ij, d in np.ndenumerate(mesh.devices)}
for name, (specs, shape) in BATCH_SPECS.items():
    (key, spec), = specs.items()
    host = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    arr = make_global_batch(mesh, {key: P(*spec)}, {key: host})[key]
    for shard in arr.addressable_shards:
        i, j = pos[shard.device.id]
        res[f"batch/{name}/{i}{j}"] = np.asarray(shard.data)
np.savez(OUT, **res)
"""

_PORT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch.local_ranks import join_from_env
rank, world = join_from_env(timeout_s=60)
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens, make_global_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import init_opt_state
from repro_torch.optim.compression import compressed_psum
from repro_torch.sharding import PartitionSpec as P
from repro_torch.sharding.ctx import full_tree
from repro_torch.train import TrainConfig, make_train_step

ref = np.load(sys.argv[1])
OUT = sys.argv[2]


def unflat(prefix):
    tree = {}
    for k in ref.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(ref[k].copy())
    return tree


mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
res = {}
for name, (arch, tkw, ckw, steps) in CASES.items():
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32", **ckw)
    params = unflat(f"{name}/init/")
    opt = init_opt_state(params)
    ds = SyntheticTokens(cfg.vocab, B, S, seed=3)
    bundle = make_train_step(cfg, TrainConfig(**tkw), B, S, mesh=mesh)
    for s in range(steps):
        params, opt, met = bundle.fn(params, opt, ds.batch_at(s))
    params, opt = full_tree(params), full_tree(opt)
    res[f"{name}/recipe"] = np.array(bundle.recipe.name)
    for k in ("loss", "grad_norm"):
        res[f"{name}/{k}"] = met[k].numpy()
    for k, v in flat({"params": params, "master": opt["master"],
                      "m": opt["m"], "v": opt["v"]}).items():
        res[f"{name}/out/{k}"] = v.numpy()

g, err = compression_inputs()
i, j = mesh.get_coordinate()
mean, new_err = compressed_psum(torch.from_numpy(g[i]),
                                torch.from_numpy(err[i]), "data", mesh=mesh)
means = [torch.empty_like(mean) for _ in range(world)]
errs = [torch.empty_like(new_err) for _ in range(world)]
torch.distributed.all_gather(means, mean)
torch.distributed.all_gather(errs, new_err)
res["comp/mean"] = torch.stack([means[0], means[2]]).numpy()
res["comp/err"] = torch.stack([errs[0], errs[2]]).numpy()
res["comp/mean_model_peer"] = means[1].numpy()

for name, (specs, shape) in BATCH_SPECS.items():
    (key, spec), = specs.items()
    host = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    local = make_global_batch(mesh, {key: P(*spec)}, {key: host})[key]
    blocks = [torch.empty_like(local.to_local()) for _ in range(world)]
    torch.distributed.all_gather(blocks, local.to_local().contiguous())
    for r, blk in enumerate(blocks):
        res[f"batch/{name}/{r // 2}{r % 2}"] = blk.numpy()
if rank == 0:
    np.savez(OUT, **res)
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    ref = str(tmp / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    code = "import numpy as np\n" + textwrap.dedent(_CASES) + \
        f"OUT = {ref!r}\n" + textwrap.dedent(_JAX)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    script = tmp / "port.py"
    script.write_text(textwrap.dedent(_PORT).replace(
        "ref = np.load", textwrap.dedent(_CASES) + "ref = np.load"))
    out = str(tmp / "port.npz")
    env.pop("XLA_FLAGS")
    spawn_ranks(4, [sys.executable, str(script), ref, out],
                str(tmp / "ranks"), TIMEOUT_S, env)
    return np.load(ref), np.load(out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_2x2_matches_jax(outputs, case):
    ref, port = outputs
    assert str(port[f"{case}/recipe"]) == str(ref[f"{case}/recipe"])
    for k in ("loss", "grad_norm"):
        assert _rel(port[f"{case}/{k}"], ref[f"{case}/{k}"]) <= REL_TOL, k
    leaves = [k for k in ref.files if k.startswith(f"{case}/out/")]
    assert len(leaves) == len([k for k in port.files
                               if k.startswith(f"{case}/out/")]) > 20
    for k in leaves:
        assert port[k].shape == ref[k].shape, k
        assert _rel(port[k], ref[k]) <= REL_TOL, k


def test_recipes_are_the_ones_the_cases_name(outputs):
    ref, _ = outputs
    assert [str(ref[f"{c}/recipe"]) for c in CASES] == ["tp", "tp", "tp",
                                                        "sp"]


def test_compressed_psum_over_data_is_bit_exact(outputs):
    ref, port = outputs
    for k in ("comp/mean", "comp/err"):
        assert port[k].dtype == ref[k].dtype == np.float32
        assert np.array_equal(port[k].view(np.uint32),
                              ref[k].view(np.uint32)), k
    # the "model" axis is not reduced over: both of its ranks agree
    assert np.array_equal(port["comp/mean_model_peer"], port["comp/mean"][0])


@pytest.mark.parametrize("name", ["tp", "dp", "seq", "rep"])
def test_make_global_batch_gives_each_rank_the_references_block(outputs,
                                                                name):
    ref, port = outputs
    for pos in ("00", "01", "10", "11"):
        k = f"batch/{name}/{pos}"
        assert np.array_equal(port[k], ref[k]), k
