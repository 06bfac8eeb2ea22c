"""The port's sharding against the JAX package's, and the port's meshes
against one device.

* The rule tables: for all ten archs at full width, train, prefill and
  decode, on meshes (16,16), (2,16,16), (2,4), (2,2) and (1,2) (JAX side:
  ``AbstractMesh``, no devices), every entry of ``recipe_for``,
  ``param_specs_tree``, ``opt_specs`` with ``zero_axes_for``,
  ``batch_specs``, ``activation_rules`` and ``cache_specs`` is equal.
* ``quantize_int8`` / ``dequantize_int8`` against JAX in-process,
  bit-exact.
* Spec -> placements, and the blocks each mesh position holds.
* On 2 gloo ranks (CPU): the sharded train step at 2x1 and 1x2 against
  the port's one-device step, f32 (loss, grad norm and every updated leaf
  within 1e-5 relative to the leaf's largest value).
* On 4 gloo ranks: a 2x2 save, ``reshard_restore`` onto 4x1, and then in
  this process onto 1x1 and through the JAX package's ``reshard_restore``
  on one device, each bit-equal to ``mgr.restore``.

Each multi-rank run is a set of subprocesses that meet through a
``FileStore`` under the test's temporary directory, with a deadline."""
import functools
import os
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.sharding import rules as jr  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch.local_ranks import spawn_ranks  # noqa: E402
from repro_torch.models import init_cache, param_specs  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.sharding import ctx as tctx  # noqa: E402
from repro_torch.sharding import rules as tr  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model"))]
KINDS = ("train", "prefill", "decode")
TRAIN_REL_TOL = 1e-5
RANK_TIMEOUT_S = 120


def _shape_only(sizes, axes):
    """A mesh as the port's rules read it: axis names and sizes only."""
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)),
                                 axis_names=tuple(axes))


def _spec(s):
    """A spec (either package's) as a plain tuple of its entries."""
    return None if s is None else tuple(s)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return _spec(t)


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: jm.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_cache_shape(arch, batch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: jm.init_cache(cfg, batch, 64))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rule_tables_equal_the_references(arch, kind):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jshape, tshape = _jax_params_shape(arch), param_specs(tcfg)
    batches = (SHAPES[f"{kind}_4k" if kind == "train" else
                      f"{kind}_32k"].global_batch, 6, 1)
    for sizes, axes in MESHES:
        jmesh, tmesh = AbstractMesh(sizes, axes), _shape_only(sizes, axes)
        jrec, trec = jr.recipe_for(jcfg, kind, jmesh), \
            tr.recipe_for(tcfg, kind, tmesh)
        assert (trec.name, trec.kind) == (jrec.name, jrec.kind), sizes
        jps = jr.param_specs_tree(jcfg, jrec, jmesh, jshape)
        tps = tr.param_specs_tree(tcfg, trec, tmesh, tshape)
        assert _tree(tps) == _tree(jps), (sizes, "params")
        for zero1 in (True, False):
            jz = jr.zero_axes_for(jrec, jmesh) if zero1 else ()
            tz = tr.zero_axes_for(trec, tmesh) if zero1 else ()
            assert tz == jz
            assert _tree(tr.opt_specs(tps, tshape, tmesh, tz)) == \
                _tree(jr.opt_specs(jps, jshape, jmesh, jz)), (sizes, zero1)
        for b in batches:
            assert _tree(tr.batch_specs(tcfg, trec, tmesh, b)) == \
                _tree(jr.batch_specs(jcfg, jrec, jmesh, b)), (sizes, b)
            assert _tree(tr.activation_rules(tcfg, trec, tmesh, b)) == \
                _tree(jr.activation_rules(jcfg, jrec, jmesh, b)), (sizes, b)
            tc = init_cache(tcfg, b, 64, "meta")
            assert _tree(tr.cache_specs(tcfg, trec, tmesh, b, tc)) == \
                _tree(jr.cache_specs(jcfg, jrec, jmesh, b,
                                     _jax_cache_shape(arch, b))), (sizes, b)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("shape,dtype", [((5000,), "float32"),
                                         ((3, 2048), "float32"),
                                         ((7, 33, 5), "bfloat16"),
                                         ((4096,), "zeros")])
def test_quantize_and_dequantize_are_the_references_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3, shape)) \
        .astype(np.float32)
    if dtype == "zeros":
        g[:] = 0
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tg = torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js = jcomp.quantize_int8(jg)
    tq, ts = tcomp.quantize_int8(tg)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))
    jd = np.asarray(jcomp.dequantize_int8(jq, js, shape))
    td = tcomp.dequantize_int8(tq, ts, shape).numpy()
    assert np.array_equal(td.view(np.uint32), jd.view(np.uint32))
    assert tcomp.BLOCK == jcomp.BLOCK


def test_round_half_to_even_as_jnp_round():
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0] + [0.0] * 2042,
                 np.float32)
    jq, _ = jcomp.quantize_int8(jnp.asarray(g))
    tq, _ = tcomp.quantize_int8(torch.from_numpy(g))
    assert np.array_equal(tq.numpy(), np.asarray(jq))


# -------------------------------------------------------------- placements
def test_placements_map_each_axis_to_its_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _shape_only((2, 2, 4), ("pod", "data", "model"))
    P = tr.PartitionSpec
    assert tctx.placements(mesh, P(("pod", "data"), None, "model"), 3) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tctx.placements(mesh, P(None, "data"), 4) == \
        [Replicate(), Shard(1), Replicate()]
    assert tctx.placements(mesh, None, 2) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tctx.placements(mesh, P(("data", "pod")), 1)


def test_partition_spec_stores_a_one_name_tuple_as_the_name():
    P = tr.PartitionSpec
    assert tuple(P(("data",), None)) == ("data", None) == \
        tuple(jax.sharding.PartitionSpec(("data",), None))
    assert repr(P("model")) == "PartitionSpec('model',)"


def test_shard_index_cuts_major_to_minor_and_refuses_uneven_dims():
    P = tr.PartitionSpec
    sizes = {"data": 2, "model": 4}
    got = {(d, m): tctx.shard_index(sizes, {"data": d, "model": m},
                                    P(("data", "model"), None), (16, 3))
           for d in range(2) for m in range(4)}
    assert got[(1, 2)] == (slice(12, 14), slice(0, 3))
    assert sorted(s[0].start for s in got.values()) == list(range(0, 16, 2))
    with pytest.raises(ValueError, match="does not split"):
        tctx.shard_index(sizes, {"data": 0, "model": 0}, P("model"), (6,))


def test_constrain_is_a_no_op_outside_a_context_and_on_plain_tensors():
    x = torch.ones(2, 3)
    assert tctx.constrain(x, "act_hidden") is x
    with tctx.activation_ctx({"act_hidden": tr.PartitionSpec("data")}):
        assert tctx.constrain(x, "act_hidden") is x


# ------------------------------------------------------------ multi-rank
def _run(tmp_path, n, body, timeout_s=RANK_TIMEOUT_S):
    script = tmp_path / "body.py"
    script.write_text(textwrap.dedent(_PRELUDE) + textwrap.dedent(body))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return spawn_ranks(n, [sys.executable, str(script), str(tmp_path)],
                       str(tmp_path / "ranks"), timeout_s, env)


_PRELUDE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch.local_ranks import join_from_env
rank, world = join_from_env(timeout_s=60)
OUT = sys.argv[1]
"""

_VS_ONE_DEVICE = """
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding.ctx import full_tree
from repro_torch.train import TrainConfig, make_train_step
cfg = get_smoke_config("yi-6b").replace(param_dtype="float32",
                                        compute_dtype="float32")
B, S = 4, 16
ds = SyntheticTokens(cfg.vocab, B, S, seed=5)
res = {}
for shape in ((2, 1), (1, 2)):
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    tcfg = TrainConfig(microbatches=1)
    runs = []
    for m in (None, mesh):
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        o = init_opt_state(p)
        b = make_train_step(cfg, tcfg, B, S, device="cpu", mesh=m)
        for s in range(2):
            p, o, met = b.fn(p, o, ds.batch_at(s))
        runs.append((full_tree(p), full_tree(o), met))
    tag = "x".join(map(str, shape))
    for i, (p, o, met) in enumerate(runs):
        for k in ("loss", "grad_norm"):
            res[f"{tag}/{i}/{k}"] = met[k].numpy()
        for j, leaf in enumerate(tree_leaves(p) + tree_leaves(o["master"])
                                 + tree_leaves(o["m"]) + tree_leaves(o["v"])):
            res[f"{tag}/{i}/leaf{j:03d}"] = leaf.numpy()
if rank == 0:
    np.savez(f"{OUT}/out.npz", **res)
"""


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_2x1_and_1x2_steps_match_one_device(tmp_path):
    """The grads of a step on a mesh are reduced over the ranks that held
    the batch's shards (a ``to_local`` in the forward pass would drop that
    reduction and give each rank its half-batch grads)."""
    _run(tmp_path, 2, _VS_ONE_DEVICE)
    out = np.load(tmp_path / "out.npz")
    for tag in ("2x1", "1x2"):
        leaves = sorted(k.split("/")[-1] for k in out
                        if k.startswith(f"{tag}/0/leaf"))
        assert len(leaves) > 20
        for name in ["loss", "grad_norm"] + leaves:
            assert _rel(out[f"{tag}/1/{name}"], out[f"{tag}/0/{name}"]) <= \
                TRAIN_REL_TOL, (tag, name)


_SERVE_STEPS = """
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_cache, init_params
from repro_torch.sharding import full_tree
from repro_torch.train import make_decode_step, make_prefill_step
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
B, S = 4, 16
res = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         compute_dtype="float32")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    for i, m in enumerate((None, mesh)):
        cache, logits = make_prefill_step(cfg, B, S, device="cpu",
                                          mesh=m).fn(p, toks)
        res[f"{arch}/{i}/prefill"] = logits.numpy()
        for k, v in full_tree(cache).items():
            res[f"{arch}/{i}/cache/{k}"] = v.numpy()
        dec = make_decode_step(cfg, B, S + 2, device="cpu", mesh=m)
        cache = init_cache(cfg, B, S + 2, "cpu")
        for pos in range(3):
            cache, logits = dec.fn(p, cache, toks[:, pos], pos)
            res[f"{arch}/{i}/decode{pos}"] = logits.numpy()
        for k, v in full_tree(cache).items():
            res[f"{arch}/{i}/dcache/{k}"] = v.numpy()
if rank == 0:
    np.savez(f"{OUT}/out.npz", **res)
"""
SERVE_ARCHS = ("yi-6b", "mixtral-8x7b", "minicpm3-4b", "hymba-1.5b",
               "mamba2-130m")


def test_meshed_prefill_and_decode_match_one_device_on_2x2(tmp_path):
    """The prefill and decode step bundles on a 2x2 mesh (each family's
    recipe; decode caches length-sharded over "model") against the same
    bundles on one device: logits and caches within 1e-5 relative."""
    _run(tmp_path, 4, f"ARCHS = {SERVE_ARCHS!r}\n" + _SERVE_STEPS)
    out = np.load(tmp_path / "out.npz")
    for arch in SERVE_ARCHS:
        names = sorted(k.split("/", 2)[2] for k in out
                       if k.startswith(f"{arch}/0/"))
        assert len(names) >= 6
        for name in names:
            assert _rel(out[f"{arch}/1/{name}"], out[f"{arch}/0/{name}"]) \
                <= TRAIN_REL_TOL, (arch, name)


_RESHARD = """
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
from torch.distributed.tensor import DTensor
cfg = get_smoke_config("yi-6b")
B, S = 4, 16
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
b = make_train_step(cfg, TrainConfig(), B, S, mesh=mesh)
p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
p, o, _ = b.fn(p, init_opt_state(p), SyntheticTokens(cfg.vocab, B, S).batch_at(0))
mgr = CheckpointManager(f"{OUT}/store", cfg.name,
                        CheckpointPolicy(async_write=False))
mgr.save(1, p, o)
want = mgr.restore(device="cpu")
assert want[2] == 1
m4 = make_mesh((4, 1), ("data", "model"), device="cpu")
b4 = make_train_step(cfg, TrainConfig(recipe="dp"), B, S, mesh=m4)
got = reshard_restore(mgr, m4, spec_tree(b4.in_shardings[0]),
                      spec_tree(b4.in_shardings[1]))
assert got[2] == 1
n_sharded = sum(isinstance(x, DTensor) and x.to_local().numel() < x.numel()
                for x in tree_leaves(got[1]))
assert n_sharded > 0
for tree_w, tree_g in ((want[0], got[0]), (want[1], got[1])):
    gw, gg = tree_leaves(tree_w), tree_leaves(full_tree(tree_g))
    assert len(gw) == len(gg)
    for a, c in zip(gw, gg):
        assert a.dtype == c.dtype and torch.equal(a, c)
print("reshard-ok", n_sharded)
"""


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reshard_restore_from_2x2_onto_4x1_and_1x1_and_through_jax(tmp_path):
    from repro.ckpt import CheckpointManager as JaxManager
    from repro.ckpt.reshard import reshard_restore as jax_reshard
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro_torch.ckpt import CheckpointManager, reshard_restore
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import tree_to_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import tree_leaves
    outs = _run(tmp_path, 4, _RESHARD)
    assert "reshard-ok" in outs[0]
    cfg = get_smoke_config("yi-6b")
    mgr = CheckpointManager(str(tmp_path / "store"), cfg.name)
    want = mgr.restore(device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    pspec = tr.param_specs_tree(cfg, tr.recipe_for(cfg, "train", mesh), mesh,
                                param_specs(cfg))
    got = reshard_restore(mgr, mesh, pspec)
    for a, c in zip(tree_leaves(want[0]), tree_leaves(got[0])):
        assert torch.equal(a, c.full_tensor())
    jmesh = jax_mesh((1, 1), ("data", "model"))
    jcfg = jax_smoke_config("yi-6b")
    jps = jr.param_specs_tree(jcfg, jr.recipe_for(jcfg, "train", jmesh),
                              jmesh, jax.eval_shape(
                                  lambda: jm.init_params(
                                      jcfg, jax.random.PRNGKey(0))))
    jp, jo, jstep = jax_reshard(JaxManager(str(tmp_path / "store"), cfg.name),
                                jmesh, jps)
    assert jstep == want[2] == 1
    import ml_dtypes
    for name, a in zip(sorted(_flat(want[0])),
                       tree_leaves(tree_to_numpy(want[0], ml_dtypes.bfloat16))):
        assert _same_bits(np.asarray(_flat(jp)[name]), a), name


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out
