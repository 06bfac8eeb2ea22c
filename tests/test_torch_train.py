"""The training half of the main path against the JAX package, on the same
inputs: the synthetic data, the loss and its gradients, one AdamW update,
the microbatched train step, and checkpoints that carry optimizer state.

Weights are drawn once by JAX and carried over bit for bit
(``params_from_jax``). Tolerances:
* loss, f32: 1e-5 abs; bf16: 0.05 abs (XLA and torch round bf16
  intermediates at other points);
* each grad leaf: 1e-4 x max(1, max|g|) abs (the frameworks sum in other
  orders; the observed gap is ~5e-8);
* AdamW from identical grads (master, m, v, lr, grad_norm): 1e-6 relative,
  that is max|port - jax| <= 1e-6 x max|jax| per leaf;
* params and optimizer state after one train step: 1e-4 x max(1, max|x|)
  abs per leaf, the grads' tolerance.
Checkpoints compare bit for bit. TF32 is off for f32 matrix products.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import optim as jo  # noqa: E402
from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import CheckpointPolicy as JaxPolicy  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.data import SyntheticTokens as JaxTokens  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import optim as to  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.convert import params_from_jax, tree_to_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens, make_batch  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.sharding.ctx import full_tree  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

LOSS_F32_TOL = 1e-5
LOSS_BF16_TOL = 0.05
GRAD_TOL = 1e-4
ADAMW_REL_TOL = 1e-6
CHUNK = 4096

CASES = {
    "yi-6b": ("yi-6b", dict()),
    "yi-6b-sliding-window": ("yi-6b", dict(window=8, q_block=8, kv_block=8)),
    "mamba2-130m": ("mamba2-130m", dict()),
    "hymba-1.5b": ("hymba-1.5b", dict()),
}


@pytest.fixture(autouse=True)
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _cfgs(arch="yi-6b", dtype="float32", **kw):
    cfg = get_smoke_config(arch).replace(param_dtype=dtype,
                                         compute_dtype=dtype, **kw)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=2, S=32, step=0):
    return JaxTokens(cfg.vocab, B, S, seed=1).batch_at(step)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_err(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _abs_tol_err(got, want):
    """max|got - want| / max(1, max|want|)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _bits(x):
    """Raw bytes of a numpy array or tensor (bf16 by its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        x = tree_to_numpy(x, jnp.bfloat16)
    x = np.ascontiguousarray(np.asarray(x))
    return str(x.dtype), x.shape, x.reshape(-1).view(np.uint8).tobytes()


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (199, 2, 32, 0, 0), (64000, 4, 2048, 0, 3), (32001, 3, 17, 7, 11)])
def test_synthetic_tokens_are_the_references(vocab, batch, seq, seed, step):
    want = JaxTokens(vocab, batch, seq, seed).batch_at(step)
    got = SyntheticTokens(vocab, batch, seq, seed).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k


def test_make_batch_with_prefix_is_the_references():
    prefix = np.random.default_rng(0).standard_normal((2, 3, 8)) \
        .astype(np.float32)
    want = jax_make_batch(JaxTokens(99, 2, 10), 5, prefix)
    got = make_batch(SyntheticTokens(99, 2, 10), 5, prefix)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------ loss, grads
def _loss_and_grads(cfg, tcfg, batch, seed=0):
    jp = jm.init_params(cfg, jax.random.PRNGKey(seed))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(cfg, p, jbatch), has_aux=True)(jp)
    tp = params_from_jax(_np_tree(jp), "cpu")
    tl, taux, tg = value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    return (jl, jaux, _flat(_np_tree(jg))), (tl, taux, tg), tp


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_grad_leaf_match_jax(case):
    arch, kw = CASES[case]
    cfg, tcfg = _cfgs(arch, **kw)
    (jl, jaux, jg), (tl, taux, tg), tp = _loss_and_grads(cfg, tcfg,
                                                         _batch(cfg))
    assert abs(float(tl) - float(jl)) <= LOSS_F32_TOL
    assert abs(float(taux["ce"]) - float(jaux["ce"])) <= LOSS_F32_TOL
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    names = sorted(_flat(tp))
    assert names == sorted(jg) and len(tg) == len(names)
    for name, g in zip(names, tg):
        assert g.dtype == torch.float32 and tuple(g.shape) == jg[name].shape
        assert _abs_tol_err(g, jg[name]) <= GRAD_TOL, name


@pytest.mark.parametrize("case", ["yi-6b", "yi-6b-sliding-window"])
def test_bf16_loss_matches_jax_and_grads_keep_the_param_dtype(case):
    arch, kw = CASES[case]
    cfg, tcfg = _cfgs(arch, "bfloat16", **kw)
    (jl, _, jg), (tl, _, tg), tp = _loss_and_grads(cfg, tcfg, _batch(cfg))
    assert abs(float(tl) - float(jl)) <= LOSS_BF16_TOL
    for name, g in zip(sorted(_flat(tp)), tg):
        assert str(g.dtype).split(".")[-1] == str(jg[name].dtype), name


def test_loss_with_prefix_embeds_matches_jax():
    cfg, tcfg = _cfgs()
    prefix = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)) \
        .astype(np.float32)
    batch = jax_make_batch(JaxTokens(cfg.vocab, 2, 32, seed=1), 0, prefix)
    (jl, _, jg), (tl, _, tg), tp = _loss_and_grads(cfg, tcfg, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_F32_TOL
    for name, g in zip(sorted(_flat(tp)), tg):
        assert _abs_tol_err(g, jg[name]) <= GRAD_TOL, name


@pytest.mark.parametrize("impl", ["blockwise", "banded"])
def test_attention_grads_with_blocks_recomputed_match_jax(impl):
    """Each KV block (blockwise) or query block (banded) is recomputed in
    backward; the gradients are the JAX code's, whose scan bodies are
    checkpointed the same way."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    kw = dict(window=12, impl=impl, kv_block=8, q_block=8)
    want = jax.grad(lambda q, k, v: jnp.sum(ja.attention(q, k, v, **kw) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (ta.attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for got, exp in zip((tq.grad, tk.grad, tv.grad), want):
        assert _abs_tol_err(got, exp) <= GRAD_TOL


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_remat_policies_give_the_grads_of_none(remat):
    cfg, tcfg = _cfgs()
    tp = params_from_jax(_np_tree(jm.init_params(cfg, jax.random.PRNGKey(0))),
                         "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    base = value_and_grad(tcfg.replace(remat="none"), tp, batch)
    got = value_and_grad(tcfg.replace(remat=remat), tp, batch)
    assert torch.equal(got[0], base[0])
    assert all(torch.equal(a, b) for a, b in zip(got[2], base[2]))


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b"])
def test_remat_outputs_gives_the_grads_of_none_and_of_jax(arch):
    """remat="outputs": the dense block checkpoints its attention and MLP
    sublayers each on its own (the tensors JAX names ``block_out``); the
    hybrid block names nothing, so there it saves what "nothing" saves.
    The loss and every grad leaf equal the port's "none" and are within
    the train step's tolerances of JAX's value_and_grad under "outputs"."""
    cfg, tcfg = _cfgs(arch, remat="outputs")
    batch = _batch(cfg)
    (jl, jaux, jg), (tl, taux, tg), tp = _loss_and_grads(cfg, tcfg, batch)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    base = value_and_grad(tcfg.replace(remat="none"), tp, tbatch)
    assert torch.equal(tl, base[0])
    assert all(torch.equal(a, b) for a, b in zip(tg, base[2]))
    assert abs(float(tl) - float(jl)) <= LOSS_F32_TOL
    names = sorted(_flat(tp))
    assert names == sorted(jg) and len(tg) == len(names)
    for name, g in zip(names, tg):
        assert _abs_tol_err(g, jg[name]) <= GRAD_TOL, name


def test_remat_outputs_recomputes_the_dense_sublayers(monkeypatch):
    """Under "outputs" the dense block's attention and MLP run twice a
    layer (forward, then recomputed in backward); under "none" once."""
    from repro_torch.models import blocks
    cfg, tcfg = _cfgs()
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    calls = []
    for name in ("_self_attention", "_mlp"):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    for remat, per_layer in (("none", 1), ("outputs", 2)):
        calls.clear()
        value_and_grad(tcfg.replace(remat=remat), tp, batch)
        assert sorted(calls) == sorted(
            ["_self_attention", "_mlp"] * per_layer * cfg.n_layers), remat


def test_backbone_grads_stack_each_leaf_once():
    """``backbone`` takes each stacked leaf's layers with one ``unbind``:
    its backward stacks the layers' grads once, where a ``select`` per
    layer would allocate a whole-leaf zero grad per layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shape = tuple(out.shape) if isinstance(out, torch.Tensor) \
                else None
            self.calls.append((func.__name__, shape))
            return out

    cfg, tcfg = _cfgs(n_layers=3)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, S=8).items()}
    with Ops() as ops:
        value_and_grad(tcfg, tp, batch)
    stacked = {tuple(v.shape) for v in _flat(tp["blocks"]).values()}
    n_block_leaves = len(_flat(tp["blocks"]))
    names = [n for n, _ in ops.calls]
    assert names.count("unbind.int") == n_block_leaves
    assert len([sh for n, sh in ops.calls if n == "stack.default"
                and sh in stacked]) == n_block_leaves
    assert not [sh for n, sh in ops.calls if n == "select_backward.default"
                and sh in stacked]


# ------------------------------------------------------------------ AdamW
def test_lr_schedule_matches_jax():
    acfg = jo.AdamWConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=200)
    tcfg = to.AdamWConfig(**dataclasses.asdict(acfg))
    for s in (0, 1, 5, 10, 11, 77, 200, 250):
        want = jo.lr_at(acfg, jnp.int32(s))
        got = to.lr_at(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _rel_err(got, want) <= ADAMW_REL_TOL, s


def test_apply_update_from_identical_grads_matches_jax():
    """Two updates (the bias corrections move), clipping active and weight
    decay on, from the same grads in both frameworks."""
    cfg, _ = _cfgs("yi-6b", "bfloat16")
    acfg = jo.AdamWConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=20,
                          weight_decay=0.1, grad_clip=1.0)
    tacfg = to.AdamWConfig(**dataclasses.asdict(acfg))
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    jopt = jo.init_opt_state(jp)
    tp = params_from_jax(_np_tree(jp), "cpu")
    topt = to.init_opt_state(tp)
    assert topt["step"].dtype == torch.int32 and topt["step"].dim() == 0
    assert all(v.dtype == torch.float32 for k in ("master", "m", "v")
               for v in _flat(topt[k]).values())
    assert topt["master"]["final_norm"].data_ptr() != \
        tp["final_norm"].data_ptr()
    rng = np.random.default_rng(2)
    for i in range(2):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5)
                         .astype(np.float32), _np_tree(jp))
        jp, jopt, jstats = jo.apply_update(acfg, jp, jopt, g)
        tp, topt, tstats = to.apply_update(tacfg, tp, topt,
                                           params_from_jax(g, "cpu"))
        assert int(topt["step"]) == int(jopt["step"]) == i + 1
        for k in ("lr", "grad_norm"):
            assert _rel_err(tstats[k], jstats[k]) <= ADAMW_REL_TOL, k
        for k in ("master", "m", "v"):
            want = _flat(_np_tree(jopt[k]))
            for name, t in _flat(topt[k]).items():
                assert _rel_err(t, want[name]) <= ADAMW_REL_TOL, (k, name)
        want = _flat(_np_tree(jp))
        for name, t in _flat(tp).items():
            assert t.dtype == params_from_jax(want[name], "cpu").dtype
            assert _rel_err(t, want[name]) <= ADAMW_REL_TOL, name


# -------------------------------------------------------------- train step
def test_train_step_matches_the_references_on_a_1x1_mesh():
    """microbatches=0: both take the auto count (2 for a batch of 4; the
    port reports it, and both report the last microbatch's loss)."""
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    cfg, tcfg = _cfgs()
    B, S = 4, 16
    batch = JaxTokens(cfg.vocab, B, S, seed=2).batch_at(0)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), "cpu")
    topt = to.init_opt_state(tp)
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh_context(mesh):
        jb = jax_train_step(cfg, JaxTrainConfig(), mesh, B, S)
        jp2, jopt2, jmet = jb.fn(jp, jo.init_opt_state(jp),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    bundle = make_train_step(tcfg, TrainConfig(), B, S, device="cpu")
    assert bundle.microbatches == 2
    tp2, topt2, tmet = bundle.fn(tp, topt, batch)
    assert tp2 is tp and topt2 is topt           # updated in place
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "grad_norm",
                                             "loss", "lr"]
    for k in ("loss", "ce"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_F32_TOL, k
    assert _rel_err(tmet["lr"], jmet["lr"]) <= ADAMW_REL_TOL
    assert _abs_tol_err(tmet["grad_norm"], jmet["grad_norm"]) <= GRAD_TOL
    want = _flat(_np_tree(jp2))
    for name, t in _flat(tp2).items():
        assert _abs_tol_err(t, want[name]) <= GRAD_TOL, name
    for k in ("master", "m", "v"):
        want = _flat(_np_tree(jopt2[k]))
        for name, t in _flat(topt2[k]).items():
            assert _abs_tol_err(t, want[name]) <= GRAD_TOL, (k, name)
    assert int(topt2["step"]) == int(jopt2["step"]) == 1


def test_grad_compression_is_read_nowhere_as_in_the_reference():
    """``grad_compression="int8_ef"``: the reference's step reads the field
    nowhere and trains uncompressed; the port's does the same, here on a
    1x1 mesh of each package, from the same weights (the tolerances of the
    1x1 test above)."""
    from repro.launch.mesh import make_mesh, mesh_context
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro_torch.launch.mesh import make_mesh as torch_mesh
    cfg, tcfg = _cfgs()
    B, S = 4, 16
    batch = JaxTokens(cfg.vocab, B, S, seed=2).batch_at(0)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_np_tree(jp), "cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh_context(mesh):
        jb = jax_train_step(cfg, JaxTrainConfig(grad_compression="int8_ef"),
                            mesh, B, S)
        jp2, jopt2, jmet = jb.fn(jp, jo.init_opt_state(jp),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    bundle = make_train_step(tcfg, TrainConfig(grad_compression="int8_ef"),
                             B, S, mesh=torch_mesh((1, 1), ("data", "model"),
                                                   device="cpu"))
    tp2, topt2, tmet = bundle.fn(tp, to.init_opt_state(tp), batch)
    tp2, topt2 = full_tree(tp2), full_tree(topt2)
    for k in ("loss", "ce"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_F32_TOL, k
    assert _rel_err(tmet["lr"], jmet["lr"]) <= ADAMW_REL_TOL
    assert _abs_tol_err(tmet["grad_norm"], jmet["grad_norm"]) <= GRAD_TOL
    want = _flat(_np_tree(jp2))
    for name, t in _flat(tp2).items():
        assert _abs_tol_err(t, want[name]) <= GRAD_TOL, name
    for k in ("master", "m", "v"):
        want = _flat(_np_tree(jopt2[k]))
        for name, t in _flat(topt2[k]).items():
            assert _abs_tol_err(t, want[name]) <= GRAD_TOL, (k, name)
    assert int(topt2["step"]) == int(jopt2["step"]) == 1


def test_grad_reduce_dtype_casts_the_accumulated_grads(monkeypatch):
    import repro_torch.train.step as step_mod
    seen = []

    def spy(cfg, params, opt_state, grads):
        seen.extend(g.dtype for g in grads)
        return params, opt_state, {}

    monkeypatch.setattr(step_mod, "apply_update", spy)
    cfg, tcfg = _cfgs()
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    bundle = make_train_step(tcfg, TrainConfig(grad_reduce_dtype="bfloat16"),
                             4, 16, device="cpu")
    bundle.fn(tp, to.init_opt_state(tp), _batch(cfg, B=4, S=16))
    assert seen and set(seen) == {torch.bfloat16}


# ------------------------------------------------------- checkpoint state
def _trained_state(steps=1):
    """A bf16 smoke model after ``steps`` JAX train steps: numpy params and
    optimizer state, as both managers take them."""
    cfg, _ = _cfgs("yi-6b", "bfloat16")
    acfg = jo.AdamWConfig(peak_lr=3e-3, warmup_steps=2)
    p = jm.init_params(cfg, jax.random.PRNGKey(0))
    o = jo.init_opt_state(p)
    for s in range(steps):
        b = {k: jnp.asarray(v) for k, v in _batch(cfg, step=s).items()}
        g = jax.grad(lambda p: jm.loss_fn(cfg, p, b)[0])(p)
        p, o, _ = jo.apply_update(acfg, p, o, g)
    return _np_tree(p), _np_tree(o)


def test_params_from_jax_carries_optimizer_state_bit_for_bit():
    p, o = _trained_state()
    got = params_from_jax(o, "cpu")
    assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
    for name, a in _flat(o).items():
        assert _bits(_flat(got)[name]) == _bits(a), name
    back = tree_to_numpy(params_from_jax(p, "cpu"), jnp.bfloat16)
    for name, a in _flat(p).items():
        assert _bits(_flat(back)[name]) == _bits(a), name


def _opt_layer(store, image, tag):
    manifest, _ = store.read_image(image, tag)
    for lid in manifest.layer_ids:
        layer = store.read_layer(lid, use_cache=False)
        if layer.instruction.text == "RUN opt_state":
            return layer
    raise AssertionError("no opt_state layer")


def test_opt_state_layer_matches_the_references(tmp_path):
    p, o = _trained_state()
    jmgr = JaxManager(str(tmp_path / "jax"), "yi-6b",
                      JaxPolicy(async_write=False, chunk_bytes=CHUNK))
    tmgr = CheckpointManager(str(tmp_path / "torch"), "yi-6b",
                             CheckpointPolicy(async_write=False,
                                              chunk_bytes=CHUNK))
    jmgr.save(1, p, o)
    tmgr.save(1, params_from_jax(p, "cpu"), params_from_jax(o, "cpu"))
    jl = _opt_layer(jmgr.store, "ckpt", jmgr.tag_of(1))
    tl = _opt_layer(tmgr.store, "ckpt", tmgr.tag_of(1))
    assert [r.to_json() for r in tl.records] == \
        [r.to_json() for r in jl.records]
    assert tl.checksum == jl.checksum
    names = {r.name: (r.dtype, tuple(r.shape)) for r in tl.records}
    assert names["opt/step"] == ("int32", ())
    assert names["opt/__step__"] == ("int32", (1,))
    assert names["opt/master/embed"][0] == "float32"


def test_port_checkpoint_with_opt_state_restores_through_jax(tmp_path):
    p, o = _trained_state()
    tmgr = CheckpointManager(str(tmp_path), "yi-6b",
                             CheckpointPolicy(async_write=False,
                                              use_fingerprints=True,
                                              chunk_bytes=CHUNK))
    tp, topt = params_from_jax(p, "cpu"), params_from_jax(o, "cpu")
    tmgr.save(1, tp, topt)
    jp, jo_, step = JaxManager(str(tmp_path), "yi-6b",
                               JaxPolicy(chunk_bytes=CHUNK)).restore()
    assert step == 1
    for tree, want in ((jp, tp), (jo_, topt)):
        got, want = _flat(tree), _flat(want)
        assert sorted(got) == sorted(want)
        for name in want:
            assert _bits(got[name]) == _bits(want[name]), name


def test_jax_checkpoint_with_opt_state_restores_through_the_port(tmp_path):
    p, o = _trained_state()
    JaxManager(str(tmp_path), "yi-6b",
               JaxPolicy(async_write=False, chunk_bytes=CHUNK)).save(1, p, o)
    tp, topt, step = CheckpointManager(
        str(tmp_path), "yi-6b", CheckpointPolicy(chunk_bytes=CHUNK)
    ).restore(device="cpu")
    assert step == 1 and topt["step"].dtype == torch.int32
    for tree, want in ((tp, p), (topt, o)):
        got, want = _flat(tree), _flat(want)
        assert sorted(got) == sorted(want)
        for name in want:
            assert _bits(got[name]) == _bits(want[name]), name


def test_async_save_then_a_step_restores_the_pre_step_state(tmp_path):
    """The optimizer updates in place, so the asynchronous save must hold
    the state it was given even when the next step runs at once."""
    cfg, tcfg = _cfgs("yi-6b", "bfloat16")
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    topt = to.init_opt_state(tp)
    bundle = make_train_step(tcfg, TrainConfig(adamw=to.AdamWConfig(
        peak_lr=3e-3, warmup_steps=1)), 2, 16, device="cpu")
    ds = SyntheticTokens(cfg.vocab, 2, 16)
    bundle.fn(tp, topt, ds.batch_at(0))
    mgr = CheckpointManager(str(tmp_path), cfg.name, CheckpointPolicy(
        async_write=True, use_fingerprints=True, chunk_bytes=CHUNK))
    want = {k: v.clone() for k, v in _flat({"p": tp, "o": topt}).items()}
    assert mgr.save(1, tp, topt).layers_built == 0   # the empty report
    bundle.fn(tp, topt, ds.batch_at(1))
    assert not torch.equal(_flat(tp)["final_norm"], want["p/final_norm"])
    report = mgr.wait()
    assert report.layers_built == 6
    rp, ro, step = mgr.restore(device="cpu")
    assert step == 1
    got = _flat({"p": rp, "o": ro})
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and \
            torch.equal(got[name], want[name]), name


def test_checkpoint_policy_has_the_references_fields_and_defaults():
    want = {f.name: f.default if f.default is not dataclasses.MISSING
            else f.default_factory() for f in dataclasses.fields(JaxPolicy)}
    got = {f.name: f.default if f.default is not dataclasses.MISSING
           else f.default_factory() for f in dataclasses.fields(
               CheckpointPolicy)}
    assert got == want
    # the quickstart's own policy
    policy = CheckpointPolicy(incremental=True, async_write=False)
    assert policy.async_write is False and policy.keep == 3


def test_per_leaf_fingerprints_are_refused():
    """No longer refused: ``packed_fingerprints=False`` is the per-leaf
    baseline, and its save equals the packed one (held against the JAX
    package in tests/test_torch_fingerprint.py)."""
    params = {"w": torch.arange(300, dtype=torch.float32)}
    reports = []
    for packed in (True, False):
        mgr = CheckpointManager(tempfile.mkdtemp(), "yi-6b", CheckpointPolicy(
            packed_fingerprints=packed, use_fingerprints=True,
            async_write=False, chunk_bytes=256))
        mgr.save(0, params, {})
        r = mgr.save(1, {"w": params["w"] * 2}, {})
        reports.append((r.layers_injected, r.chunks_written, r.bytes_d2h))
    assert reports[0] == reports[1] and reports[0][0] >= 1
