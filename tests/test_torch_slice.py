"""The port's whole serving slice on the CPU, and its interchange with the
JAX package:

port full save -> ``repro_torch.launch.serve`` restores and generates ->
k leaves change -> fingerprinted incremental save -> ``changed_tensor_paths``
names exactly those leaves -> sparse refresh -> tokens equal an engine built
on the updated weights. The same store, restored by the JAX
``CheckpointManager`` into a JAX ``Engine``, gives the same greedy tokens.

f32 weights, so greedy tokens compare exactly across the two frameworks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import CheckpointPolicy as JaxPolicy  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.manager import unflatten_tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import Engine, changed_tensor_paths  # noqa: E402

STEPS = 8


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    cfg = get_smoke_config("yi-6b").replace(param_dtype="float32",
                                            compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    params = params_from_jax(
        jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(3))),
        "cpu")
    mgr = CheckpointManager(root, cfg.name, CheckpointPolicy(
        use_fingerprints=True, chunk_bytes=2048))
    r0 = mgr.save(0, params, {})

    loaded, step = launch.load_params(tcfg, root, "cpu")
    prompts = launch.make_prompts(tcfg, 3, 10)
    eng, res0, _ = launch.serve(tcfg, loaded, prompts, STEPS, "cpu")

    new = dict(params)
    new["blocks"] = dict(params["blocks"])
    new["blocks"]["w_down"] = params["blocks"]["w_down"] * 1.5
    new["lm_head"] = params["lm_head"].clone()
    new["lm_head"][:, :50] += 0.3
    r1 = mgr.save(1, new, {})
    changed = changed_tensor_paths(mgr.store, mgr.image, mgr.tag_of(0),
                                   mgr.tag_of(1))
    names = sorted(n for n in changed if n.startswith("params/"))
    part = mgr.store.load_image_payload(mgr.image, mgr.tag_of(1), names=names)
    swapped = eng.refresh(
        unflatten_tree({k[len("params/"):]: v for k, v in part.items()}),
        changed={n[len("params/"):] for n in names}, step=1)
    res1 = eng.generate(prompts, STEPS)
    direct = Engine(tcfg, new, max_len=eng.max_len, device="cpu").generate(
        prompts, STEPS)
    return dict(root=root, cfg=cfg, mgr=mgr, r0=r0, r1=r1, step=step,
                res0=res0, res1=res1, direct=direct, changed=changed,
                part=part, swapped=swapped, prompts=prompts, eng=eng)


def test_restore_and_serve_from_the_store(slice_run):
    assert slice_run["step"] == 0
    assert slice_run["r0"].layers_built == 6
    toks = slice_run["res0"].tokens
    assert toks.shape == (3, STEPS)
    assert ((toks >= 0) & (toks < slice_run["cfg"].vocab)).all()


def test_incremental_save_injects(slice_run):
    r1 = slice_run["r1"]
    assert r1.layers_built == 0 and r1.layers_injected == 3
    assert r1.chunks_prefiltered > 0
    store = slice_run["mgr"].store
    assert store.verify_image("ckpt", slice_run["mgr"].tag_of(1)) == []


def test_sparse_plan_names_exactly_the_changed_leaves(slice_run):
    assert slice_run["changed"] == {"params/blocks/w_down",
                                    "params/lm_head", "opt/__step__"}
    assert sorted(slice_run["part"]) == ["params/blocks/w_down",
                                         "params/lm_head"]
    assert slice_run["swapped"] == 2


def test_sparse_refresh_serves_the_updated_weights(slice_run):
    np.testing.assert_array_equal(slice_run["res1"].tokens,
                                  slice_run["direct"].tokens)
    assert not np.array_equal(slice_run["res1"].tokens,
                              slice_run["res0"].tokens)


@pytest.mark.parametrize("step", [0, 1])
def test_jax_restores_the_ports_store_and_serves_the_same_tokens(
        slice_run, step):
    cfg = slice_run["cfg"]
    out = JaxManager(slice_run["root"], cfg.name,
                     JaxPolicy(async_write=False)).restore(step)
    assert out[2] == step
    jparams = jax.tree.map(jax.numpy.asarray, out[0])
    want = slice_run["res0"] if step == 0 else slice_run["res1"]
    got = JaxEngine(cfg, jparams, max_len=slice_run["eng"].max_len) \
        .generate(slice_run["prompts"], STEPS)
    np.testing.assert_array_equal(np.asarray(got.tokens), want.tokens)


def test_serve_cli_on_the_cpu(slice_run, capsys):
    launch.main(["--arch", "yi-6b", "--smoke", "--store", slice_run["root"],
                 "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                 "--steps", "3"])
    out = capsys.readouterr().out
    assert "loaded step-1" in out and "generated 6 tokens" in out
