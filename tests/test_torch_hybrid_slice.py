"""The serving slice on the hybrid family (hymba-1.5b's smoke config, f32),
on the CPU, and its interchange with the JAX package:

greedy tokens equal the JAX ``Engine``'s; then port full save ->
``repro_torch.launch.serve`` restores and generates -> one layer of the
nested ``blocks/ssm/w_x`` and ``final_norm`` change -> fingerprinted
incremental save (injected, not rebuilt) -> ``changed_tensor_paths`` names
exactly those leaves -> sparse refresh (bit-identical to a full reload) ->
tokens equal an engine built on the updated weights. The same store,
restored by the JAX ``CheckpointManager`` into a JAX ``Engine``, gives the
same greedy tokens.

The prompt (20 tokens) is longer than the smoke window (16): prefill takes
the banded attention path and decode wraps the KV ring, while the SSM
states pass through the splice unchanged.
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
PROMPT = 20
EDIT = "blocks/ssm/w_x"


def _edited(params):
    """One layer of the nested ssm/w_x, and final_norm: copy on write."""
    new = dict(params)
    new["blocks"] = dict(params["blocks"])
    new["blocks"]["ssm"] = dict(params["blocks"]["ssm"])
    w = params["blocks"]["ssm"]["w_x"].clone()
    w[1] += 0.05
    new["blocks"]["ssm"]["w_x"] = w
    new["final_norm"] = params["final_norm"] * 1.5
    return new


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hybrid"))
    cfg = get_smoke_config("hymba-1.5b").replace(param_dtype="float32",
                                                 compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    jparams = init_params(cfg, jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    mgr = CheckpointManager(root, cfg.name, CheckpointPolicy(
        use_fingerprints=True, chunk_bytes=2048, async_write=False))
    r0 = mgr.save(0, params, {})

    loaded, step = launch.load_params(tcfg, root, "cpu")
    prompts = launch.make_prompts(tcfg, 3, PROMPT)
    eng, res0, _ = launch.serve(tcfg, loaded, prompts, STEPS, "cpu")

    new = _edited(params)
    r1 = mgr.save(1, new, {})
    changed = changed_tensor_paths(mgr.store, mgr.image, mgr.tag_of(0),
                                   mgr.tag_of(1))
    names = sorted(n for n in changed if n.startswith("params/"))
    part = mgr.store.load_image_payload(mgr.image, mgr.tag_of(1), names=names)
    swapped = eng.refresh(
        unflatten_tree({k[len("params/"):]: v for k, v in part.items()}),
        changed={n[len("params/"):] for n in names}, step=1)
    res1 = eng.generate(prompts, STEPS)
    direct = Engine(tcfg, new, max_len=eng.max_len, device="cpu")
    return dict(root=root, cfg=cfg, tcfg=tcfg, jparams=jparams, loaded=loaded,
                params=params, new=new, mgr=mgr, r0=r0, r1=r1, step=step,
                res0=res0, res1=res1, direct=direct,
                direct_res=direct.generate(prompts, STEPS), changed=changed,
                part=part, swapped=swapped, prompts=prompts, eng=eng)


def test_greedy_tokens_match_jax_engine(hybrid):
    want = JaxEngine(hybrid["cfg"], hybrid["jparams"],
                     max_len=hybrid["eng"].max_len).generate(
        hybrid["prompts"], STEPS)
    np.testing.assert_array_equal(hybrid["res0"].tokens, want.tokens)
    assert np.abs(hybrid["res0"].logits_last
                  - np.asarray(want.logits_last)).max() < 1e-4


def test_restore_and_serve_from_the_store(hybrid):
    assert hybrid["step"] == 0
    assert hybrid["r0"].layers_built == 6
    toks = hybrid["res0"].tokens
    assert toks.shape == (3, STEPS)
    assert ((toks >= 0) & (toks < hybrid["cfg"].vocab)).all()


def test_incremental_save_of_a_nested_leaf_injects(hybrid):
    r1 = hybrid["r1"]
    assert r1.layers_built == 0 and r1.layers_injected == 3
    assert r1.chunks_prefiltered > 0
    mgr = hybrid["mgr"]
    assert mgr.store.verify_image("ckpt", mgr.tag_of(1)) == []


def test_sparse_plan_names_exactly_the_nested_leaf(hybrid):
    assert hybrid["changed"] == {f"params/{EDIT}", "params/final_norm",
                                 "opt/__step__"}
    assert sorted(hybrid["part"]) == [f"params/{EDIT}", "params/final_norm"]
    assert hybrid["swapped"] == 2


def test_sparse_refresh_is_bit_identical_to_a_full_reload(hybrid):
    full = dict(_leaf_items(hybrid["direct"].params))
    sparse = dict(_leaf_items(hybrid["eng"].params))
    assert sorted(full) == sorted(sparse)
    for k in full:
        assert torch.equal(full[k], sparse[k]), k
    # the untouched leaves of the edited subtree stay shared with the
    # restored tree; the edited one is new
    loaded = hybrid["loaded"]["blocks"]["ssm"]
    assert sparse["blocks/ssm/w_z"] is loaded["w_z"]
    assert sparse["blocks/ssm/w_x"] is not loaded["w_x"]
    np.testing.assert_array_equal(hybrid["res1"].tokens,
                                  hybrid["direct_res"].tokens)
    assert not np.array_equal(hybrid["res1"].tokens, hybrid["res0"].tokens)


@pytest.mark.parametrize("step", [0, 1])
def test_jax_restores_the_ports_store_and_serves_the_same_tokens(
        hybrid, step):
    cfg = hybrid["cfg"]
    out = JaxManager(hybrid["root"], cfg.name,
                     JaxPolicy(async_write=False)).restore(step)
    assert out[2] == step
    jparams = jax.tree.map(jax.numpy.asarray, out[0])
    want = hybrid["res0"] if step == 0 else hybrid["res1"]
    got = JaxEngine(cfg, jparams, max_len=hybrid["eng"].max_len) \
        .generate(hybrid["prompts"], STEPS)
    np.testing.assert_array_equal(np.asarray(got.tokens), want.tokens)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_serve_cli_on_the_cpu(arch, capsys):
    launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "6", "--steps", "3"])
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out


def _leaf_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]
