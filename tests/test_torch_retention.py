"""Retention against the JAX package: ``prune_steps`` after every save,
``remove_image``, ``list_images`` and the store's mark-and-sweep ``gc``.

Both managers save the same states (a bf16 smoke model and its AdamW
state, trained by JAX and carried over bit for bit), and the two stores
must end with the same step tags and the same blobs on disk, byte for
byte. Every comparison here is exact.
"""
import os
import shutil

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
from repro.ckpt.manager import prune_steps as jax_prune_steps  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core import LayerStore as JaxStore  # noqa: E402
from repro.data import SyntheticTokens  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.manager import prune_steps  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import LayerStore  # noqa: E402

CHUNK = 4096


@pytest.fixture(scope="module")
def states():
    """Four successive (params, opt_state) numpy trees of a bf16 smoke
    model under AdamW."""
    cfg = get_smoke_config("yi-6b")
    acfg = jo.AdamWConfig(peak_lr=3e-3, warmup_steps=2)
    ds = SyntheticTokens(cfg.vocab, 2, 16, seed=3)
    p = jm.init_params(cfg, jax.random.PRNGKey(0))
    o = jo.init_opt_state(p)
    out = []
    for s in range(4):
        b = {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()}
        g = jax.grad(lambda p: jm.loss_fn(cfg, p, b)[0])(p)
        p, o, _ = jo.apply_update(acfg, p, o, g)
        out.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)))
    return out


def _blobs(root):
    out = set()
    for d, _, files in os.walk(os.path.join(root, "blobs", "sha256")):
        for fn in files:
            with open(os.path.join(d, fn), "rb") as f:
                out.add((fn, f.read()))
    return out


def _files(root, sub):
    return sorted(os.listdir(os.path.join(root, sub)))


@pytest.mark.parametrize("policy", [
    dict(incremental=True, use_fingerprints=True),
    dict(incremental=True, use_fingerprints=False),
    dict(incremental=False, use_fingerprints=True),
], ids=["fingerprints", "host_diff", "full_builds"])
def test_keep_two_leaves_the_references_tags_and_blobs(tmp_path, states,
                                                       policy):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmgr = JaxManager(jroot, "yi-6b", JaxPolicy(
        keep=2, async_write=False, chunk_bytes=CHUNK, **policy))
    tmgr = CheckpointManager(troot, "yi-6b", CheckpointPolicy(
        keep=2, async_write=False, chunk_bytes=CHUNK, **policy))
    for step, (p, o) in enumerate(states, start=1):
        jmgr.save(step, p, o)
        tmgr.save(step, params_from_jax(p, "cpu"), params_from_jax(o, "cpu"))
        assert tmgr.store.list_tags("ckpt") == jmgr.store.list_tags("ckpt")
    assert tmgr.store.list_tags("ckpt") == [tmgr.tag_of(3), tmgr.tag_of(4)]
    assert _blobs(troot) == _blobs(jroot)
    assert len(_files(troot, "layers")) == len(_files(jroot, "layers"))
    assert len(_files(troot, "images/ckpt")) == \
        len(_files(jroot, "images/ckpt"))
    for step in (3, 4):
        assert tmgr.store.verify_image("ckpt", tmgr.tag_of(step)) == []


def test_async_saves_prune_after_each_commit(tmp_path, states):
    tmgr = CheckpointManager(str(tmp_path), "yi-6b", CheckpointPolicy(
        keep=2, async_write=True, use_fingerprints=True, chunk_bytes=CHUNK))
    for step, (p, o) in enumerate(states, start=1):
        tmgr.save(step, params_from_jax(p, "cpu"), params_from_jax(o, "cpu"))
    tmgr.wait()
    assert tmgr.store.list_tags("ckpt") == [tmgr.tag_of(3), tmgr.tag_of(4)]
    _, _, step = tmgr.restore(device="cpu")
    assert step == 4


def _user_tag(root, tag, as_tag):
    d = os.path.join(root, "images", "ckpt")
    shutil.copy(os.path.join(d, f"{tag}.json"), os.path.join(d, f"{as_tag}.json"))


def test_prune_spares_user_tags_and_what_they_reach(tmp_path, states):
    """Tags that are not canonical step tags ("best", a hand-pushed
    "step-9") are never retention candidates, in either package, and the
    sweep keeps every blob they reach."""
    roots = {}
    for name, mgr_cls, pol_cls, prune in (
            ("jax", JaxManager, JaxPolicy, jax_prune_steps),
            ("torch", CheckpointManager, CheckpointPolicy, prune_steps)):
        root = str(tmp_path / name)
        mgr = mgr_cls(root, "yi-6b", pol_cls(keep=0, async_write=False,
                                              chunk_bytes=CHUNK))
        for step, (p, o) in enumerate(states[:3], start=1):
            if name == "torch":
                p, o = params_from_jax(p, "cpu"), params_from_jax(o, "cpu")
            mgr.save(step, p, o)
        _user_tag(root, mgr.tag_of(1), "best")
        _user_tag(root, mgr.tag_of(2), "step-9")
        assert prune(mgr.store, "ckpt", 1) is True
        assert prune(mgr.store, "ckpt", 1) is False
        assert mgr.store.list_tags("ckpt") == ["best", mgr.tag_of(3),
                                               "step-9"]
        for tag in ("best", "step-9"):
            assert mgr.store.verify_image("ckpt", tag) == []
        roots[name] = root
    assert _blobs(roots["torch"]) == _blobs(roots["jax"])


def test_gc_keeps_what_another_image_reaches(tmp_path, states):
    """Two images in one store share blobs; removing one image's only tag
    sweeps exactly what no other image reaches, as the reference does."""
    stats = {}
    for name, mgr_cls, pol_cls in (("jax", JaxManager, JaxPolicy),
                                   ("torch", CheckpointManager,
                                    CheckpointPolicy)):
        root = str(tmp_path / name)
        for image, (p, o) in (("a", states[0]), ("b", states[1])):
            if name == "torch":
                p, o = params_from_jax(p, "cpu"), params_from_jax(o, "cpu")
            mgr = mgr_cls(root, "yi-6b", pol_cls(async_write=False,
                                                  chunk_bytes=CHUNK),
                          image=image)
            mgr.save(1, p, o)
        store = LayerStore(root, chunk_bytes=CHUNK) if name == "torch" \
            else JaxStore(root, chunk_bytes=CHUNK)
        assert store.list_images() == ["a", "b"]
        assert store.remove_image("a", "step-00000001") is True
        assert store.remove_image("a", "step-00000001") is False
        stats[name] = store.gc()
        assert store.verify_image("b", "step-00000001") == []
        assert store.gc()["blobs_swept"] == 0
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["blobs_swept"] > 0
    assert _blobs(str(tmp_path / "torch")) == _blobs(str(tmp_path / "jax"))


def test_gc_spares_an_open_batch_transaction(tmp_path):
    """A blob written in batch durability but not yet committed belongs to
    an in-flight save: gc must not sweep it until the commit flushes it;
    after that, unreferenced, it goes."""
    from repro_torch.core import sha256_hex
    store = LayerStore(str(tmp_path), chunk_bytes=CHUNK, durability="batch")
    data = b"in-flight chunk"
    h = sha256_hex(data)
    assert store.write_blob(h, data)
    assert store.gc()["blobs_swept"] == 0 and store.has_blob(h)
    store.sync_for_commit()
    assert store.gc()["blobs_swept"] == 1 and not store.has_blob(h)
