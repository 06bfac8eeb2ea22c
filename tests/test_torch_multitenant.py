"""Multi-tenant checkpoints in the port against the JAX package:
``CheckpointManager(store=, base_image=)``, ``replicate()`` and retention
and ``gc`` across images.

Each package saves the same weights (made from a seed with numpy) into a
store of its own: a base image, and three tenants forked from it with the
edits of ``examples/serve_multitenant.py``. Layer and config ids are fresh
UUIDs, so they are compared by pattern (which of a tenant's layers reuse
the base's ids), never by value; everything else is held exactly: build
counters, the blobs each tenant adds, ``PushStats``/``FanoutStats`` of
each replication, and what retention and ``gc`` leave.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import CheckpointPolicy as JaxPolicy  # noqa: E402
from repro.core import LayerStore as JaxStore  # noqa: E402
from repro.core import push_delta as jax_push_delta  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import LayerStore, push_delta  # noqa: E402

CHUNK = 512
PKG = {"jax": (JaxManager, JaxPolicy, JaxStore, jax_push_delta),
       "torch": (CheckpointManager, CheckpointPolicy, LayerStore, push_delta)}


def base_params():
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((64, 16)).astype(ml_dtypes.bfloat16),
            "blocks": {"wq": rng.standard_normal((2, 16, 32))
                       .astype(ml_dtypes.bfloat16),
                       "norm": rng.standard_normal((2, 16))
                       .astype(np.float32)},
            "final_norm": rng.standard_normal(16).astype(np.float32),
            "lm_head": rng.standard_normal((16, 64))
            .astype(ml_dtypes.bfloat16)}


def tenant_edits(p):
    """The three tenants of examples/serve_multitenant.py."""
    e = p["embed"].astype(np.float32)
    return [("final_norm", p["final_norm"] * np.float32(2.0)),
            ("embed", (e + 0.5 * np.sign(e)).astype(ml_dtypes.bfloat16)),
            ("final_norm", p["final_norm"] * np.float32(0.5))]


def as_pkg(pkg, tree):
    return tree if pkg == "jax" else params_from_jax(tree, "cpu")


def blobs(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "blobs", "sha256")):
        for fn in files:
            with open(os.path.join(d, fn), "rb") as f:
                out[fn] = f.read()
    return out


def stats(x):
    """A stats dataclass as a dict, wall times and exceptions dropped."""
    if x is None:
        return None
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if f.name in ("wall_s", "exception", "backoff_total_s"):
            continue
        if dataclasses.is_dataclass(v):
            v = stats(v)
        elif isinstance(v, list):
            v = [stats(e) if dataclasses.is_dataclass(e) else e for e in v]
        out[f.name] = v
    return out


def fleet(pkg, root, keep=3):
    """-> (base manager, [tenant managers], per-tenant save records)."""
    Manager, Policy = PKG[pkg][:2]
    p = base_params()
    base = Manager(os.path.join(root, "train"), "toy",
                   Policy(async_write=False, use_fingerprints=True,
                          chunk_bytes=CHUNK, keep=keep), image="base-model")
    base.save(0, as_pkg(pkg, p), {})
    store, btag = base.store, base.tag_of(0)
    bm, _ = store.read_image("base-model", btag)
    tenants, records = [], []
    for i, (leaf, value) in enumerate(tenant_edits(p), start=1):
        policy = Policy(async_write=False, use_fingerprints=True,
                        chunk_bytes=CHUNK, keep=keep,
                        packed_fingerprints=i != 3)
        tm = Manager("", "toy", policy, image=f"tenant{i}",
                     base_image=("base-model", btag), store=store)
        before = set(blobs(store.root))
        rep = tm.save(0, as_pkg(pkg, {**p, leaf: value}), {})
        m, _ = store.read_image(tm.image, tm.tag_of(0))
        after = blobs(store.root)
        records.append({
            "reused": [a == b for a, b in zip(m.layer_ids, bm.layer_ids)],
            "report": {k: getattr(rep, k) for k in (
                "layers_built", "layers_cached", "chunks_written",
                "bytes_hashed", "chunks_prefiltered", "bytes_d2h")},
            "new_blobs": {h: after[h] for h in set(after) - before}})
        tenants.append(tm)
    return base, tenants, records


def test_tenants_reuse_the_bases_layers_as_the_reference(tmp_path):
    got = {pkg: fleet(pkg, str(tmp_path / pkg))[2] for pkg in PKG}
    assert got["torch"] == got["jax"]
    fn1, emb, fn3 = got["torch"]
    assert fn1["reused"] == fn3["reused"] == [True] * 3 + [False] * 3
    assert fn1["report"]["layers_cached"] == 3
    # embed misses, so blocks falls through: rebuilt, with no new blob
    assert emb["reused"] == [True] + [False] * 5
    assert emb["report"]["layers_cached"] == 1
    assert blobs(str(tmp_path / "torch" / "train")) == \
        blobs(str(tmp_path / "jax" / "train"))


def test_incremental_per_leaf_tenant_save_equals_the_reference(tmp_path):
    """The third tenant fingerprints per leaf (``packed_fingerprints=
    False``): its incremental save injects what the reference's does."""
    got = {}
    for pkg in PKG:
        _, tenants, _ = fleet(pkg, str(tmp_path / pkg))
        tm = tenants[2]
        p = base_params()
        p["final_norm"] = p["final_norm"] * np.float32(0.25)
        rep = tm.save(1, as_pkg(pkg, p), {})
        got[pkg] = {k: getattr(rep, k) for k in (
            "layers_built", "layers_injected", "chunks_written",
            "bytes_serialized", "chunks_prefiltered", "bytes_d2h")}
        assert tm.store.verify_image(tm.image, tm.tag_of(1)) == []
    assert got["torch"] == got["jax"]
    assert got["torch"]["layers_built"] == 0
    assert got["torch"]["layers_injected"] >= 1


def replicate_all(pkg, root):
    """Every shape ``replicate`` takes, for each tenant: one remote, a list,
    and a relay tier (its children nested as a dict)."""
    Store, push = PKG[pkg][2:]
    base, tenants, _ = fleet(pkg, os.path.join(root, "fleet"))
    seeded = [os.path.join(root, n) for n in ("r0", "r1", "mid")]
    for path in seeded:
        push(base.store, Store(path, chunk_bytes=CHUNK), "base-model",
             base.tag_of(0))
    out = []
    for tm in tenants:
        one = tm.replicate(remote=seeded[0])
        fan = tm.replicate(remote=[seeded[0], seeded[1]], step=0)
        relay = tm.replicate(relay={seeded[2]: [
            os.path.join(root, f"{tm.image}-edge"),
            {os.path.join(root, f"{tm.image}-mid2"):
             [os.path.join(root, f"{tm.image}-leaf")]}]})
        out.append((stats(one), stats(fan), stats(relay)))
        for path in seeded:
            assert Store(path).verify_image(tm.image, tm.tag_of(0)) == []
    return out


def test_replicate_stats_equal_the_references(tmp_path):
    got = {pkg: replicate_all(pkg, str(tmp_path / pkg)) for pkg in PKG}
    assert got["torch"] == got["jax"]
    one, fan, relay = got["torch"][0]
    # a final_norm tenant ships its one changed chunk to a base holder
    assert one["blobs_sent"] == 1
    # the fan: r0 already holds it from that push, r1 gets it
    assert fan["negotiation_rounds"] == 1
    assert [r["stats"]["blobs_sent"] for r in fan["replicas"]] == [0, 1]
    assert relay["replicas"][0]["children"] is not None


@pytest.mark.parametrize("pkg", list(PKG))
def test_replicate_refuses_what_the_reference_refuses(tmp_path, pkg):
    _, tenants, _ = fleet(pkg, str(tmp_path / "fleet"))
    tm = tenants[0]
    with pytest.raises(TypeError, match="bare path"):
        tm.replicate(relay={str(tmp_path / "mid"): str(tmp_path / "kid")})
    with pytest.raises(ValueError, match="destination"):
        tm.replicate()
    with pytest.raises(ValueError, match="relay"):
        tm.replicate(remote=str(tmp_path / "r"), source="commit")
    with pytest.raises(ValueError, match="relay"):
        tm.replicate(remote=[str(tmp_path / "r")], source="commit")


def retention(pkg, root):
    """Prune the base past its first step, then remove a tenant: what gc
    sweeps, and that every surviving image still verifies deep."""
    p = base_params()
    base, tenants, _ = fleet(pkg, root, keep=1)
    store = base.store
    p1 = {**p, "final_norm": p["final_norm"] * np.float32(3.0)}
    base.save(1, as_pkg(pkg, p1), {})          # keep=1: step 0 pruned
    pruned = sorted(store.list_tags("base-model"))
    after_prune = sorted(blobs(store.root))
    assert store.remove_image("tenant2", tenants[1].tag_of(0))
    swept = store.gc()
    survivors = {t.image: store.verify_image(t.image, t.tag_of(0), deep=True)
                 for t in (tenants[0], tenants[2])}
    return pruned, after_prune, swept, sorted(blobs(store.root)), survivors


def test_retention_and_gc_are_safe_across_images_as_the_reference(tmp_path):
    got = {pkg: retention(pkg, str(tmp_path / pkg)) for pkg in PKG}
    assert got["torch"] == got["jax"]
    pruned, after_prune, swept, left, survivors = got["torch"]
    assert pruned == ["step-00000001"]
    # the tenants forked from the pruned step still reach its blobs
    assert survivors == {"tenant1": [], "tenant3": []}
    assert swept["blobs_swept"] > 0 and set(left) < set(after_prune)
