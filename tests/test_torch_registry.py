"""The port's delta registry against the JAX package's, on the same stores.

Each comparison starts from two byte-identical copies (``shutil.copytree``)
of one trainer store and one replica store: the JAX registry works on one
copy, the port's on the other. Everything the registry reports is exact,
so every count is held bit for bit (wall times excluded): ``PushStats``,
``FanoutStats``, ``RepairReport``, the replica left on disk, the bytes of
``export_delta`` and of ``encode_index``, and the mutation gate's verdict.
The stores interchange: either package's store is the other's peer.
"""
import ast
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.ft as JF  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

CHUNK = 512
IMAGE = "ckpt"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tag(step):
    return f"step-{step:08d}"


def states(n, seed=0):
    """``n`` successive numpy param trees (bf16 and f32 leaves, a nested
    subtree), each save editing a few elements of two leaves."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        u = rng.standard_normal(shape).astype(np.float32).view(np.uint32)
        return (u >> 16).astype(np.uint16).view(jnp.bfloat16)

    p = {"embed": bf16(48, 32),
         "blocks": {"wq": bf16(2, 32, 32), "attn": {"wk": bf16(2, 32, 16)},
                    "norm": rng.standard_normal((2, 32)).astype(np.float32)},
         "final_norm": rng.standard_normal(32).astype(np.float32),
         "lm_head": bf16(32, 48)}
    out = [p]
    for k in range(1, n):
        q = {**p, "blocks": {**p["blocks"],
                             "attn": dict(p["blocks"]["attn"])}}
        wq = p["blocks"]["wq"].copy()
        wq[k % 2, k, :] = wq[k % 2, k + 1, :]
        q["blocks"]["wq"] = wq
        q["final_norm"] = p["final_norm"] * np.float32(1.5)
        out.append(q)
        p = q
    return out


def port_saves(root, trees, registry=None):
    mgr = CheckpointManager(root, "tiny", CheckpointPolicy(
        use_fingerprints=True, chunk_bytes=CHUNK, async_write=False,
        keep=len(trees) + 1), registry=registry)
    for step, p in enumerate(trees):
        mgr.save(step, params_from_jax(p, "cpu"), {})
    return mgr


def stats(x):
    """A stats dataclass as a dict, wall times dropped, nested ones too."""
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


def snapshot(root):
    """Every file under a store's root except in-flight temporaries, as
    {relative path: bytes}."""
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            if ".tmp." in fn:
                continue
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A trainer store with four saves, and a replica holding step 1."""
    base = tmp_path_factory.mktemp("registry")
    src = str(base / "src")
    port_saves(src, states(4))
    rep = str(base / "rep")
    T.pull_delta(T.LayerStore(src, chunk_bytes=CHUNK),
                 T.LayerStore(rep, chunk_bytes=CHUNK), IMAGE, tag(1))
    return base, src, rep


def two_copies(stores, tmp_path):
    _, src, rep = stores
    out = []
    for side in ("jax", "torch"):
        d = tmp_path / side
        shutil.copytree(src, d / "src")
        shutil.copytree(rep, d / "rep")
        out.append((str(d / "src"), str(d / "rep")))
    return out


@pytest.mark.parametrize("op", ["pull_delta", "push_delta"])
def test_delta_transfer_stats_and_replica_equal(stores, tmp_path, op):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    got_j = getattr(J, op)(J.LayerStore(js, chunk_bytes=CHUNK),
                           J.LayerStore(jr, chunk_bytes=CHUNK), IMAGE, tag(3))
    got_t = getattr(T, op)(T.LayerStore(ts, chunk_bytes=CHUNK),
                           T.LayerStore(tr, chunk_bytes=CHUNK), IMAGE, tag(3))
    assert stats(got_t) == stats(got_j)
    assert got_t.blobs_sent > 0 and got_t.layers_deep_verified > 0
    assert snapshot(tr) == snapshot(jr)
    assert J.LayerStore(tr).verify_image(IMAGE, tag(3), deep=True) == []


def test_replicate_fanout_stats_equal(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    out = []
    for pkg, s, r in ((J, js, jr), (T, ts, tr)):
        fresh = os.path.join(os.path.dirname(r), "fresh")
        fan = pkg.replicate_fanout(
            pkg.LayerStore(s, chunk_bytes=CHUNK),
            [pkg.LayerStore(r, chunk_bytes=CHUNK),
             pkg.LayerStore(fresh, chunk_bytes=CHUNK)], IMAGE, tag(3))
        assert fan.ok and fan.negotiation_rounds == 1
        out.append((stats(fan), snapshot(r), snapshot(fresh)))
    assert out[1] == out[0]


def _mutate_in_place(root):
    """The naive bypass the gate exists for: edit the blocks layer of step
    3 under its SAME id (one chunk swapped, checksum recomputed) and
    re-lock the image around it, as an in-place edit of a committed layer
    would. The source still verifies; only the ids give the edit away."""
    st = J.LayerStore(root, chunk_bytes=CHUNK)
    m, config = st.read_image(IMAGE, tag(3))
    parent = None
    for lid in m.layer_ids:
        layer = st.read_layer(lid)
        if layer.instruction.arg == "params/blocks":
            rec = next(r for r in layer.records if len(r.chunks) > 1)
            swapped = dataclasses.replace(
                rec, chunks=(rec.chunks[1], rec.chunks[0]) + rec.chunks[2:])
            layer.records = [swapped if r is rec else r
                             for r in layer.records]
            layer.checksum = J.content_checksum(layer.records)
        layer.chain = J.chain_checksum(parent, layer.checksum,
                                       layer.instruction.text)
        parent = layer.chain
        st.write_layer(layer)
        config.layer_checksums[lid] = layer.checksum
        config.layer_chains[lid] = layer.chain
    st.write_image(m, config)
    assert st.verify_image(IMAGE, tag(3), deep=True) == []


def test_mutation_gate_rejects_the_same_mutation(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    for pkg, s, r in ((J, js, jr), (T, ts, tr)):
        pkg.push_delta(pkg.LayerStore(s, chunk_bytes=CHUNK),
                       pkg.LayerStore(r, chunk_bytes=CHUNK), IMAGE, tag(3))
    _mutate_in_place(js)
    _mutate_in_place(ts)
    errors = []
    for pkg, s, r in ((J, js, jr), (T, ts, tr)):
        with pytest.raises(pkg.PushRejected) as e:
            pkg.push_delta(pkg.LayerStore(s, chunk_bytes=CHUNK),
                           pkg.LayerStore(r, chunk_bytes=CHUNK), IMAGE,
                           tag(3))
        errors.append(str(e.value).replace(s, "<src>").replace(r, "<rep>"))
    assert errors[0] == errors[1]
    assert "in-place mutation" in errors[1]


@pytest.mark.parametrize("base", [None, 1])
def test_export_delta_bytes_equal(stores, base):
    _, src, _ = stores
    kw = {} if base is None else {"base_tag": tag(base)}
    data_j = J.export_delta(J.LayerStore(src, chunk_bytes=CHUNK), IMAGE,
                            tag(3), **kw)
    data_t = T.export_delta(T.LayerStore(src, chunk_bytes=CHUNK), IMAGE,
                            tag(3), **kw)
    assert data_t == data_j
    assert T.decode_delta(data_t).manifest.tag == tag(3)


@pytest.mark.parametrize("key", [b"", b"shared-secret"])
def test_encode_index_bytes_equal(stores, tmp_path, key):
    _, src, _ = stores
    reg = T.PassiveRegistry(str(tmp_path / "reg"), key=key)
    idx = reg.publish_image(T.LayerStore(src, chunk_bytes=CHUNK), IMAGE,
                            tag(3), from_tags=[tag(2), tag(0)])
    j_idx = J.BundleIndex(
        image=idx.image, head=idx.head, generation=idx.generation,
        entries=[J.BundleEntry(**dataclasses.asdict(e))
                 for e in idx.entries])
    data = T.encode_index(idx, key)
    assert data == J.encode_index(j_idx, key)
    assert J.decode_index(data, key) == j_idx
    # the JAX registry reads the port's published index and bundles
    j_reg = J.PassiveRegistry(str(tmp_path / "reg"), key=key)
    assert j_reg.read_index(IMAGE) == j_idx
    for e in j_idx.entries:
        assert j_reg.fetch_bundle(IMAGE, e) == reg.fetch_bundle(IMAGE, e)


def test_squash_deltas_bundle_equal(stores):
    _, src, _ = stores
    bj = J.squash_deltas(J.LayerStore(src, chunk_bytes=CHUNK), IMAGE,
                         tag(0), tag(3))
    bt = T.squash_deltas(T.LayerStore(src, chunk_bytes=CHUNK), IMAGE,
                         tag(0), tag(3))
    assert T.encode_delta(bt) == J.encode_delta(bj)
    assert T.verify_squashed_bundle(T.LayerStore(src, chunk_bytes=CHUNK),
                                    bt) == []


def test_import_delta_stats_equal(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    data = T.export_delta(T.LayerStore(ts, chunk_bytes=CHUNK), IMAGE, tag(3),
                          base_tag=tag(1))
    got_j = J.import_delta(J.LayerStore(jr, chunk_bytes=CHUNK), data)
    got_t = T.import_delta(T.LayerStore(tr, chunk_bytes=CHUNK), data)
    assert stats(got_t) == stats(got_j)
    assert snapshot(tr) == snapshot(jr)


def test_relay_fanout_stats_equal(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    out = []
    for pkg, s, r in ((J, js, jr), (T, ts, tr)):
        edge = os.path.join(os.path.dirname(r), "edge")
        relay = pkg.RelayNode(pkg.LayerStore(r, chunk_bytes=CHUNK),
                              children=[pkg.LayerStore(edge,
                                                       chunk_bytes=CHUNK)])
        fan = pkg.replicate_fanout(pkg.LayerStore(s, chunk_bytes=CHUNK),
                                   [relay], IMAGE, tag(3))
        assert fan.ok and fan.replicas[0].children.ok
        out.append((stats(fan), snapshot(r), snapshot(edge)))
    assert out[1] == out[0]


def test_repair_report_equal_after_the_same_bitrot(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    reports = []
    for pkg, fpkg, s, r in ((J, JF, js, jr), (T, TF, ts, tr)):
        flipped = fpkg.inject_bitrot(r, seed=7, count=2)
        assert len(flipped) == 2
        st = pkg.LayerStore(r, chunk_bytes=CHUNK)
        assert st.verify_image(IMAGE, tag(1), deep=True) != []
        rep = pkg.repair_image(st, IMAGE, tag(1),
                               peers=[pkg.LayerStore(s, chunk_bytes=CHUNK)])
        assert rep.verified_clean
        d = stats(rep)
        d["peer_used"] = {h: v.replace(s, "<src>")
                          for h, v in d["peer_used"].items()}
        reports.append((flipped, d, st.quarantined_blobs()))
    assert reports[1] == reports[0]
    assert snapshot(tr) == snapshot(jr)


def _fault_names(root):
    names = set()
    for d, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(d, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and \
                        getattr(node.func, "id", None) == "fault_point" and \
                        node.args and isinstance(node.args[0], ast.Constant):
                    names.add(node.args[0].value)
    return names


def test_fault_point_names_are_the_references():
    ref = set()
    for sub in ("core", "ft", "serve", "ckpt"):
        ref |= _fault_names(os.path.join(ROOT, "src", "repro", sub))
    port = _fault_names(os.path.join(ROOT, "src", "repro_torch"))
    assert port == ref
    assert {"wire.negotiate", "store.write_blob", "follower.pull",
            "relay.fan", "bundle.fetch", "repair.pull"} <= port


def test_each_package_arms_only_its_own_faults(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    spec = dict(point="wire.negotiate", mode="drop", times=None)
    with TF.inject(0, TF.FaultSpec(**spec)) as inj:
        J.pull_delta(J.LayerStore(js, chunk_bytes=CHUNK),
                     J.LayerStore(jr, chunk_bytes=CHUNK), IMAGE, tag(2))
        with pytest.raises(ConnectionError):
            T.pull_delta(T.LayerStore(ts, chunk_bytes=CHUNK),
                         T.LayerStore(tr, chunk_bytes=CHUNK), IMAGE, tag(2))
        assert inj.fired("wire.negotiate") == 1
    with JF.inject(0, JF.FaultSpec(**spec)):
        T.pull_delta(T.LayerStore(ts, chunk_bytes=CHUNK),
                     T.LayerStore(tr, chunk_bytes=CHUNK), IMAGE, tag(2))
    assert T.LayerStore(tr).has_image(IMAGE, tag(2))


def test_retry_converges_a_dropped_commit_as_the_reference(stores, tmp_path):
    (js, jr), (ts, tr) = two_copies(stores, tmp_path)
    out = []
    for pkg, fpkg, s, r in ((J, JF, js, jr), (T, TF, ts, tr)):
        policy = fpkg.RetryPolicy(max_attempts=3, base_delay_s=0.0, seed=1)
        with fpkg.inject(3, fpkg.FaultSpec("wire.commit", "drop",
                                           times=1)) as inj:
            fan = pkg.replicate_fanout(
                pkg.LayerStore(s, chunk_bytes=CHUNK),
                [pkg.LayerStore(r, chunk_bytes=CHUNK)], IMAGE, tag(3),
                retry=policy)
        assert fan.ok and inj.fired() == 1
        h = fan.replicas[0].health
        out.append((fan.retries_spent, h.attempts, h.succeeded,
                    [e.split(" (")[0] for e in h.errors],
                    stats(fan.replicas[0].stats)))
    assert out[1] == out[0]
    assert out[1][0] == 1


def test_retry_schedule_is_the_references():
    for seed in range(3):
        jp = JF.RetryPolicy(seed=seed, jitter=0.3)
        tp = TF.RetryPolicy(seed=seed, jitter=0.3)
        assert [tp.backoff(n) for n in range(8)] == \
            [jp.backoff(n) for n in range(8)]
