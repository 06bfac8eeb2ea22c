"""Store parity: the same weights saved by the JAX ``CheckpointManager`` and
by the port's, into two stores — a full save, then a fingerprinted
incremental save after a few leaves change — give equal records, chunk
hashes, content and chain checksums, blob sets and save reports. Each
package restores the other's checkpoints bit for bit.

Layer ids and config ids are fresh UUIDs, so they are never compared.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import CheckpointPolicy as JaxPolicy  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_to_numpy  # noqa: E402

CHUNK = 1024


def _np_params(param_dtype="bfloat16"):
    cfg = get_smoke_config("yi-6b").replace(param_dtype=param_dtype)
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))


def _changed(p):
    """k = 2 leaves change: one layer of blocks/wk, and final_norm."""
    p1 = jax.tree.map(lambda a: a, p)
    p1["blocks"] = dict(p["blocks"])
    wk = p["blocks"]["wk"].copy()
    wk[1] = (wk[1].astype(np.float32) + 0.5).astype(wk.dtype)
    p1["blocks"]["wk"] = wk
    p1["final_norm"] = p["final_norm"] * np.float32(1.5)
    return p1


def _managers(tmp_path):
    jm = JaxManager(str(tmp_path / "jax"), "yi-6b",
                    JaxPolicy(async_write=False, use_fingerprints=True,
                              chunk_bytes=CHUNK, keep=10))
    tm = CheckpointManager(str(tmp_path / "torch"), "yi-6b",
                           CheckpointPolicy(use_fingerprints=True,
                                            chunk_bytes=CHUNK,
                                            async_write=False))
    return jm, tm


def _layers(store, image, tag):
    manifest, config = store.read_image(image, tag)
    out = []
    for lid in manifest.layer_ids:
        layer = store.read_layer(lid, use_cache=False)
        out.append({"records": [r.to_json() for r in layer.records],
                    "checksum": layer.checksum, "chain": layer.chain,
                    "instruction": layer.instruction.to_json(),
                    "empty": layer.empty, "version": layer.version,
                    "lock": (config.layer_checksums[lid],
                             config.layer_chains[lid])})
    return out


def _blobs(root):
    out = set()
    for d, _, files in os.walk(os.path.join(root, "blobs", "sha256")):
        for fn in files:
            with open(os.path.join(d, fn), "rb") as f:
                out.add((fn, f.read()))
    return out


_REPORT = ("layers_built", "layers_cached", "layers_injected",
           "layers_rekeyed", "bytes_serialized", "bytes_hashed",
           "chunks_written", "derivations_run", "bytes_d2h",
           "chunks_prefiltered", "rekey_walks", "manifest_commits")


def _report(r):
    return {k: getattr(r, k) for k in _REPORT}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("stores")
    p0 = _np_params()
    p1 = _changed(p0)
    jm, tm = _managers(tmp_path)
    reports = []
    for step, p in ((0, p0), (1, p1)):
        rj = jm.save(step, p, {})
        rt = tm.save(step, params_from_jax(p, "cpu"), {})
        reports.append((rj, rt))
    return tmp_path, jm, tm, p0, p1, reports


@pytest.mark.parametrize("step", [0, 1])
def test_layers_records_and_checksums_match(saved, step):
    _, jm, tm, *_ = saved
    assert _layers(tm.store, "ckpt", tm.tag_of(step)) == \
        _layers(jm.store, "ckpt", jm.tag_of(step))


def test_blob_sets_match(saved):
    tmp_path, *_ = saved
    assert _blobs(str(tmp_path / "torch")) == _blobs(str(tmp_path / "jax"))


@pytest.mark.parametrize("step", [0, 1])
def test_save_reports_match(saved, step):
    rj, rt = saved[5][step]
    assert _report(rt) == _report(rj)


def test_incremental_save_injects_only_changed_chunks(saved):
    _, _, tm, p0, *_ = saved
    _, rt = saved[5][1]
    total = sum(len(r["chunks"]) for layer in _layers(
        tm.store, "ckpt", tm.tag_of(1)) for r in layer["records"])
    assert rt.bytes_d2h == 8 * total
    # blocks, head (final_norm) and opt (the step counter) layers
    assert rt.layers_injected == 3 and rt.layers_built == 0
    wk_layer_bytes = p0["blocks"]["wk"][1].nbytes
    assert rt.chunks_written == wk_layer_bytes // CHUNK + 1 + 1


def test_unchanged_structure_save_injects_not_rebuilds(tmp_path, monkeypatch):
    """Dtype-string drift ("torch.bfloat16" against a stored "bfloat16")
    would read as a structure change and silently turn every save into a
    full rebuild. An incremental save of same-structure weights must inject
    and never call build_image."""
    p0 = params_from_jax(_np_params(), "cpu")
    tm = CheckpointManager(str(tmp_path), "yi-6b",
                           CheckpointPolicy(use_fingerprints=True,
                                            chunk_bytes=CHUNK,
                                            async_write=False))
    tm.save(0, p0, {})
    recs = [r for lid in tm.store.read_image("ckpt", tm.tag_of(0))[0].layer_ids
            for r in tm.store.read_layer(lid).records]
    assert {r.dtype for r in recs} == {"bfloat16", "float32", "int32"}

    def no_rebuild(*args, **kwargs):
        raise AssertionError("incremental save fell back to build_image")

    monkeypatch.setattr(tm.store, "build_image", no_rebuild)
    p1 = dict(p0)
    p1["embed"] = p0["embed"].clone()
    p1["embed"][0, 0] += 1
    r = tm.save(1, p1, {})
    assert r.layers_injected > 0 and r.layers_built == 0


def test_structure_change_falls_back_to_full_build(tmp_path):
    p0 = params_from_jax(_np_params(), "cpu")
    tm = CheckpointManager(str(tmp_path), "yi-6b",
                           CheckpointPolicy(use_fingerprints=True,
                                            chunk_bytes=CHUNK,
                                            async_write=False))
    tm.save(0, p0, {})
    p1 = dict(p0)
    p1["final_norm"] = p0["final_norm"].double()
    r = tm.save(1, p1, {})
    assert r.layers_built > 0 and r.layers_injected == 0
    params, _, _ = tm.restore(device="cpu")
    assert params["final_norm"].dtype == torch.float64


def test_any_injection_failure_falls_back_to_full_build(tmp_path,
                                                       monkeypatch):
    """A failure of inject_image_multi that is no structure change (here an
    OSError) makes both managers rebuild in full, as the reference does;
    both stores then restore the same tree."""
    import repro.ckpt.manager as jax_manager
    import repro_torch.ckpt.manager as torch_manager
    p0 = _np_params()
    p1 = _changed(p0)
    jm, tm = _managers(tmp_path)
    jm.save(0, p0, {})
    tm.save(0, params_from_jax(p0, "cpu"), {})
    calls = []

    def failing_inject(*args, **kwargs):
        calls.append(1)
        raise OSError("the disk went away mid-injection")

    monkeypatch.setattr(jax_manager, "inject_image_multi", failing_inject)
    monkeypatch.setattr(torch_manager, "inject_image_multi", failing_inject)
    rj = jm.save(1, p1, {})
    rt = tm.save(1, params_from_jax(p1, "cpu"), {})
    assert len(calls) == 2
    for r in (rj, rt):
        assert r.layers_built > 0 and r.layers_injected == 0
    assert _layers(jm.store, jm.image, jm.tag_of(1)) == \
        _layers(tm.store, tm.image, tm.tag_of(1))
    jp, _, jstep = jm.restore()
    tp, _, tstep = tm.restore(device="cpu")
    assert jstep == tstep == 1
    for k, v in _walk(p1):                 # the JAX store: the saved bits
        _assert_np_equal_bits(dict(_walk(jp))[k], v)
    got, want = dict(_walk(tp)), dict(_walk(params_from_jax(p1, "cpu")))
    assert sorted(got) == sorted(want)
    for k in want:                         # the port's: the same bits
        assert got[k].dtype == want[k].dtype and torch.equal(
            got[k].view(torch.uint8) if got[k].dim() else got[k],
            want[k].view(torch.uint8) if want[k].dim() else want[k]), k


def _assert_np_equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
    assert a.tobytes() == b.tobytes()


def _walk(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_jax_restores_the_ports_checkpoint(saved):
    tmp_path, _, _, _, p1, _ = saved
    jm = JaxManager(str(tmp_path / "torch"), "yi-6b",
                    JaxPolicy(async_write=False))
    params, opt, step = jm.restore()
    assert step == 1 and opt == {}
    got, want = dict(_walk(params)), dict(_walk(p1))
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_np_equal_bits(got[k], want[k])


def test_port_restores_the_jax_checkpoint(saved):
    tmp_path, _, _, _, p1, _ = saved
    tm = CheckpointManager(str(tmp_path / "jax"), "yi-6b",
                           CheckpointPolicy(chunk_bytes=CHUNK))
    params, opt, step = tm.restore(device="cpu")
    assert step == 1 and opt == {}
    want = params_from_jax(p1, "cpu")
    got, want = dict(_walk(params)), dict(_walk(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(
            got[k].view(torch.uint8) if got[k].dim() else got[k],
            want[k].view(torch.uint8) if want[k].dim() else want[k]), k


@pytest.mark.parametrize("step", [0, 1])
def test_both_stores_verify(saved, step):
    _, jm, tm, *_ = saved
    assert tm.store.verify_image("ckpt", tm.tag_of(step)) == []
    assert jm.store.verify_image("ckpt", tm.tag_of(step)) == []


def test_store_build_cache_prefilter_matches_jax(tmp_path):
    """build_image's COPY cache check (DLC rule 3) against a parent with
    fingerprint sidecars: a hit costs no hashing in either package."""
    from repro.core import Instruction as JIns
    from repro.core import LayerStore as JStore
    from repro_torch.core import Instruction, LayerStore
    rng = np.random.default_rng(9)
    payload = {"a": rng.standard_normal(3000).astype(np.float32),
               "b": rng.integers(0, 9, 500).astype(np.int64)}
    tpay = {k: torch.from_numpy(v.copy()) for k, v in payload.items()}
    reps = {}
    for name, store, ins, pay in (
            ("jax", JStore(str(tmp_path / "j"), chunk_bytes=512), JIns,
             payload),
            ("torch", LayerStore(str(tmp_path / "t"), chunk_bytes=512),
             Instruction, tpay)):
        instr = [ins("FROM", "base", "config"),
                 ins("COPY", "data", "content")]
        store.build_image("app", "v1", instr, {"data": lambda p=pay: p})
        _, _, rep = store.build_image("app", "v2", instr,
                                      {"data": lambda p=pay: p},
                                      parent=("app", "v1"))
        reps[name] = (rep.layers_built, rep.layers_cached,
                      rep.chunks_prefiltered, rep.bytes_hashed)
    assert reps["torch"] == reps["jax"]
    assert reps["torch"][0] == 0 and reps["torch"][2] > 0


@pytest.mark.parametrize("policy", [
    dict(incremental=False, use_fingerprints=True),
    dict(incremental=True, use_fingerprints=False),
    dict(incremental=True, use_fingerprints=True, durability="full"),
], ids=["full_builds", "host_diff", "full_durability"])
def test_save_policies_match_jax(tmp_path, policy):
    """The other save paths of the manager: every save a DLC-cached full
    build; the host SHA diff without fingerprints; per-write fsyncs."""
    p0 = _np_params()
    p1 = _changed(p0)
    jm = JaxManager(str(tmp_path / "jax"), "yi-6b",
                    JaxPolicy(async_write=False, chunk_bytes=CHUNK, keep=10,
                              **policy))
    tm = CheckpointManager(str(tmp_path / "torch"), "yi-6b",
                           CheckpointPolicy(chunk_bytes=CHUNK, async_write=False,
                                            **policy))
    for step, p in ((0, p0), (1, p1)):
        rj = jm.save(step, p, {})
        rt = tm.save(step, params_from_jax(p, "cpu"), {})
        assert _report(rt) == _report(rj)
        assert rt.fsyncs == rj.fsyncs
        assert _layers(tm.store, "ckpt", tm.tag_of(step)) == \
            _layers(jm.store, "ckpt", jm.tag_of(step))
    assert _blobs(str(tmp_path / "torch")) == _blobs(str(tmp_path / "jax"))


def test_port_reads_records_without_fingerprints(tmp_path):
    """A JAX store written without fingerprint sidecars: the port's COPY
    cache check falls back to re-hashing, and its saves inject into it."""
    from repro.core import Instruction as JIns
    from repro.core import LayerStore as JStore
    from repro_torch.core import Instruction, LayerStore
    rng = np.random.default_rng(10)
    payload = {"a": rng.standard_normal(3000).astype(np.float32)}
    instr = [JIns("FROM", "base", "config"), JIns("COPY", "data", "content")]
    JStore(str(tmp_path), chunk_bytes=512, record_fingerprints=False) \
        .build_image("app", "v1", instr, {"data": lambda: payload})
    store = LayerStore(str(tmp_path), chunk_bytes=512)
    tpay = {"a": torch.from_numpy(payload["a"].copy())}
    _, _, rep = store.build_image(
        "app", "v2", [Instruction("FROM", "base", "config"),
                      Instruction("COPY", "data", "content")],
        {"data": lambda: tpay}, parent=("app", "v1"))
    assert rep.layers_built == 0 and rep.layers_cached == 2
    assert rep.bytes_hashed == 3000 * 4 and rep.chunks_prefiltered == 0


# ---------------------------------------------------------------------------
# the parts of the store that replication uses, against the JAX store

def _two_stores(saved, tmp_path):
    """Copies of the saved JAX store: one opened by each package."""
    import shutil
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    root = saved[0]
    shutil.copytree(root / "jax", tmp_path / "j")
    shutil.copytree(root / "jax", tmp_path / "t")
    return (JStore(str(tmp_path / "j"), chunk_bytes=CHUNK),
            LayerStore(str(tmp_path / "t"), chunk_bytes=CHUNK))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            with open(os.path.join(d, fn), "rb") as f:
                out[os.path.relpath(os.path.join(d, fn), root)] = f.read()
    return out


def test_leases_hold_a_tag_against_removal_as_the_reference(saved, tmp_path):
    results = []
    for st in _two_stores(saved, tmp_path):
        st.acquire_lease("ckpt", "step-00000000", "a", ttl_s=600.0)
        st.acquire_lease("ckpt", "step-00000000", "b", ttl_s=600.0)
        st.acquire_lease("ckpt", "step-00000001", "gone", ttl_s=-1.0)
        row = [st.lease_holders("ckpt", "step-00000000"),
               st.leased("ckpt", "step-00000001"),
               st.remove_image("ckpt", "step-00000000"),
               st.release_lease("ckpt", "a", tag="step-00000000"),
               st.remove_image("ckpt", "step-00000000"),
               st.release_lease(None, "b"),
               st.leased("ckpt", "step-00000000")]
        st.acquire_lease("ckpt", "step-00000001", "c", ttl_s=600.0)
        row += [st.remove_image("ckpt", "step-00000001", force=True),
                st.list_tags("ckpt")]
        results.append(row)
    assert results[1] == results[0]
    assert results[1] == [["a", "b"], False, False, 1, False, 1, False,
                          True, ["step-00000000"]]


def test_quarantine_layout_is_the_references(saved, tmp_path):
    js, ts = _two_stores(saved, tmp_path)
    manifest, _ = ts.read_image("ckpt", "step-00000001")
    h = next(r.chunks[0] for lid in manifest.layer_ids
             for r in ts.read_layer(lid).records)
    for st in (js, ts):
        assert st.quarantine_blob(h) is True
        assert st.quarantine_blob(h) is False
        assert st.quarantined_blobs() == [h]
        assert any("missing blob" in p for p in
                   st.verify_image("ckpt", "step-00000001", deep=True))
    assert _tree(ts.root) == _tree(js.root)
    from repro.core import LayerStore as JStore
    assert JStore(ts.root).quarantined_blobs() == [h]
    for st in (js, ts):
        assert st.purge_quarantine() == 1 and st.quarantined_blobs() == []
    assert _tree(ts.root) == _tree(js.root)


def test_drop_and_adopt_blobs_as_the_reference(saved, tmp_path):
    js, ts = _two_stores(saved, tmp_path)
    manifest, _ = ts.read_image("ckpt", "step-00000000")
    hs = sorted({h for lid in manifest.layer_ids
                 for r in ts.read_layer(lid).records for h in r.chunks})[:3]
    out = []
    for st in (js, ts):
        st.ensure_blob_durable(hs[0])
        row = [st.drop_blob(hs[1]), st.drop_blob(hs[1]), st.has_blob(hs[1])]
        st.sync_for_commit()
        out.append(row + [st.fsyncs])
    assert out[1] == out[0] == [True, False, False, 2]


def test_holdings_index_matches_jax_through_commits_and_removals(
        saved, tmp_path):
    """The index is built once, then kept up to date at each commit and
    removal; after each, both packages' cached indexes equal a fresh
    rebuild and each other."""
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    js, ts = _two_stores(saved, tmp_path)
    views = []
    for st, other in ((js, JStore), (ts, LayerStore)):
        got = []
        for window in (1, 8):
            got.append(dataclasses.asdict(st.holdings_index(window)))
        m, c = st.read_image("ckpt", "step-00000001")
        st.write_image(dataclasses.replace(m, name="tenant", tag="v1"), c)
        got.append(dataclasses.asdict(st.holdings_index(1)))
        assert st.remove_image("ckpt", "step-00000001")
        for window in (1, 8):
            idx = dataclasses.asdict(st.holdings_index(window))
            fresh = other(st.root, chunk_bytes=CHUNK).holdings_index(window)
            assert idx == dataclasses.asdict(fresh)
            got.append(idx)
        views.append(got)
    assert views[1] == views[0]
    assert views[1][-1]["images"] == ["ckpt", "tenant"]


def test_gc_runs_hooks_and_spares_protected_paths(saved, tmp_path):
    from repro_torch.ft import CrashInjected
    js, ts = _two_stores(saved, tmp_path)
    manifest, _ = ts.read_image("ckpt", "step-00000000")
    only0 = set()
    for lid in manifest.layer_ids:
        for r in ts.read_layer(lid).records:
            only0.update(r.chunks)
    m1, _ = ts.read_image("ckpt", "step-00000001")
    for lid in m1.layer_ids:
        for r in ts.read_layer(lid).records:
            only0.difference_update(r.chunks)
    keep = sorted(only0)[0]
    stats = []
    for st in (js, ts):
        calls = []
        st.add_gc_hook(lambda s: calls.append(s) or {"bundles_pruned": 2})
        st.add_gc_hook(lambda s: 1 / 0)          # a broken hook is skipped
        st.protect_paths([st._blob_path(keep)])
        assert st.remove_image("ckpt", "step-00000000")
        stats.append(st.gc())
        assert calls == [st] and st.has_blob(keep)
        st.unprotect_paths([st._blob_path(keep)])
        assert st.gc()["blobs_swept"] == 1 and not st.has_blob(keep)
    assert stats[1] == stats[0] and stats[1]["bundles_pruned"] == 2

    def crash(s):
        raise CrashInjected("the sweeping process died")
    ts.add_gc_hook(crash)
    with pytest.raises(CrashInjected):
        ts.gc()


def test_store_fault_points_fire_as_the_references(saved, tmp_path):
    import repro.ft as JF
    import repro_torch.ft as TF
    js, ts = _two_stores(saved, tmp_path)
    h = "ab" * 32
    seen = []
    for st, F in ((js, JF), (ts, TF)):
        with F.inject(0, F.FaultSpec("store.write_blob", "bitrot")) as inj:
            st.write_blob(h, b"payload-bytes")
        with open(st._blob_path(h), "rb") as f:
            persisted = f.read()
        with F.inject(0, F.FaultSpec("store.read_blob", "corrupt")):
            read = st.read_blob(h)
        with F.inject(0, F.FaultSpec("store.commit", "crash")):
            m, c = st.read_image("ckpt", "step-00000001")
            with pytest.raises(F.CrashInjected):
                st.write_image(dataclasses.replace(m, tag="next"), c)
        # which byte flips is drawn from the key, which holds the root:
        # count the flipped bytes, persisted and then on the read
        flips = [sum(x != y for x, y in zip(a, b)) for a, b in
                 ((persisted, b"payload-bytes"), (read, persisted))]
        seen.append((flips, st.list_tags("ckpt", fresh=True),
                     [(e.point, e.key.replace(st.root, "<root>"), e.mode)
                      for e in inj.log]))
    assert seen[1] == seen[0]
    assert seen[1][0] == [1, 1]
    assert seen[1][1] == ["step-00000000", "step-00000001"]


# ---------------------------------------------------------------------------
# export/import bundles, payload loading, BuildReport.merge

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_bundles_equal_and_each_imports_the_others(saved, tmp_path,
                                                          writer):
    """``export_image`` of a store written by either package (bf16 leaves
    included) gives the same bytes in both packages, and each package's
    ``import_image`` of the other's bundle leaves the same files on disk,
    which restore to the saved weights."""
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    root, jm, *_ = saved
    src = str(root / writer)
    tag = jm.tag_of(1)
    bundle = LayerStore(src, chunk_bytes=CHUNK).export_image("ckpt", tag)
    assert bundle == JStore(src, chunk_bytes=CHUNK).export_image("ckpt", tag)
    into_j = JStore(str(tmp_path / "j"), chunk_bytes=CHUNK)
    into_t = LayerStore(str(tmp_path / "t"), chunk_bytes=CHUNK)
    assert into_t.import_image(bundle) == into_j.import_image(bundle) == \
        ("ckpt", tag)
    assert _tree(into_t.root) == _tree(into_j.root)
    assert into_t.verify_image("ckpt", tag, deep=True) == []
    want = JStore(src, chunk_bytes=CHUNK).load_image_payload("ckpt", tag)
    got = into_t.load_image_payload("ckpt", tag)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_np_equal_bits(tensor_to_numpy(got[k], ml_dtypes.bfloat16),
                              want[k])


def test_layer_payload_and_inplace_open_as_the_reference(saved):
    """``load_layer_payload`` returns torch tensors (bf16 records as
    ``torch.bfloat16``, never through numpy) with the reference's bits;
    ``open_layer_inplace`` reads the descriptor the reference reads."""
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    root, jm, *_ = saved
    js = JStore(str(root / "jax"), chunk_bytes=CHUNK)
    ts = LayerStore(str(root / "jax"), chunk_bytes=CHUNK)
    manifest, _ = ts.read_image("ckpt", jm.tag_of(1))
    dtypes = set()
    for lid in manifest.layer_ids:
        assert ts.open_layer_inplace(lid).to_json() == \
            js.open_layer_inplace(lid).to_json()
        layer = ts.open_layer_inplace(lid)
        got = ts.load_layer_payload(layer)
        want = js.load_layer_payload(js.read_layer(lid))
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            dtypes.add(t.dtype)
            _assert_np_equal_bits(tensor_to_numpy(t, ml_dtypes.bfloat16),
                                  want[k])
    assert torch.bfloat16 in dtypes


def test_build_report_merge_is_the_references():
    from repro.core import BuildReport as JReport
    from repro_torch.core import BuildReport
    reps = {}
    for name, cls in (("jax", JReport), ("torch", BuildReport)):
        a, b = cls(), cls()
        for i, k in enumerate(cls._COUNTERS):
            setattr(a, k, i + 1)
            setattr(b, k, 10 * i)
        a.wall_seconds, b.wall_seconds = 0.5, 0.25
        a.layer_entry("l1")["chunks_written"] = 3
        b.layer_entry("l1")["chunks_written"] = 4
        b.layer_entry("l2")["rekeyed"] = 1
        b.per_layer["l2"]["extra"] = 7
        a.merge(b)
        reps[name] = dataclasses.asdict(a)
    assert reps["torch"] == reps["jax"]
    assert BuildReport._COUNTERS == JReport._COUNTERS


# ---------------------------------------------------------------------------
# record_fingerprints=False: the seed's Docker-faithful DLC rule 3

_BUILD = ("layers_built", "layers_cached", "bytes_hashed", "bytes_serialized",
          "chunks_written", "chunks_prefiltered", "derivations_run")


def _dockerfile(ins):
    return [ins("FROM", "base", "config"), ins("COPY", "params", "content"),
            ins("RUN", "opt_init", "content")]


def _seed_payloads(seed, bump=0.0):
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((64, 64)).astype(np.float32)
    w0[0, 0] += np.float32(bump)
    return {"params": {"w0": w0,
                       "w1": rng.integers(-9, 9, (128, 32)).astype(np.int64)},
            "opt_init": {"m": rng.standard_normal(700).astype(np.float32)}}


def _as_torch(p):
    return {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
            for k, d in p.items()}


def _image_layers(store, tag):
    manifest, _ = store.read_image("app", tag)
    return [store.read_layer(lid, use_cache=False)
            for lid in manifest.layer_ids]


@pytest.fixture(scope="module")
def docker_builds(tmp_path_factory):
    """v1, an unchanged rebuild v2, and v3 with the COPY layer changed
    (the RUN below it falls through), built by both packages with
    ``record_fingerprints=False`` and by the port at the default."""
    from repro.core import Instruction as JIns
    from repro.core import LayerStore as JStore
    import repro_torch.core.store as port_store
    from repro_torch.core import Instruction, LayerStore
    tmp = tmp_path_factory.mktemp("docker")
    p0, p1 = _seed_payloads(3), _seed_payloads(3, bump=1.0)
    builds = {"jax": (JStore(str(tmp / "jax"), chunk_bytes=512,
                             record_fingerprints=False), JIns, lambda p: p),
              "torch": (LayerStore(str(tmp / "torch"), chunk_bytes=512,
                                   record_fingerprints=False), Instruction,
                        _as_torch),
              "torch_fp": (LayerStore(str(tmp / "torch_fp"), chunk_bytes=512),
                           Instruction, _as_torch)}
    passes = {}
    real = port_store.fingerprint_tree_packed
    out = {}
    for name, (store, ins, conv) in builds.items():
        calls = []

        def counted(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        port_store.fingerprint_tree_packed = counted
        try:
            reps = {}
            parent = None
            for tag, p in (("v1", p0), ("v2", p0), ("v3", p1)):
                pay = conv(p)
                _, _, reps[tag] = store.build_image(
                    "app", tag, _dockerfile(ins),
                    {k: (lambda v=v: v) for k, v in pay.items()},
                    parent=parent)
                parent = ("app", tag)
        finally:
            port_store.fingerprint_tree_packed = real
        passes[name] = len(calls)
        out[name] = (store, reps)
    return out, passes, p0, p1


@pytest.mark.parametrize("tag", ["v1", "v2", "v3"])
def test_docker_faithful_build_reports_match_jax(docker_builds, tag):
    out, *_ = docker_builds
    got = {k: getattr(out["torch"][1][tag], k) for k in _BUILD}
    assert got == {k: getattr(out["jax"][1][tag], k) for k in _BUILD}
    if tag == "v2":     # every layer cached; the COPY check re-hashed all
        assert got["layers_cached"] == 3 and got["layers_built"] == 0
        assert got["bytes_hashed"] == 64 * 64 * 4 + 128 * 32 * 8
    if tag == "v3":     # COPY missed, the RUN below fell through
        assert got["layers_cached"] == 1 and got["layers_built"] == 2
        assert got["derivations_run"] == 1
    assert got["chunks_prefiltered"] == 0


@pytest.mark.parametrize("tag", ["v1", "v2", "v3"])
def test_docker_faithful_checksums_match_jax_and_records_carry_no_sidecar(
        docker_builds, tag):
    out, *_ = docker_builds
    jl = _image_layers(out["jax"][0], tag)
    tl = _image_layers(out["torch"][0], tag)
    assert [(la.checksum, la.chain) for la in tl] == \
        [(la.checksum, la.chain) for la in jl]
    assert [[r.to_json() for r in la.records] for la in tl] == \
        [[r.to_json() for r in la.records] for la in jl]
    assert all(r.fp is None for la in tl + jl for r in la.records)
    assert out["torch"][0].verify_image("app", tag, deep=True) == []


@pytest.mark.parametrize("tag", ["v1", "v2", "v3"])
def test_sidecar_switch_leaves_bytes_and_checksums_alone(docker_builds, tag):
    """The sidecar is outside every checksum: the same payloads give the
    same blobs, records (but for ``fp``), content and chain checksums with
    the switch on and off."""
    out, *_ = docker_builds
    off = _image_layers(out["torch"][0], tag)
    on = _image_layers(out["torch_fp"][0], tag)
    assert [(la.checksum, la.chain) for la in off] == \
        [(la.checksum, la.chain) for la in on]
    assert [[dataclasses.replace(r, fp=None) for r in la.records]
            for la in on] == [la.records for la in off]
    assert all(r.fp is not None for la in on for r in la.records)
    assert _blobs(out["torch"][0].root) == _blobs(out["torch_fp"][0].root)


def test_docker_faithful_builds_launch_no_fingerprint_pass(docker_builds):
    """Three builds: the default store fingerprints each content layer it
    builds (2 + 0 + 2) and the COPY check of v2 and v3 (1 + 1); with the
    switch off nothing is fingerprinted."""
    out, passes, *_ = docker_builds
    assert passes == {"jax": 0, "torch": 0, "torch_fp": 6}
    assert out["torch_fp"][1]["v2"].bytes_hashed == 0
    assert out["torch_fp"][1]["v2"].chunks_prefiltered > 0


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_docker_faithful_images_cross_read(docker_builds, reader):
    """Each package loads the other's flag-off image bit for bit."""
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    out, _, _, p1 = docker_builds
    writer = "torch" if reader == "jax" else "jax"
    cls = JStore if reader == "jax" else LayerStore
    store = cls(out[writer][0].root, chunk_bytes=512,
                record_fingerprints=False)
    got = store.load_image_payload("app", "v3")
    want = {**p1["params"], **p1["opt_init"]}
    assert sorted(got) == sorted(want)
    for k in want:
        v = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        _assert_np_equal_bits(v, want[k])
    assert store.verify_image("app", "v3", deep=True) == []


def test_cache_hit_without_fingerprints_rehashes(tmp_path):
    """The reference's test of the same name, on the port:
    record_fingerprints=False keeps the seed (Docker-faithful) DLC rule 3,
    a COPY cache hit costs a full serialize+hash of the payload."""
    from repro_torch.core import Instruction, LayerStore
    rng = np.random.default_rng(0)
    store = LayerStore(str(tmp_path / "store_nofp"), chunk_bytes=1024,
                       record_fingerprints=False)
    p = {"params": {"w0": torch.from_numpy(
                        rng.standard_normal((64, 64)).astype(np.float32)),
                    "w1": torch.from_numpy(
                        rng.standard_normal((128, 32)).astype(np.float32))},
         "opt_init": {"m": torch.zeros((64, 64), dtype=torch.float32)}}
    ins = [Instruction("FROM", "base", "config"),
           Instruction("COPY", "params", "content"),
           Instruction("RUN", "opt_init", "content"),
           Instruction("CMD", "serve", "config")]
    providers = {k: (lambda v=v: v) for k, v in p.items()}
    store.build_image("m", "v1", ins, providers)
    _, _, rep = store.build_image("m", "v2", ins, providers,
                                  parent=("m", "v1"))
    assert rep.layers_cached == 4
    assert rep.bytes_hashed > 0          # content compare isn't free
    assert rep.chunks_prefiltered == 0


@pytest.fixture(scope="module")
def docker_saves(tmp_path_factory):
    """Both managers over a ``record_fingerprints=False`` store: a full
    save, then an incremental save through ``use_fingerprints`` (the
    fingerprints live in the manager, not in the records)."""
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    tmp = tmp_path_factory.mktemp("docker_saves")
    p0 = _np_params()
    p1 = _changed(p0)
    jm = JaxManager(str(tmp / "jax"), "yi-6b",
                    JaxPolicy(async_write=False, use_fingerprints=True,
                              chunk_bytes=CHUNK, keep=10),
                    store=JStore(str(tmp / "jax"), chunk_bytes=CHUNK,
                                 record_fingerprints=False))
    tm = CheckpointManager(str(tmp / "torch"), "yi-6b",
                           CheckpointPolicy(use_fingerprints=True,
                                            chunk_bytes=CHUNK,
                                            async_write=False),
                           store=LayerStore(str(tmp / "torch"),
                                            chunk_bytes=CHUNK,
                                            record_fingerprints=False))
    reports = []
    for step, p in ((0, p0), (1, p1)):
        reports.append((jm.save(step, p, {}),
                        tm.save(step, params_from_jax(p, "cpu"), {})))
    return tmp, jm, tm, p1, reports


@pytest.mark.parametrize("step", [0, 1])
def test_docker_faithful_saves_match_jax(docker_saves, step):
    tmp, jm, tm, _, reports = docker_saves
    rj, rt = reports[step]
    assert _report(rt) == _report(rj)
    layers = _layers(tm.store, "ckpt", tm.tag_of(step))
    assert layers == _layers(jm.store, "ckpt", jm.tag_of(step))
    assert all(r.get("fp") is None for la in layers for r in la["records"])
    if step == 1:       # injected, not rebuilt: only the changed chunks
        assert rt.layers_injected == 3 and rt.layers_built == 0
        assert rt.chunks_written == \
            _np_params()["blocks"]["wk"][1].nbytes // CHUNK + 1 + 1
        assert _blobs(str(tmp / "torch")) == _blobs(str(tmp / "jax"))


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_docker_faithful_checkpoints_cross_restore(docker_saves, reader):
    from repro.core import LayerStore as JStore
    from repro_torch.core import LayerStore
    tmp, _, _, p1, _ = docker_saves
    if reader == "jax":
        root = str(tmp / "torch")
        jm = JaxManager(root, "yi-6b", JaxPolicy(async_write=False),
                        store=JStore(root, chunk_bytes=CHUNK,
                                     record_fingerprints=False))
        params, _, step = jm.restore()
        got, want = dict(_walk(params)), dict(_walk(p1))
        for k in want:
            _assert_np_equal_bits(got[k], want[k])
    else:
        root = str(tmp / "jax")
        tm = CheckpointManager(root, "yi-6b", CheckpointPolicy(),
                               store=LayerStore(root, chunk_bytes=CHUNK,
                                                record_fingerprints=False))
        params, _, step = tm.restore(device="cpu")
        got = dict(_walk(params))
        want = dict(_walk(params_from_jax(p1, "cpu")))
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k].view(torch.uint8) if got[k].dim() else got[k],
                want[k].view(torch.uint8) if want[k].dim() else want[k]), k
    assert step == 1 and sorted(got) == sorted(want)
