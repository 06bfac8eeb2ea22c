"""Store parity: the same weights saved by the JAX ``CheckpointManager`` and
by the port's, into two stores — a full save, then a fingerprinted
incremental save after a few leaves change — give equal records, chunk
hashes, content and chain checksums, blob sets and save reports. Each
package restores the other's checkpoints bit for bit.

Layer ids and config ids are fresh UUIDs, so they are never compared.
"""
import os

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
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

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
                                            chunk_bytes=CHUNK))
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
                                            chunk_bytes=CHUNK))
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
                                            chunk_bytes=CHUNK))
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
                           CheckpointPolicy(chunk_bytes=CHUNK, **policy))
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
