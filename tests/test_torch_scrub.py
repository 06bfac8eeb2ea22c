"""The port's at-rest scrub (``LayerStore.scrub``, ``ft/scrub.py``) against
the JAX package's, on byte-identical copies of one store.

A small fleet (a base image, two tenants forked from it, a second tag) is
written by either package, damaged once (seeded bitrot, a lost blob,
debris blobs and descriptors, a truncated descriptor), copied, and each
copy is scrubbed by one package: every ``ScrubReport`` of a full pass and
of each slice of a sliced pass, and the ``scrub.cursor.json`` bytes after
each slice, are equal (wall times excluded). Seeded bitrot is found with
its exact attribution and ``repair_image`` heals it from the port's
report.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.core as J  # noqa: E402
import repro.ft.scrub as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft.scrub as TS  # noqa: E402
from repro.ft.faults import inject_bitrot  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.ft.faults import inject_bitrot as t_inject_bitrot  # noqa: E402

CHUNK = 512
PKG = {"jax": (J, JS), "torch": (T, TS)}


def payloads(seed):
    rng = np.random.default_rng(seed)
    return {"params": {
        "w": rng.standard_normal(1500).astype(np.float32),
        "e": rng.standard_normal((40, 24)).astype(ml_dtypes.bfloat16)},
        "opt": {"m": rng.standard_normal(300).astype(np.float32)}}


def build_fleet(pkg, root):
    """base:v1, tenant-0:v1 and tenant-1:v1 forked from it (a new
    ``opt`` each, so the params layer is shared by id), and base:v2."""
    mod = PKG[pkg][0]
    store = mod.LayerStore(root, chunk_bytes=CHUNK)
    ins = [mod.Instruction("FROM", "scratch", "config"),
           mod.Instruction("COPY", "params", "content"),
           mod.Instruction("COPY", "opt", "content"),
           mod.Instruction("CMD", "serve", "config")]

    def prov(p):
        if pkg == "torch":
            p = {k: {n: tensor_from_numpy(a) for n, a in v.items()}
                 for k, v in p.items()}
        return {k: (lambda v=v: v) for k, v in p.items()}

    base = payloads(0)
    store.build_image("base", "v1", ins, prov(base))
    for t in range(2):
        store.build_image(f"tenant-{t}", "v1", ins,
                          prov({**base, "opt": payloads(10 + t)["opt"]}),
                          parent=("base", "v1"))
    store.build_image("base", "v2", ins, prov(payloads(1)),
                      parent=("base", "v1"))
    return store


def chunkset(store, name, tag):
    m, _ = store.read_image(name, tag)
    return sorted({h for lid in m.layer_ids
                   for r in store.read_layer(lid).records for h in r.chunks})


def damage(store):
    """Seeded bitrot, a lost blob, a flushed debris blob, an orphan and a
    truncated descriptor."""
    flips = inject_bitrot(store.root, seed=5, count=2)
    lost = chunkset(store, "base", "v2")[-1]
    os.remove(store._blob_path(lost))
    store.write_blob("ab" + "0" * 62, b"debris")
    store.sync_for_commit()
    with open(store._layer_path("c" * 32), "wb") as f:
        f.write(b"{}")
    m, _ = store.read_image("tenant-1", "v1")
    lp = store._layer_path(m.layer_ids[2])
    raw = open(lp, "rb").read()
    with open(lp, "wb") as f:
        f.write(raw[:len(raw) // 2])
    return flips, lost


def report(rep):
    d = dataclasses.asdict(rep)
    d.pop("wall_s")
    d.update(summary=rep.summary(), corrupt=rep.corrupt_blob_hashes,
             clean=rep.clean, n_corruptions=len(rep.corruptions),
             n_orphans=len(rep.orphans))
    return d


def cursor_bytes(root):
    path = os.path.join(root, TS.CURSOR_FILE)
    return open(path, "rb").read() if os.path.exists(path) else None


def scrub_all(pkg, root, budget):
    """A full pass, then a sliced pass under ``budget``: the reports of
    each, and the cursor file after each slice."""
    store = PKG[pkg][0].LayerStore(root, chunk_bytes=CHUNK)
    out = [report(store.scrub())]
    total = PKG[pkg][1].ScrubReport()
    while True:
        part = store.scrub(**budget)
        total.merge(part)
        out.append((report(part), cursor_bytes(root)))
        if part.complete:
            break
        assert len(out) < JS.N_SHARDS + 4
    out.append(report(total))
    return out


@pytest.fixture(scope="module", params=["jax", "torch"])
def damaged(request, tmp_path_factory):
    """A damaged fleet store written by one package, and a clean copy."""
    base = tmp_path_factory.mktemp(f"scrub_{request.param}")
    store = build_fleet(request.param, str(base / "store"))
    shutil.copytree(store.root, str(base / "clean"))
    flips, lost = damage(store)
    return store.root, str(base / "clean"), flips, lost


@pytest.mark.parametrize("budget", [{"max_bytes": 2048}, {"max_items": 3}],
                         ids=["max_bytes", "max_items"])
def test_reports_and_cursor_equal_the_references(damaged, tmp_path, budget):
    root, _, flips, lost = damaged
    got = {}
    for pkg in ("jax", "torch"):
        shutil.copytree(root, str(tmp_path / pkg))
        got[pkg] = scrub_all(pkg, str(tmp_path / pkg), budget)
    assert got["torch"] == got["jax"]
    full, total = got["torch"][0], got["torch"][-1]
    assert len(got["torch"]) > 3                # the pass was sliced
    kinds = sorted(f["kind"] for f in full["findings"])
    assert {"corrupt_blob", "missing_blob", "orphan_blob", "orphan_layer",
            "layer_unreadable"} <= set(kinds)
    assert lost in full["corrupt"]
    assert sorted(f["blob"] for f in total["findings"]
                  if f["kind"] == "corrupt_blob") == \
        sorted(f["blob"] for f in full["findings"]
               if f["kind"] == "corrupt_blob")
    assert got["torch"][-2][1] is None          # the wrap clears the cursor


def first_reference(store, h):
    for name in store.list_images():
        for tag in store.list_tags(name, fresh=True):
            m, _ = store.read_image(name, tag)
            for lid in m.layer_ids:
                if any(h in r.chunks for r in store.read_layer(lid).records):
                    return name, tag, lid


def test_bitrot_attributed_and_healed_from_the_ports_report(damaged,
                                                            tmp_path):
    """A blob the tenants share with the base is rotted: the port's sliced
    scrub attributes it to the FIRST image that references it (``base``),
    its report drives the port's ``repair_image`` (and the JAX package's,
    on a copy) to the same heal, and the re-scrub is clean."""
    _, clean, _, _ = damaged
    out = {}
    for pkg in ("jax", "torch"):
        mod, smod = PKG[pkg]
        for side in ("victim", "peer"):
            shutil.copytree(clean, str(tmp_path / pkg / side))
        victim, peer = (mod.LayerStore(str(tmp_path / pkg / side),
                                       chunk_bytes=CHUNK)
                        for side in ("victim", "peer"))
        shared = sorted(set(chunkset(victim, "tenant-0", "v1"))
                        & set(chunkset(victim, "base", "v1")))
        flips = t_inject_bitrot(victim.root, seed=3, count=1,
                                candidates=shared)
        where = first_reference(victim, flips[0][0])
        assert where[0] == "base"
        rep = smod.ScrubReport()
        while True:
            part = victim.scrub(max_bytes=4096)
            rep.merge(part)
            if part.complete:
                break
        assert [(f.kind, f.blob, (f.image, f.tag, f.layer_id))
                for f in rep.findings] == \
            [("corrupt_blob", flips[0][0], where)]
        rr = mod.repair_image(victim, "tenant-0", "v1", peers=[peer],
                              scrub_report=rep)
        victim.purge_quarantine()
        after = victim.scrub()
        out[pkg] = (report(rep), rr.planned_blobs, rr.repaired_blobs,
                    rr.bytes_pulled, rr.damaged_bytes, rr.verified_clean,
                    report(after))
        assert rr.verified_clean and rr.repaired_blobs == 1
        assert after.complete and after.clean
    assert out["torch"] == out["jax"]


def test_inflight_protected_and_reset_equal_the_references(tmp_path):
    """Files of the open batch transaction and paths pinned by a repair
    are not committed state: both scrubs skip them. ``reset=True``
    discards a paused pass."""
    build_fleet("torch", str(tmp_path / "src"))
    got = {}
    for pkg in ("jax", "torch"):
        mod = PKG[pkg][0]
        shutil.copytree(str(tmp_path / "src"), str(tmp_path / pkg))
        store = mod.LayerStore(str(tmp_path / pkg), chunk_bytes=CHUNK)
        store.write_blob("cd" + "1" * 62, b"in flight")   # never flushed
        pinned = store._layer_path("d" * 32)
        with open(pinned, "wb") as f:
            f.write(b"{}")
        store.protect_paths([pinned])
        full = store.scrub()
        paused = store.scrub(max_items=1)
        cur = cursor_bytes(store.root)
        fresh = store.scrub(reset=True, max_items=1)
        got[pkg] = (report(full), report(paused), cur, report(fresh))
        assert full.clean and not paused.complete and cur is not None
        assert fresh.layers_scanned == full.layers_scanned
    assert got["torch"] == got["jax"]


def test_cursor_helpers_write_the_references_bytes(tmp_path):
    for n in (0, 1, 17, 255, 256, -3):
        a, b = tmp_path / f"j{n}", tmp_path / f"t{n}"
        a.mkdir()
        b.mkdir()
        JS.save_cursor(str(a), n)
        TS.save_cursor(str(b), n)
        assert cursor_bytes(str(b)) == cursor_bytes(str(a))
        assert TS.load_cursor(str(a)) == JS.load_cursor(str(b))
        TS.clear_cursor(str(b))
        assert TS.load_cursor(str(b)) == 0
    assert TS.N_SHARDS == JS.N_SHARDS
    assert TS.CORRUPTION_KINDS == JS.CORRUPTION_KINDS
