"""The port's store under a real process death, beside the JAX package's.

Every case runs one scenario twice, as two child processes: one imports
only ``repro_torch`` (``jax``, ``ml_dtypes`` and ``repro`` are blocked),
the other the JAX package. Each builds the same stores from the same
seeded numpy payloads, prints ``READY`` and kills itself with ``SIGKILL``
at the same point: no ``finally`` runs, the thread pools stop where they
are, and whatever the process held in memory (un-fsynced batch writes,
streams in flight, the set of paths it knew to be durable) is lost. A
child that exits any other way fails its case.

The parent then opens both roots and holds the port's stores to the
invariants of the reference tests that kill at these points
(``test_inject_multi.py``, ``test_fanout.py``, ``test_relay.py``,
``test_scrub_repair.py``): every tier wholly at the old tag or wholly at
the new one, every visible tag deep-verified, rotted blobs in quarantine
and none addressable, and a retry that converges. It also holds the two
packages' stores equal, before and after the retry: tags, quarantine,
the layer and chain checksums of every visible image and the blob
addresses those images reference. Blob files that the kill left behind
unreferenced depend on thread timing, so they are never compared.

``manager_save`` kills a ``CheckpointManager`` inside ``write_blob`` of
an incremental save; a fresh manager (an empty fingerprint baseline)
retries it and must inject, not rebuild, re-fsyncing every leftover blob.

The children's code is kept as module-level strings: the port's child is
``PORT_PARTS`` joined, then a ``BODIES`` entry, and
``tests/test_torch_isolation.py`` scans exactly that for banned imports.
"""
import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import ml_dtypes  # noqa: E402

import repro.ckpt as JC  # noqa: E402
import repro.core as J  # noqa: E402
import repro.core.store as JS  # noqa: E402
import repro_torch.ckpt as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.store as TS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 60

PORT_PRELUDE = '''
import os
import signal
import sys
import time

for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import numpy as np
import torch

import repro_torch.core.registry as registry
from repro_torch.core import (Instruction, LayerStore, RelayNode, diff_image,
                              inject_image_multi, inject_payload_update,
                              push_delta, repair_image, replicate_fanout)
from repro_torch.ft.faults import inject_bitrot

torch.set_num_threads(1)


def leaf(a):
    """A numpy array as the port's leaf; uint16 holds bf16 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def checkpointing():
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    return CheckpointManager, CheckpointPolicy
'''

REF_PRELUDE = '''
import os
import signal
import sys
import time

import ml_dtypes
import numpy as np

import repro.core.registry as registry
from repro.core import (Instruction, LayerStore, RelayNode, diff_image,
                        inject_image_multi, inject_payload_update,
                        push_delta, repair_image, replicate_fanout)
from repro.ft.faults import inject_bitrot


def leaf(a):
    """A numpy array as the reference's leaf; uint16 holds bf16 bits."""
    a = np.array(a, copy=True)
    return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a


def checkpointing():
    from repro.ckpt import CheckpointManager, CheckpointPolicy
    return CheckpointManager, CheckpointPolicy
'''

# the payloads, pure numpy: the children run it, and so does this module
DATA = '''
import numpy as np


def floats(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def bf16_bits(a):
    """float32 -> bf16 bit patterns (truncated), as uint16."""
    return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def inject_src(edited):
    w = floats(0, 2000)
    return {"w": w + np.float32(1.0) if edited else w}


def inject_build():
    return {"b": np.ones(500, np.float32)}


def fan_src(edited):
    w = floats(1, 2000)
    return {"w": w + np.float32(1.0) if edited else w}


def repair_params():
    return {"w": floats(2, 3000)}


def manager_params(edited):
    """yi-6b's tree in miniature (bf16 as uint16 bits); ``edited`` moves
    layer 1 of blocks/wk by 0.5: 4 of its 8 chunks of 512 B."""
    rng = np.random.default_rng(3)
    wk = rng.standard_normal((2, 32, 32)).astype(np.float32)
    if edited:
        wk[1] += np.float32(0.5)
    return {"embed": bf16_bits(rng.standard_normal((64, 32))),
            "blocks": {"wk": bf16_bits(wk),
                       "norm": rng.standard_normal((2, 32)).astype(np.float32)},
            "final_norm": rng.standard_normal(32).astype(np.float32)}
'''

HARNESS = '''
ROOT = sys.argv[1]
CASE = sys.argv[2]


def die():
    """The hard way: no atexit, no finally, no flush of anything."""
    os.kill(os.getpid(), signal.SIGKILL)


def tree(t):
    return {k: tree(v) if isinstance(v, dict) else leaf(v)
            for k, v in t.items()}
'''

PORT_PARTS = ("PORT_PRELUDE", "DATA", "HARNESS")

BODIES = {
    # tests/test_inject_multi.py:252: a provider of the re-derived RUN layer
    # runs between the batched blob writes and the commit
    "inject_multi": '''
ins = [Instruction("FROM", "base", "config"),
       Instruction("COPY", "src", "content"),
       Instruction("RUN", "build", "content", derives_from=["src"])]
store = LayerStore(os.path.join(ROOT, "src"), chunk_bytes=256,
                   durability="batch")
store.build_image("app", "v1", ins,
                  {"src": lambda: tree(inject_src(False)),
                   "build": lambda: tree(inject_build())})
m, _ = store.read_image("app", "v1")
diffs = diff_image([store.read_layer(lid) for lid in m.layer_ids],
                   {"src": tree(inject_src(True))})
print("READY", flush=True)
inject_image_multi(store, "app", "v1", "v2", diffs,
                   providers={"build": lambda: die()})
print("UNREACHABLE", flush=True)
''',
    # tests/test_fanout.py:365: inside replica 1's commit. The replicas'
    # commits run concurrently, so the kill first lets replica 0's land:
    # both packages then die at the same point.
    "fanout": '''
ins = [Instruction("FROM", "base", "config"),
       Instruction("COPY", "src", "content"),
       Instruction("CMD", "run", "config")]
store = LayerStore(os.path.join(ROOT, "src"), chunk_bytes=256)
store.build_image("app", "v1", ins, {"src": lambda: tree(fan_src(False))})
replicas = [LayerStore(os.path.join(ROOT, f"r{i}"), chunk_bytes=256)
            for i in range(2)]
assert replicate_fanout(store, replicas, "app", "v1").ok
inject_payload_update(store, "app", "v1", "v2", {"src": tree(fan_src(True))})
print("READY", flush=True)


def dying_write_image(manifest, config):
    deadline = time.monotonic() + 30
    while not replicas[0].has_image("app", "v2") and \\
            time.monotonic() < deadline:
        time.sleep(0.005)
    die()


replicas[1].write_image = dying_write_image
replicate_fanout(store, replicas, "app", "v2")
print("UNREACHABLE", flush=True)
''',
    # tests/test_relay.py:519 (CASE "relay_pull": the relay's own commit,
    # its children fed in flight) and :533 ("relay_refan": child 1's
    # commit, after the relay and child 0 committed)
    "relay": '''
ins = [Instruction("FROM", "base", "config"),
       Instruction("COPY", "src", "content"),
       Instruction("CMD", "run", "config")]
store = LayerStore(os.path.join(ROOT, "src"), chunk_bytes=256)
store.build_image("app", "v1", ins, {"src": lambda: tree(fan_src(False))})
relay = RelayNode(LayerStore(os.path.join(ROOT, "relay"), chunk_bytes=256),
                  children=[LayerStore(os.path.join(ROOT, f"e{i}"),
                                       chunk_bytes=256) for i in range(2)])
assert replicate_fanout(store, [relay], "app", "v1").deep_ok
inject_payload_update(store, "app", "v1", "v2", {"src": tree(fan_src(True))})
print("READY", flush=True)
victim = relay.store if CASE == "relay_pull" else relay.children[1].store
victim.write_image = lambda manifest, config: die()
replicate_fanout(store, [relay], "app", "v2", source="inflight")
print("UNREACHABLE", flush=True)
''',
    # tests/test_scrub_repair.py:398-444: CASE is the fault point
    # ("repair.pull": quarantines done, swap-ins not; "repair.commit":
    # swap-ins done, flush not)
    "repair": '''
ins = [Instruction("FROM", "base", "config"),
       Instruction("COPY", "params", "content"),
       Instruction("CMD", "serve", "config")]
src = LayerStore(os.path.join(ROOT, "src"), chunk_bytes=512)
src.build_image("m", "v1", ins, {"params": lambda: tree(repair_params())})
dst = LayerStore(os.path.join(ROOT, "dst"), chunk_bytes=512)
push_delta(src, dst, "m", "v1")
flips = inject_bitrot(dst.root, seed=2, count=2)
with open(os.path.join(ROOT, "flips.txt"), "w") as f:
    f.write("\\n".join(h for h, _ in flips))
orig_fault_point = registry.fault_point


def dying_fault_point(point, key="", data=None):
    if point == CASE:
        die()
    return orig_fault_point(point, key, data)


registry.fault_point = dying_fault_point
print("READY", flush=True)
repair_image(dst, "m", "v1", peers=[src])
print("UNREACHABLE", flush=True)
''',
    # an incremental save (batch durability) killed inside write_blob,
    # once its first new blob has landed
    "manager_save": '''
CheckpointManager, CheckpointPolicy = checkpointing()
mgr = CheckpointManager(os.path.join(ROOT, "ckpt"), "tiny", CheckpointPolicy(
    use_fingerprints=True, chunk_bytes=512, async_write=False, keep=10))
mgr.save(1, tree(manager_params(False)), {})
orig_write_blob = LayerStore.write_blob


def dying_write_blob(self, h, data):
    new = orig_write_blob(self, h, data)
    if new:
        die()
    return new


LayerStore.write_blob = dying_write_blob
print("READY", flush=True)
mgr.save(2, tree(manager_params(True)), {})
print("UNREACHABLE", flush=True)
''',
}

CASES = {"inject_multi": "inject_multi", "fanout": "fanout",
         "relay_pull": "relay", "relay_refan": "relay",
         "repair.pull": "repair", "repair.commit": "repair",
         "manager_save": "manager_save"}

# the tiers each scenario leaves: {directory under the root: chunk bytes}
TIERS = {
    "inject_multi": {"src": 256},
    "fanout": {"src": 256, "r0": 256, "r1": 256},
    "relay": {"src": 256, "relay": 256, "e0": 256, "e1": 256},
    "repair": {"src": 512, "dst": 512},
    "manager_save": {"ckpt": 512},
}

_DATA: dict = {}
exec(DATA, _DATA)


def port_script(case: str) -> str:
    parts = "".join(globals()[p] for p in PORT_PARTS)
    return parts + BODIES[CASES[case]]


def ref_script(case: str) -> str:
    return REF_PRELUDE + DATA + HARNESS + BODIES[CASES[case]]


def port_leaf(a: np.ndarray) -> torch.Tensor:
    """A numpy array as the port's leaf; uint16 holds bf16 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def ref_leaf(a: np.ndarray) -> np.ndarray:
    """A numpy array as the reference's leaf; uint16 holds bf16 bits."""
    a = np.array(a, copy=True)
    return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a


def bits(x) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


PKGS = {"port": SimpleNamespace(core=T, ckpt=TC, store_mod=TS,
                                leaf=port_leaf),
        "reference": SimpleNamespace(core=J, ckpt=JC, store_mod=JS,
                                     leaf=ref_leaf)}


def tree(pkg, t):
    return {k: tree(pkg, v) if isinstance(v, dict) else pkg.leaf(v)
            for k, v in t.items()}


def assert_tree_bits(got, want, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_tree_bits(got[k], w, f"{path}/{k}")
        else:
            g = bits(got[k])
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{path}/{k}"


def run_children(tmp_path, case):
    """Both packages' children, side by side; each must die by SIGKILL
    after READY. -> {"port": root, "reference": root}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    roots = {side: str(tmp_path / side) for side in PKGS}
    scripts = {"port": port_script(case), "reference": ref_script(case)}

    def run(side):
        os.makedirs(roots[side])
        return subprocess.run([sys.executable, "-c", scripts[side],
                               roots[side], case], env=env,
                              capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)

    with ThreadPoolExecutor(2) as pool:
        procs = dict(zip(PKGS, pool.map(run, PKGS)))
    for side, proc in procs.items():
        assert proc.returncode == -signal.SIGKILL, \
            (side, proc.returncode, proc.stderr[-3000:])
        assert "READY" in proc.stdout and "UNREACHABLE" not in proc.stdout, \
            (side, proc.stdout[-3000:])
    return roots


def open_tiers(pkg, root, scenario):
    return {name: pkg.core.LayerStore(os.path.join(root, name),
                                      chunk_bytes=chunk)
            for name, chunk in TIERS[scenario].items()}


def state(pkg, root, scenario):
    """What a crash may not make differ between the packages: each tier's
    tags and quarantine, and per visible image its layers' (content,
    chain) checksums and the blob addresses it references."""
    out = {}
    for name, s in open_tiers(pkg, root, scenario).items():
        images = {}
        for image in s.list_images():
            for t in s.list_tags(image):
                m, _ = s.read_image(image, t)
                layers = [s.read_layer(lid, use_cache=False)
                          for lid in m.layer_ids]
                images[f"{image}:{t}"] = {
                    "layers": [(la.checksum, la.chain) for la in layers],
                    "blobs": sorted({h for la in layers
                                     for r in la.records for h in r.chunks})}
        out[name] = {"images": images,
                     "quarantine": sorted(s.quarantined_blobs())}
    return out


def assert_whole_tiers(stores, image, old, new):
    """Each tier wholly at ``old`` or wholly at ``new``, every visible tag
    deep-verified (test_fanout.py, test_relay.py)."""
    for name, s in stores.items():
        tags = s.list_tags(image)
        assert old in tags and set(tags) <= {old, new}, (name, tags)
        for t in tags:
            assert s.verify_image(image, t, deep=True) == [], (name, t)


def blob_files(root) -> set:
    out = set()
    for _, _, files in os.walk(os.path.join(root, "blobs", "sha256")):
        out.update(f for f in files if ".tmp." not in f)
    return out


def image_blobs(store, image, tag) -> set:
    m, _ = store.read_image(image, tag)
    return {h for lid in m.layer_ids
            for r in store.read_layer(lid).records for h in r.chunks}


# ------------------------------------------------------ what the kill left
def check_inject_multi(pkg, stores, case):
    (src,) = stores.values()
    assert src.list_tags("app") == ["v1"]
    assert not src.has_image("app", "v2")
    assert src.verify_image("app", "v1", deep=True) == []


def retry_inject_multi(pkg, stores, case):
    (src,) = stores.values()
    m, _ = src.read_image("app", "v1")
    diffs = pkg.core.diff_image(
        [src.read_layer(lid) for lid in m.layer_ids],
        {"src": tree(pkg, _DATA["inject_src"](True))})
    pkg.core.inject_image_multi(
        src, "app", "v1", "v2", diffs,
        providers={"build": lambda: tree(pkg, _DATA["inject_build"]())})
    assert src.verify_image("app", "v2", deep=True) == []
    got = src.load_image_payload("app", "v2")
    assert np.array_equal(bits(got["w"]), _DATA["inject_src"](True)["w"])
    return {}


def check_fanout(pkg, stores, case):
    assert stores["src"].list_tags("app") == ["v1", "v2"]
    replicas = {k: v for k, v in stores.items() if k != "src"}
    assert_whole_tiers(replicas, "app", "v1", "v2")
    assert stores["r0"].list_tags("app") == ["v1", "v2"]
    assert stores["r1"].list_tags("app") == ["v1"]


def retry_fanout(pkg, stores, case):
    replicas = [stores["r0"], stores["r1"]]
    fan = pkg.core.replicate_fanout(stores["src"], replicas, "app", "v2")
    assert fan.ok
    for r in replicas:
        assert r.verify_image("app", "v2", deep=True) == []
    return {}


def _relay(pkg, stores):
    return pkg.core.RelayNode(stores["relay"],
                              children=[stores["e0"], stores["e1"]])


def check_relay(pkg, stores, case):
    tiers = {k: v for k, v in stores.items() if k != "src"}
    assert_whole_tiers(tiers, "app", "v1", "v2")
    if case == "relay_pull":        # no tier may commit before its relay
        assert all(s.list_tags("app") == ["v1"] for s in tiers.values())
    else:                           # the relay and child 0 committed
        assert stores["relay"].list_tags("app") == ["v1", "v2"]
        assert stores["e0"].list_tags("app") == ["v1", "v2"]
        assert stores["e1"].list_tags("app") == ["v1"]


def retry_relay(pkg, stores, case):
    relay = _relay(pkg, stores)
    fan = pkg.core.replicate_fanout(stores["src"], [relay], "app", "v2")
    assert fan.deep_ok
    for s in relay.all_stores():
        assert s.verify_image("app", "v2", deep=True) == []
    return {}


def _flipped(root):
    with open(os.path.join(root, "flips.txt")) as f:
        return set(f.read().split())


def check_repair(pkg, stores, case):
    dst = stores["dst"]
    flipped = _flipped(os.path.dirname(dst.root))
    assert len(flipped) == 2
    # visibly incomplete at worst: no corrupt blob is addressable, and what
    # was swapped back in re-hashes clean
    rep = dst.scrub()
    assert {f.kind for f in rep.corruptions} <= {"missing_blob"}
    assert set(dst.quarantined_blobs()) == flipped
    assert dst.list_tags("m") == ["v1"]


def retry_repair(pkg, stores, case):
    dst = stores["dst"]
    rr = pkg.core.repair_image(dst, "m", "v1", peers=[stores["src"]])
    assert rr.verified_clean
    assert dst.verify_image("m", "v1", deep=True) == []
    assert dst.scrub().clean
    return {}


def _manager(pkg, stores):
    return pkg.ckpt.CheckpointManager(
        stores["ckpt"].root, "tiny", pkg.ckpt.CheckpointPolicy(
            use_fingerprints=True, chunk_bytes=512, async_write=False,
            keep=10), store=stores["ckpt"])


def _restore(pkg, mgr, step):
    if pkg.core is T:
        return mgr.restore(step, device="cpu")
    return mgr.restore(step)


def check_manager_save(pkg, stores, case):
    s = stores["ckpt"]
    mgr = _manager(pkg, stores)
    assert mgr.latest_step() == 1
    assert s.list_tags("ckpt") == ["step-00000001"]
    assert s.verify_image("ckpt", "step-00000001", deep=True) == []
    params, _, step = _restore(pkg, mgr, 1)
    assert step == 1
    assert_tree_bits(params, _DATA["manager_params"](False))


def retry_manager_save(pkg, stores, case):
    """The restart: a fresh manager (no fingerprint baseline) saves step 2
    again. -> the report's counters that the packages must share."""
    s = stores["ckpt"]
    before = blob_files(s.root)
    synced = []
    real = pkg.store_mod._fsync_path

    def record(path):
        synced.append(path)
        real(path)

    pkg.store_mod._fsync_path = record
    try:
        mgr = _manager(pkg, stores)
        rep = mgr.save(2, tree(pkg, _DATA["manager_params"](True)), {})
    finally:
        pkg.store_mod._fsync_path = real
    assert rep.layers_built == 0 and rep.layers_injected == 2, rep
    assert mgr.latest_step() == 2
    changed = image_blobs(s, "ckpt", "step-00000002") - \
        image_blobs(s, "ckpt", "step-00000001")
    landed = changed & before
    assert landed, "the child died before its first new blob landed"
    assert rep.chunks_written + len(landed) == len(changed) == 5
    leftovers = {s._blob_path(h) for h in landed}
    assert leftovers <= set(synced), "a leftover blob was not re-fsynced"
    assert s.verify_image("ckpt", "step-00000002", deep=True) == []
    params, _, step = _restore(pkg, _manager(pkg, stores), 2)
    assert step == 2
    assert_tree_bits(params, _DATA["manager_params"](True))
    return {"layers_injected": rep.layers_injected,
            "layers_built": rep.layers_built,
            "bytes_hashed": rep.bytes_hashed,
            "manifest_commits": rep.manifest_commits,
            "fsyncs": rep.fsyncs, "leftovers": len(landed)}


CHECKS = {"inject_multi": (check_inject_multi, retry_inject_multi),
          "fanout": (check_fanout, retry_fanout),
          "relay": (check_relay, retry_relay),
          "repair": (check_repair, retry_repair),
          "manager_save": (check_manager_save, retry_manager_save)}


@pytest.mark.parametrize("case", list(CASES))
def test_sigkill_leaves_the_ports_store_as_the_references(
        tmp_path, record_property, case):
    scenario = CASES[case]
    check, retry = CHECKS[scenario]
    roots = run_children(tmp_path, case)

    before = {side: state(pkg, roots[side], scenario)
              for side, pkg in PKGS.items()}
    assert before["port"] == before["reference"]
    for side, pkg in PKGS.items():
        check(pkg, open_tiers(pkg, roots[side], scenario), case)

    reports = {side: retry(pkg, open_tiers(pkg, roots[side], scenario), case)
               for side, pkg in PKGS.items()}
    after = {side: state(pkg, roots[side], scenario)
             for side, pkg in PKGS.items()}
    assert after["port"] == after["reference"]

    if scenario == "manager_save":
        # fsyncs and leftovers depend on what landed before the kill
        record_property("retry_fsyncs", {side: r.pop("fsyncs")
                                         for side, r in reports.items()})
        record_property("leftovers", {side: r.pop("leftovers")
                                      for side, r in reports.items()})
        assert reports["port"] == reports["reference"]



_CRASH_SAVE_PHASE = """
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
import torch
import chip_smoke
chip_smoke.phase_crash_save(torch.device("cpu"))
"""


def test_chip_smoke_crash_save_phase_runs_on_the_cpu(tmp_path):
    """``chip_smoke.phase_crash_save`` at yi-6b's smoke size on the CPU,
    with the reference unimportable: its child dies by SIGKILL after one
    new blob, and every check of the phase holds (the card runs it at
    full width)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _CRASH_SAVE_PHASE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("[crash_save] ")]
    out = json.loads(line.split(" ", 1)[1])
    assert out["kill_point"] == "LayerStore.write_blob"
    assert out["blobs_uncommitted"] >= 1
    assert out["restart_bytes_hashed_host"] == out["payload_bytes"]
    assert out["chunks_written"] < out["changed_chunks"]
