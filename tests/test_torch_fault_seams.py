"""Every protocol fault point of the port, exercised by name: the literal
seam table below is pinned (by equality) to ``repro_torch.ft.chaos.SEAMS``,
and each seam is driven to convergence through the port's ``push_delta``
and ``replicate_fanout``; then a torn ``bundle.publish`` (crash and drop)
and a crash at ``repair.commit``. So the port analyzer's R1 coverage
contract, which reads only the port's tests, is backed by real, converging
injections. Each converged replica holds the chunk addresses (SHA-256 of
the serialized bytes) of the same image built by the JAX package's store
from the same arrays."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
from repro_torch.core import (Instruction, LayerStore,  # noqa: E402
                              PassiveRegistry, inject_payload_update,
                              push_delta, repair_image, replicate_fanout)
from repro_torch.ft import (CrashInjected, FaultSpec, RetryPolicy,  # noqa: E402
                            inject, inject_bitrot)
from repro_torch.ft.chaos import SEAMS  # noqa: E402

INS = [
    Instruction("FROM", "base", "config"),
    Instruction("COPY", "src", "content"),
    Instruction("RUN", "deps", "content"),
    Instruction("CMD", "run", "config"),
]

#: literal duplicate of ``ft.chaos.SEAMS``, kept as literals on purpose:
#: R1 requires each point name to occur in the tests verbatim, and
#: ``test_seam_table_matches_chaos`` fails if this copy drifts
SEAM_CASES = [
    ("wire.negotiate", "dst"),
    ("wire.probe_blobs", "dst"),
    ("wire.receive_layer", "dst"),
    ("wire.receive_blob", "dst"),
    ("wire.commit", "dst"),
    ("store.read_blob", "src"),
    ("store.commit", "dst"),
]

FAST = dict(max_attempts=4, base_delay_s=0.001, max_delay_s=0.01)


def mk(tmp_path, name):
    return LayerStore(str(tmp_path / name), chunk_bytes=512)


def make_payloads(rng):
    return {
        "src": {"a": rng.standard_normal(1000).astype(np.float32),
                "b": rng.standard_normal(500).astype(np.float32)},
        "deps": {"lib": rng.standard_normal(4000).astype(np.float32)},
    }


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def build_v1(store, payloads):
    store.build_image("app", "v1", INS,
                      {k: (lambda v=v: _torch(v)) for k, v in
                       payloads.items()})


def v2_src(payloads):
    src2 = {k: v.copy() for k, v in payloads["src"].items()}
    src2["b"][3] = 42.0
    return src2


def inject_v2(store, payloads):
    inject_payload_update(store, "app", "v1", "v2",
                          {"src": _torch(v2_src(payloads))},
                          providers={"deps": lambda: _torch(payloads["deps"])})


def chunk_addresses(store, name="app", tag="v2"):
    m, _ = store.read_image(name, tag)
    return [(r.name, list(r.chunks)) for lid in m.layer_ids
            for r in store.read_layer(lid).records]


def reference_chunks(tmp_path, payloads):
    """The chunk addresses of app:v2 as the JAX package's store builds
    them."""
    ref = J.LayerStore(str(tmp_path / "reference"), chunk_bytes=512)
    ins = [J.Instruction(i.op, i.arg, i.kind) for i in INS]
    ref.build_image("app", "v1", ins, {k: (lambda v=v: v)
                                       for k, v in payloads.items()})
    J.inject_payload_update(ref, "app", "v1", "v2",
                            {"src": v2_src(payloads)},
                            providers={"deps": lambda: payloads["deps"]})
    return chunk_addresses(ref)


def converged(src, dst, want_chunks):
    assert dst.verify_image("app", "v2", deep=True) == []
    m_src, _ = src.read_image("app", "v2")
    m_dst, _ = dst.read_image("app", "v2")
    assert m_src.layer_ids == m_dst.layer_ids
    assert chunk_addresses(dst) == want_chunks


def test_seam_table_matches_chaos():
    """The literal seam list above IS the chaos rotation table."""
    assert tuple(SEAM_CASES) == SEAMS


@pytest.mark.parametrize("point,side", SEAM_CASES,
                         ids=[p for p, _ in SEAM_CASES])
def test_drop_at_each_seam_converges(tmp_path, rng, point, side):
    """One dropped hit at every protocol seam (negotiate, probe, layer and
    blob receive, remote commit, the source's own disk read, the store
    commit point) is converged by the in-run retry."""
    src, dst = mk(tmp_path, "src"), mk(tmp_path, "dst")
    payloads = make_payloads(rng)
    build_v1(src, payloads)
    push_delta(src, dst, "app", "v1")
    inject_v2(src, payloads)
    match = src.root if side == "src" else dst.root
    policy = RetryPolicy(seed=0, **FAST)
    with inject(0, FaultSpec(point=point, mode="drop", match=match,
                             times=1)) as inj:
        push_delta(src, dst, "app", "v2", retry=policy)
    assert inj.fired(point) >= 1, f"{point} never fired: seam wiring broken?"
    converged(src, dst, reference_chunks(tmp_path, payloads))


@pytest.mark.parametrize("point", ["wire.receive_blob", "store.read_blob"])
def test_fanout_drop_fails_takers_then_converges(tmp_path, rng, point):
    """A dropped blob, at a replica's receive or at the source's read,
    fails only that blob's takers; the retry converges all three."""
    src, r0, r1, r2 = (mk(tmp_path, n) for n in ("src", "r0", "r1", "r2"))
    payloads = make_payloads(rng)
    build_v1(src, payloads)
    replicate_fanout(src, [r0, r1, r2], "app", "v1")
    inject_v2(src, payloads)
    match = src.root if point == "store.read_blob" else r1.root
    with inject(1, FaultSpec(point=point, mode="drop", match=match,
                             times=1)) as inj:
        fan = replicate_fanout(src, [r0, r1, r2], "app", "v2",
                               retry=RetryPolicy(seed=1, **FAST))
    assert inj.fired(point) >= 1
    assert fan.n_ok == 3, "retry did not converge the failed takers"
    want = reference_chunks(tmp_path, payloads)
    for d in (r0, r1, r2):
        converged(src, d, want)


def test_source_crash_propagates_and_restart_converges(tmp_path, rng):
    """CrashInjected at the source read is the PUSHER dying: it escapes,
    and the restarted pusher converges."""
    src, dst = mk(tmp_path, "src"), mk(tmp_path, "dst")
    payloads = make_payloads(rng)
    build_v1(src, payloads)
    push_delta(src, dst, "app", "v1")
    inject_v2(src, payloads)
    with inject(2, FaultSpec(point="store.read_blob", mode="crash",
                             match=src.root, times=1)):
        with pytest.raises(CrashInjected):
            push_delta(src, dst, "app", "v2",
                       retry=RetryPolicy(seed=2, **FAST))
        push_delta(src, dst, "app", "v2")    # the restarted pusher
    converged(src, dst, reference_chunks(tmp_path, payloads))


# ------------------------------------------------------- bundle.publish
def tag(s):
    return f"step-{s:08d}"


def build_steps(tmp_path, rng, steps):
    store = mk(tmp_path, "train")
    ins = [Instruction("FROM", "arch", "config"),
           Instruction("COPY", "state", "content")]
    state = rng.standard_normal(2048).astype(np.float32)
    store.build_image("ckpt", tag(1), ins,
                      {"state": lambda: {"w": torch.from_numpy(state)}})
    for s in range(2, steps + 1):
        state = state.copy()
        state[:128] = rng.standard_normal(128)
        inject_payload_update(store, "ckpt", tag(s - 1), tag(s),
                              {"state": {"w": torch.from_numpy(state)}})
    return store


def test_publish_crash_leaves_the_old_index_whole(tmp_path, rng):
    """A publisher killed at ``bundle.publish`` of the index: readers see
    the old advertisement (every entry still fetchable); the restarted
    publisher advances it."""
    store = build_steps(tmp_path, rng, 3)
    reg = PassiveRegistry(str(tmp_path / "reg"))
    old = reg.publish_image(store, "ckpt", tag(2), from_tags=[tag(1)])
    with inject(0, FaultSpec(point="bundle.publish", mode="crash",
                             match=":ckpt:index")) as inj:
        with pytest.raises(CrashInjected):
            reg.publish_image(store, "ckpt", tag(3), from_tags=[tag(2)])
    assert inj.fired("bundle.publish") == 1
    stale = reg.read_index("ckpt")
    assert stale == old                               # old or new, never torn
    for entry in stale.entries:
        reg.fetch_bundle("ckpt", entry)
    fresh = reg.publish_image(store, "ckpt", tag(3), from_tags=[tag(2)])
    assert reg.read_index("ckpt") == fresh and fresh.head == tag(3)


def test_dropped_bundle_write_is_not_advertised(tmp_path, rng):
    """A bundle file that fails to publish (a torn bundle) is NOT
    advertised: the index written after it names only bundles that
    landed, and each of those fetches."""
    store = build_steps(tmp_path, rng, 2)
    reg = PassiveRegistry(str(tmp_path / "reg"))
    with inject(0, FaultSpec(point="bundle.publish", mode="drop",
                             match=f"{tag(1)}->{tag(2)}")) as inj:
        index = reg.publish_image(store, "ckpt", tag(2), from_tags=[tag(1)])
    assert inj.fired("bundle.publish") == 1
    assert index.entry(tag(1), tag(2)) is None
    full = index.entry("", tag(2))
    assert full is not None
    reg.fetch_bundle("ckpt", full)


# ---------------------------------------------------------- repair.commit
@pytest.mark.parametrize("point", ["repair.pull", "repair.commit"])
def test_crash_mid_repair_leaves_no_worse_then_retry_converges(tmp_path,
                                                               point):
    """A repairer killed during the pull (quarantines done, swap-ins not)
    or at the commit probe (swap-ins done, flush not) leaves the store no
    worse than before: the rotted blobs are in quarantine, nothing torn
    was swapped in, and a clean retry heals it to deep-verified."""
    ins = [Instruction("FROM", "base", "config"),
           Instruction("COPY", "params", "content"),
           Instruction("CMD", "serve", "config")]
    src, dst = mk(tmp_path, "src"), mk(tmp_path, "dst")
    src.build_image("m", "v1", ins, {"params": lambda: {
        "w": torch.arange(3000, dtype=torch.float32)}})
    push_delta(src, dst, "m", "v1")
    flipped = {h for h, _ in inject_bitrot(dst.root, seed=2, count=2)}
    assert len(flipped) == 2
    with inject(3, FaultSpec(point=point, mode="crash", match=dst.root,
                             times=1)) as inj:
        with pytest.raises(CrashInjected):
            repair_image(dst, "m", "v1", peers=[src])
    assert inj.fired(point) == 1
    rep = dst.scrub()
    assert {f.kind for f in rep.corruptions} <= {"missing_blob"}
    assert set(dst.quarantined_blobs()) == flipped
    rr = repair_image(dst, "m", "v1", peers=[src])
    assert rr.verified_clean
    assert dst.verify_image("m", "v1", deep=True) == []
    assert dst.scrub().clean
