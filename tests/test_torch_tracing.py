"""The port's spans (``repro_torch.tracing``): nothing is recorded, and no
profiler range entered, while no profiler records; under a profiler a
batch, a save and a deploy record the span tree of their stages, each
child inside its parent by ids and times, with the counts of its call."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import CheckpointFollower, Engine  # noqa: E402

STEPS = 4
PROMPT = 8
SAVE = ("ckpt.save", "ckpt.detect", "store.inject", "store.flush",
        "ckpt.retain")
SYNC = ("follower.sync", "follower.poll", "follower.pull",
        "registry.negotiate", "registry.transfer", "registry.commit",
        "follower.plan", "follower.verify", "follower.load",
        "follower.prune", "engine.refresh")


@pytest.fixture
def cfg():
    return get_smoke_config("yi-6b")


@pytest.fixture
def params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture
def prompts(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (2, PROMPT),
                                             dtype=np.int32)


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def edited(params, step):
    """A copy of ``params`` whose ``final_norm`` and one embedding row
    moved (two leaves; the rest shared)."""
    new = dict(params)
    new["final_norm"] = params["final_norm"] * (1 + step)
    embed = params["embed"].clone()
    embed[step] += 1
    new["embed"] = embed
    return new


def deploy_rig(tmp_path, cfg, params, async_write=False):
    mgr = CheckpointManager(str(tmp_path / "trainer"), cfg.name,
                            CheckpointPolicy(use_fingerprints=True,
                                             chunk_bytes=4096,
                                             async_write=async_write))
    mgr.save(0, params, {})
    mgr.wait()
    follower = CheckpointFollower(remote=mgr.store,
                                  local=str(tmp_path / "replica"), keep=2)
    engine = Engine(cfg, follower.poll().params, max_len=PROMPT + STEPS,
                    device="cpu")
    return mgr, follower, engine


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def assert_inside(child, parent):
    assert child.parent == parent.id
    assert parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


def test_off_records_nothing_and_enters_no_range(tmp_path, cfg, params,
                                                 prompts, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.recording()
    assert tracing.span("a", x=1) is tracing.span("b")
    mgr, follower, engine = deploy_rig(tmp_path, cfg, params)
    engine.generate(prompts, STEPS)
    mgr.save(1, edited(params, 1), {})
    assert follower.poll_and_refresh(engine).step == 1
    assert tracing.spans() == []


def test_off_reads_no_clock(monkeypatch):
    def refuse():
        raise AssertionError("the clock was read with no profiler on")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    with tracing.span("a", x=1) as sp:
        sp.set(y=2)
    assert tracing.spans() == []


def test_generate_records_prefill_and_each_decode_step(cfg, params, prompts):
    engine = Engine(cfg, params, max_len=PROMPT + STEPS, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        res = engine.generate(prompts, STEPS)
    assert not tracing.recording()
    assert res.tokens.shape == (2, STEPS)
    spans = tracing.spans()
    names = by_name(spans)
    [gen] = names["engine.generate"]
    assert gen.parent is None
    assert gen.attrs == {"batch": 2, "prompt": PROMPT, "steps": STEPS,
                         "seq": 1}
    [pre] = names["engine.prefill"]
    steps = names["engine.decode_step"]
    assert [s.attrs["pos"] for s in steps] == \
        [PROMPT + i for i in range(STEPS)]
    assert children(spans, gen) == [pre] + steps
    for s in [pre] + steps:
        assert_inside(s, gen)
        [wait] = children(spans, s)
        assert wait.name == "engine.token_wait"
        assert_inside(wait, s)
    assert len(names["engine.token_wait"]) == STEPS + 1
    # the children follow one another
    for a, b in zip([pre] + steps, steps):
        assert a.t1_ns <= b.t0_ns
    # the same ranges on the profiler's clock, each child inside its parent
    events = [e for e in prof.events() if e.name.startswith("engine.")]
    assert sorted(e.name for e in events) == sorted(s.name for s in spans)
    ranges = {}
    for e in events:
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    g0, g1 = ranges["engine.generate"][0]
    for name in ("engine.prefill", "engine.decode_step", "engine.token_wait"):
        for t0, t1 in ranges[name]:
            assert g0 <= t0 <= t1 <= g1
    for t0, t1 in ranges["engine.token_wait"]:
        assert any(s0 <= t0 <= t1 <= s1 for s0, s1 in
                   ranges["engine.prefill"] + ranges["engine.decode_step"])
    # a second batch has the next sequence number
    with profile(activities=[ProfilerActivity.CPU]):
        engine.generate(prompts, STEPS)
    assert [s.attrs["seq"] for s in tracing.spans()
            if s.name == "engine.generate"] == [1, 2]


def test_a_deploy_records_the_save_and_the_sync(tmp_path, cfg, params,
                                                prompts):
    mgr, follower, engine = deploy_rig(tmp_path, cfg, params)
    new = edited(params, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        report = mgr.save(1, new, {})
        upd = follower.poll_and_refresh(engine)
    assert upd.step == 1 and upd.changed_params == {"embed", "final_norm"}
    spans = tracing.spans()
    names = by_name(spans)
    assert set(names) == set(SAVE + SYNC)
    assert all(len(v) == 1 for v in names.values())
    one = {k: v[0] for k, v in names.items()}

    save = one["ckpt.save"]
    assert save.parent is None
    assert save.attrs["step"] == 1 and save.attrs["kind"] == "incremental"
    assert save.attrs["bytes_serialized"] == report.bytes_serialized > 0
    assert save.attrs["chunks_written"] == report.chunks_written
    assert children(spans, save) == [one["ckpt.detect"], one["store.inject"],
                                     one["ckpt.retain"]]
    assert one["ckpt.detect"].attrs["bytes_d2h"] == report.bytes_d2h > 0
    inject = one["store.inject"]
    assert inject.attrs == {"chunks": report.chunks_written,
                            "bytes_hashed": report.bytes_hashed,
                            "bytes_written": report.bytes_serialized}
    assert_inside(one["store.flush"], inject)
    assert one["store.flush"].attrs["fsyncs"] > 0

    sync = one["follower.sync"]
    assert sync.parent is None and sync.attrs == {"step": 1}
    assert sync.t0_ns >= save.t1_ns
    poll = one["follower.poll"]
    assert poll.attrs == {"step": 1, "full": False}
    assert children(spans, sync) == [poll, one["engine.refresh"]]
    assert children(spans, poll) == [
        one[n] for n in ("follower.pull", "follower.plan", "follower.verify",
                         "follower.load", "follower.prune")]
    pull = one["follower.pull"]
    assert children(spans, pull) == [
        one[n] for n in ("registry.negotiate", "registry.transfer",
                         "registry.commit")]
    stats = follower.last_pull
    assert pull.attrs == {"bytes_sent": stats.bytes_sent,
                          "blobs_sent": stats.blobs_sent,
                          "blobs_hashed_remote": stats.blobs_hashed_remote}
    transfer = one["registry.transfer"]
    assert transfer.attrs == {"blobs": stats.blobs_sent,
                              "bytes": stats.bytes_payload}
    swapped = new["embed"].nbytes + new["final_norm"].nbytes
    assert one["engine.refresh"].attrs == {"full": False, "leaves": 2,
                                           "bytes": swapped}
    # the replica also loads and re-hashes the checkpoint's int32 step
    assert one["follower.load"].attrs == {"tensors": 3, "bytes": swapped + 4}
    verify = one["follower.verify"].attrs
    assert verify["bytes"] == swapped + 4 and verify["blobs"] > 0
    for s in spans:
        if s.parent is not None:
            parent = next(p for p in spans if p.id == s.parent)
            assert_inside(s, parent)
    # the swap served what the trainer saved
    assert torch.equal(engine.params["embed"], new["embed"])


def test_a_full_refresh_counts_every_leaf(cfg, params):
    engine = Engine(cfg, params, max_len=PROMPT + STEPS, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        engine.refresh(params)
    [sp] = tracing.spans()
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["blocks"].values()]
    assert sp.attrs == {"full": True, "leaves": len(leaves),
                        "bytes": sum(t.nbytes for t in leaves)}


def test_an_async_save_records_roots_in_its_own_thread(tmp_path, cfg,
                                                       params):
    mgr = CheckpointManager(str(tmp_path / "trainer"), cfg.name,
                            CheckpointPolicy(use_fingerprints=True,
                                             chunk_bytes=4096,
                                             async_write=True))
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("caller") as caller:
            mgr.save(0, params, {})
            mgr.save(1, edited(params, 1), {})
            report = mgr.wait()
    spans = tracing.spans()
    saves = [s for s in spans if s.name == "ckpt.save"]
    assert [(s.attrs["step"], s.attrs["kind"]) for s in saves] == \
        [(0, "full"), (1, "incremental")]
    assert all(s.parent is None for s in saves)
    assert saves[1].attrs["bytes_serialized"] == report.bytes_serialized
    assert not children(spans, caller)
    for save in saves:
        kids = [s.name for s in children(spans, save)]
        assert kids == (["store.inject", "ckpt.detect", "ckpt.retain"]
                        if save.attrs["kind"] == "full" else
                        ["ckpt.detect", "store.inject", "ckpt.retain"])
