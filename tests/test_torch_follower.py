"""The port's ``CheckpointFollower`` against the JAX package's.

Both followers track the same trainer store (or the same passive bundle
registry) into replicas of their own, over the same sequence of saves, and
every poll must agree exactly: ``SparseUpdate`` (step, changed leaves,
tensors loaded, the bytes of every tensor), the pull's ``PushStats``, the
passive planner's ``PassivePullStats``, the relay tier's ``FanoutStats``
and ``FollowerHealth`` after the same scripted faults (``staleness_s`` and
wall times excluded). The stores interchange both ways, and the whole loop
(poll -> engine -> save -> ``poll_and_refresh`` -> generate) gives the
JAX engine's greedy tokens at a 2-layer yi-6b.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.ft as JF  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import CheckpointPolicy as JaxPolicy  # noqa: E402
from repro.ckpt.manager import prune_steps as jax_prune_steps  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serve import CheckpointFollower as JaxFollower  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro_torch.ckpt import CheckpointManager, CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.manager import prune_steps  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import tensor_to_bytes  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import CheckpointFollower, Engine  # noqa: E402

CHUNK = 512
IMAGE = "ckpt"


def tag(step):
    return f"step-{step:08d}"


def states(n, seed=0):
    """``n`` successive numpy param trees (bf16 and f32 leaves, a nested
    subtree); each save edits one row of ``blocks/wq`` and scales
    ``final_norm``."""
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
        q = {**p, "blocks": dict(p["blocks"])}
        wq = p["blocks"]["wq"].copy()
        wq[k % 2, k, :] = wq[k % 2, k + 1, :]
        q["blocks"]["wq"] = wq
        q["final_norm"] = p["final_norm"] * np.float32(1.5)
        out.append(q)
        p = q
    return out


def port_manager(root, registry=None, keep=10):
    return CheckpointManager(root, "tiny", CheckpointPolicy(
        use_fingerprints=True, chunk_bytes=CHUNK, async_write=False,
        keep=keep), registry=registry)


def stats(x):
    """A stats dataclass as a dict, wall times and staleness dropped."""
    if x is None:
        return None
    out = {}
    for f in dataclasses.fields(x):
        if f.name in ("wall_s", "exception", "staleness_s",
                      "backoff_total_s"):
            continue
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            v = stats(v)
        elif isinstance(v, list):
            v = [stats(e) if dataclasses.is_dataclass(e) else e for e in v]
        out[f.name] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def leaf_bytes(tree):
    """{path: (dtype name, shape, raw bytes)} of a numpy or torch tree;
    bf16 compares through its 16-bit pattern."""
    out = {}
    for k, v in _flat(tree).items():
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cpu"       # poll returns host tensors
            name = str(v.dtype).replace("torch.", "")
            out[k] = (name, tuple(v.shape), bytes(tensor_to_bytes(v)))
        else:
            v = np.asarray(v)
            out[k] = (str(v.dtype), v.shape, v.tobytes())
    return out


def health(f):
    """``FollowerHealth`` as a dict; the last error loses the key's tail,
    which names each follower's own replica."""
    h = stats(f.health())
    if h["last_error"]:
        h["last_error"] = h["last_error"].split(" (")[0]
    return h


def update_view(upd):
    if upd is None:
        return None
    return dict(step=upd.step, full=upd.full,
                changed_params=upd.changed_params,
                changed_opt=upd.changed_opt,
                tensors_loaded=upd.tensors_loaded,
                params=leaf_bytes(upd.params),
                opt_state=leaf_bytes(upd.opt_state))


def poll_both(jf, tf):
    uj, ut = jf.poll(), tf.poll()
    assert update_view(ut) == update_view(uj)
    assert stats(tf.last_pull) == stats(jf.last_pull)
    assert stats(tf.last_plan) == stats(jf.last_plan)
    assert health(tf) == health(jf)
    return uj, ut


def test_smart_follower_updates_equal(tmp_path):
    trees = states(4)
    mgr = port_manager(str(tmp_path / "src"))
    jf = JaxFollower(remote=str(tmp_path / "src"), local=str(tmp_path / "rj"))
    tf = CheckpointFollower(remote=str(tmp_path / "src"),
                            local=str(tmp_path / "rt"))
    assert poll_both(jf, tf) == (None, None)
    for step, p in enumerate(trees):
        mgr.save(step, params_from_jax(p, "cpu"), {})
        uj, ut = poll_both(jf, tf)
        assert ut.step == step and ut.full == (step == 0)
        if step:
            assert ut.changed_params == {"blocks/wq", "final_norm"}
            assert ut.tensors_loaded == 3       # with opt/__step__
    assert poll_both(jf, tf) == (None, None)
    # retention at keep=2, the same tags at both replicas
    assert T.LayerStore(str(tmp_path / "rt")).list_tags(IMAGE) == \
        J.LayerStore(str(tmp_path / "rj")).list_tags(IMAGE) == \
        [tag(2), tag(3)]


def _rot(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def test_passive_follower_updates_equal_and_skips_a_rotten_bundle(tmp_path):
    trees = states(4)
    reg = str(tmp_path / "reg")
    mgr = port_manager(str(tmp_path / "src"), registry=reg)
    jf = JaxFollower(remote=None, registry=reg, local=str(tmp_path / "rj"))
    tf = CheckpointFollower(remote=None, registry=reg,
                            local=str(tmp_path / "rt"))
    for step, p in enumerate(trees):
        mgr.save(step, params_from_jax(p, "cpu"), {})
        assert mgr.last_publish_error is None
        if step == 3:
            # the one-hop bundle to the head rots on the object store: both
            # followers must skip that edge and replan around it
            entry = next(e for e in mgr.last_publish.entries
                         if e.from_tag == tag(2) and e.to_tag == tag(3))
            _rot(os.path.join(reg, IMAGE, entry.path))
        uj, ut = poll_both(jf, tf)
        assert ut.step == step
        assert tf.last_plan.negotiations == 0 and tf.last_plan.hops >= 1
    assert tf.last_plan.edges_skipped == 1
    assert T.LayerStore(str(tmp_path / "rt")).verify_image(
        IMAGE, tag(3), deep=True) == []


def test_relay_follower_updates_and_fan_equal(tmp_path):
    trees = states(3)
    mgr = port_manager(str(tmp_path / "src"))
    jf = JaxFollower(remote=str(tmp_path / "src"), local=str(tmp_path / "rj"),
                     children=[str(tmp_path / "ej")])
    tf = CheckpointFollower(remote=str(tmp_path / "src"),
                            local=str(tmp_path / "rt"),
                            children=[str(tmp_path / "et")])
    for step, p in enumerate(trees):
        mgr.save(step, params_from_jax(p, "cpu"), {})
        poll_both(jf, tf)
        assert stats(tf.last_fan) == stats(jf.last_fan)
        assert tf.last_fan.ok
    edge = T.LayerStore(str(tmp_path / "et"))
    assert edge.list_tags(IMAGE) == [tag(1), tag(2)]
    assert edge.verify_image(IMAGE, tag(2), deep=True) == []


def _wq_chunk_only_in(store, old, new):
    """A blob of ``params/blocks/wq`` that tag ``old`` references and tag
    ``new`` does not."""
    def chunks(t):
        m, _ = store.read_image(IMAGE, t)
        for lid in m.layer_ids:
            for r in store.read_layer(lid).records:
                if r.name == "params/blocks/wq":
                    return set(r.chunks)
    return sorted(chunks(old) - chunks(new))[0]


def test_health_and_verify_gate_equal_after_scripted_faults(tmp_path):
    """A dropped pull, a clean full poll, a sparse poll, then an at-rest
    corrupt blob that the next revision reuses: the verify gate catches it,
    one in-line repair heals it, and the update is applied."""
    trees = states(2)
    mgr = port_manager(str(tmp_path / "src"))
    jf = JaxFollower(remote=str(tmp_path / "src"), local=str(tmp_path / "rj"))
    tf = CheckpointFollower(remote=str(tmp_path / "src"),
                            local=str(tmp_path / "rt"))
    mgr.save(0, params_from_jax(trees[0], "cpu"), {})
    for f, fpkg in ((jf, JF), (tf, TF)):
        with fpkg.inject(0, fpkg.FaultSpec("follower.pull", "drop")):
            with pytest.raises(ConnectionError):
                f.poll()
    assert health(tf) == health(jf)
    assert tf.health().failures == 1
    poll_both(jf, tf)
    mgr.save(1, params_from_jax(trees[1], "cpu"), {})
    poll_both(jf, tf)
    # step 2 reverts wq to step 0's: its chunk is still held (keep=2) and
    # is not sent again, so rot at rest there reaches the gate
    mgr.save(2, params_from_jax(trees[0], "cpu"), {})
    for root in (tmp_path / "rj", tmp_path / "rt"):
        st = J.LayerStore(str(root))
        _rot(st._blob_path(_wq_chunk_only_in(st, tag(0), tag(1))))
    uj, ut = poll_both(jf, tf)
    assert ut.step == 2 and ut.changed_params == {"blocks/wq", "final_norm"}
    h = tf.health()
    assert (h.polls, h.failures, h.corrupt_polls, h.repairs) == (4, 1, 1, 1)
    assert T.LayerStore(str(tmp_path / "rt")).verify_image(
        IMAGE, tag(2), deep=True) == []


def test_passive_follower_refuses_a_corrupt_revision_it_cannot_heal(tmp_path):
    trees = states(2)
    reg = str(tmp_path / "reg")
    mgr = port_manager(str(tmp_path / "src"), registry=reg)
    jf = JaxFollower(remote=None, registry=reg, local=str(tmp_path / "rj"))
    tf = CheckpointFollower(remote=None, registry=reg,
                            local=str(tmp_path / "rt"))
    mgr.save(0, params_from_jax(trees[0], "cpu"), {})
    poll_both(jf, tf)
    mgr.save(1, params_from_jax(trees[1], "cpu"), {})
    with TF.inject(0, TF.FaultSpec("store.write_blob", "bitrot",
                                   match=str(tmp_path / "rt"))), \
            JF.inject(0, JF.FaultSpec("store.write_blob", "bitrot",
                                      match=str(tmp_path / "rj"))):
        assert poll_both(jf, tf) == (None, None)
    assert tf.health().corrupt_polls == 1 and tf.health().repairs == 0
    assert tf.last_verify_error == jf.last_verify_error
    assert tf.last_verify_error.startswith(f"{tag(1)}: corrupt blob")
    assert tf.last_step == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stores_interchange_between_trainer_and_follower(tmp_path, writer):
    """One package's manager saves, the other's follower pulls."""
    trees = states(3)
    src = str(tmp_path / "src")
    if writer == "jax":
        mgr = JaxManager(src, "tiny", JaxPolicy(
            chunk_bytes=CHUNK, async_write=False, keep=10))
        save = lambda s, p: mgr.save(s, p, {})
        follower = CheckpointFollower(remote=src, local=str(tmp_path / "r"))
    else:
        mgr = port_manager(src)
        save = lambda s, p: mgr.save(s, params_from_jax(p, "cpu"), {})
        follower = JaxFollower(remote=src, local=str(tmp_path / "r"))
    for step, p in enumerate(trees):
        save(step, p)
        upd = follower.poll()
        assert upd.step == step
        want = leaf_bytes(p)
        got = leaf_bytes(upd.params)
        assert {k: got[k] for k in (want if upd.full else
                                    upd.changed_params)} == \
            {k: want[k] for k in (want if upd.full else upd.changed_params)}
    # each package's deep verification passes on the other's replica
    assert J.LayerStore(str(tmp_path / "r")).verify_image(
        IMAGE, tag(2), deep=True) == []
    assert T.LayerStore(str(tmp_path / "r")).verify_image(
        IMAGE, tag(2), deep=True) == []


def test_replica_fed_by_jax_then_port_receives_only_new_chunks(tmp_path):
    trees = states(2)
    src = str(tmp_path / "src")
    mgr = port_manager(src)
    mgr.save(0, params_from_jax(trees[0], "cpu"), {})
    JaxFollower(remote=src, local=str(tmp_path / "r")).poll()
    shutil.copytree(tmp_path / "r", tmp_path / "rj")
    mgr.save(1, params_from_jax(trees[1], "cpu"), {})
    # a fresh follower of either package: its first poll is a full update,
    # yet the pull negotiates against what the replica already holds
    tf = CheckpointFollower(remote=src, local=str(tmp_path / "r"))
    jf = JaxFollower(remote=src, local=str(tmp_path / "rj"))
    uj, ut = poll_both(jf, tf)
    assert ut.full and ut.step == 1
    m0, _ = mgr.store.read_image(IMAGE, tag(0))
    m1, _ = mgr.store.read_image(IMAGE, tag(1))

    def blobs(m):
        return {h for lid in m.layer_ids
                for r in mgr.store.read_layer(lid).records for h in r.chunks}
    new = blobs(m1) - blobs(m0)
    assert tf.last_pull.blobs_sent == len(new)
    assert tf.last_pull.bytes_payload == sum(
        len(mgr.store.read_blob(h)) for h in new)
    # the holdings either package derives from the other's replica agree
    hj = J.LayerStore(str(tmp_path / "r")).holdings_index()
    ht = T.LayerStore(str(tmp_path / "r")).holdings_index()
    assert dataclasses.asdict(ht) == dataclasses.asdict(hj)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_incremental_save_reraises_a_simulated_crash(tmp_path, pkg):
    """A CrashInjected from inside ``inject_image_multi`` (here at the
    store's commit) is the process dying: the save must not fall back to a
    full rebuild after it, so the previous step stays the newest."""
    trees = states(2)
    root = str(tmp_path / "s")
    if pkg == "jax":
        mgr, fpkg = JaxManager(root, "tiny", JaxPolicy(
            chunk_bytes=CHUNK, async_write=False)), JF
        save = lambda s, p: mgr.save(s, p, {})
    else:
        mgr, fpkg = port_manager(root), TF
        save = lambda s, p: mgr.save(s, params_from_jax(p, "cpu"), {})
    save(0, trees[0])
    with fpkg.inject(0, fpkg.FaultSpec("store.commit", "crash")) as inj:
        with pytest.raises(fpkg.CrashInjected):
            save(1, trees[1])
    assert inj.fired("store.commit") == 1
    assert mgr.latest_step() == 0
    assert mgr.store.list_tags(IMAGE, fresh=True) == [tag(0)]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prune_steps_keeps_a_leased_tag(tmp_path, pkg):
    trees = states(4)
    src = str(tmp_path / "src")
    port_manager(src, keep=10)
    mgr = port_manager(src)
    for step, p in enumerate(trees):
        mgr.save(step, params_from_jax(p, "cpu"), {})
    store = (J if pkg == "jax" else T).LayerStore(src, chunk_bytes=CHUNK)
    prune = jax_prune_steps if pkg == "jax" else prune_steps
    store.acquire_lease(IMAGE, tag(0), "relay-child-0", ttl_s=600.0)
    assert store.remove_image(IMAGE, tag(0)) is False
    assert prune(store, IMAGE, 1) is True
    assert store.list_tags(IMAGE) == [tag(0), tag(3)]
    assert store.verify_image(IMAGE, tag(0), deep=True) == []
    assert store.release_lease(IMAGE, "relay-child-0") == 1
    assert prune(store, IMAGE, 1) is True
    assert store.list_tags(IMAGE) == [tag(3)]


def test_poll_and_refresh_serves_the_jax_engines_tokens(tmp_path):
    """poll -> Engine -> save -> poll_and_refresh -> generate at a 2-layer
    yi-6b (f32, so greedy tokens compare exactly across frameworks)."""
    cfg = get_smoke_config("yi-6b").replace(param_dtype="float32",
                                            compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    p0 = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(5)))
    p1 = {**p0, "blocks": dict(p0["blocks"])}
    p1["blocks"]["wk"] = p0["blocks"]["wk"].copy()
    p1["blocks"]["wk"][1] += np.float32(0.05)
    p1["final_norm"] = p0["final_norm"] * np.float32(1.5)
    src = str(tmp_path / "src")
    mgr = CheckpointManager(src, cfg.name, CheckpointPolicy(
        use_fingerprints=True, chunk_bytes=2048, async_write=False))
    mgr.save(0, params_from_jax(p0, "cpu"), {})
    fol = CheckpointFollower(remote=src, local=str(tmp_path / "rep"))
    upd = fol.poll()
    assert upd.full and upd.step == 0
    eng = Engine(tcfg, upd.params, max_len=64, device="cpu")
    prompts = (np.arange(2 * 9, dtype=np.int32).reshape(2, 9) * 7) % cfg.vocab
    r0 = eng.generate(prompts, 8)
    mgr.save(1, params_from_jax(p1, "cpu"), {})
    upd = fol.poll_and_refresh(eng)
    assert upd.changed_params == {"blocks/wk", "final_norm"}
    assert eng.last_refresh_leaves == 2 and eng.health().last_refresh_step == 1
    r1 = eng.generate(prompts, 8)
    j0 = JaxEngine(cfg, jax.tree.map(jnp.asarray, p0), max_len=64)
    j1 = JaxEngine(cfg, jax.tree.map(jnp.asarray, p1), max_len=64)
    assert np.array_equal(r0.tokens, j0.generate(prompts, 8).tokens)
    assert np.array_equal(r1.tokens, j1.generate(prompts, 8).tokens)
    assert fol.poll_and_refresh(eng) is None
    h = fol.health()
    assert (h.polls, h.failures, h.last_success_step) == (3, 0, 1)
