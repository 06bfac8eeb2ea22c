"""Chaos harness: the seeded fault matrix CI soaks nightly (torch port of
``repro/ft/chaos.py``: the same cells on the port's stores, registry and
follower; payloads are torch tensors drawn from the same numpy seeds, so
every blob id is the JAX package's).

Every cell of ``(drop | corrupt | delay | crash | bitrot) x (push | fanout
| relay | follower | bundle)`` runs one end-to-end replication under seeded faults
and asserts the topology converges **automatically** — no manual retry
call — to bit-identical committed replicas at every tier with zero torn
stores (``verify_image(deep=True)`` clean everywhere). The first four
modes strike in-flight (an installed ``FaultInjector`` at the wire/commit
seams); ``bitrot`` strikes at rest — seeded byte-flips in committed blobs
(``ft.faults.inject_bitrot``, plus a persisted ``store.write_blob`` flip
for the follower cell) that the scrub -> repair -> rollback loop must
detect 100%, heal from ANY peer (source, sibling replica, or a relay's
own CHILD), and re-verify deep-clean. Fire decisions are a pure function
of the seed (see ``ft.faults``), so any failing cell replays
bit-identically from the repro line it prints:

    PYTHONPATH=src python -m repro_torch.ft.chaos --seeds 7 \\
        --scenarios relay --modes corrupt

Usage (tests import these; CI runs the CLI):

    from repro_torch.ft.chaos import run_cell, run_matrix
    cell = run_cell("fanout", "crash", seed=3, base_dir=tmp)   # one cell
    cells = run_matrix(seeds=range(4))                         # full matrix
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .faults import CrashInjected, FaultSpec, inject, inject_bitrot
from .retry import RetryPolicy

MODES = ("drop", "corrupt", "delay", "crash", "bitrot")
SCENARIOS = ("push", "fanout", "relay", "follower", "bundle")

#: the nightly soak's seed range — CI shards it across a job matrix with
#: the ``I::S`` stride shorthand (see ``parse_seeds``)
SOAK_SEEDS = 16


def parse_seeds(spec: str):
    """Seed-spec grammar shared by the chaos and scrub CLIs: ``'N'`` (one
    seed), ``'A:B'`` (a range), ``'A:B:S'`` (a strided range), and the CI
    shard shorthand ``'I::S'`` — shard I of stride S over the nightly
    ``[0, SOAK_SEEDS)`` soak range, so 4 matrix jobs running ``0::4``
    .. ``3::4`` cover exactly the full range with no overlap."""
    if ":" not in spec:
        return [int(spec)]
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"bad seed spec {spec!r}")
    lo = int(parts[0]) if parts[0] else 0
    hi = int(parts[1]) if parts[1] else SOAK_SEEDS
    stride = int(parts[2]) if len(parts) == 3 and parts[2] else 1
    return range(lo, hi, stride)

# fast-converging policy: chaos cells only need *bounded* waits, the
# backoff-shape guarantees are hypothesis-proved in test_retry_property
_POLICY_KW = dict(max_attempts=4, base_delay_s=0.001, max_delay_s=0.02)


@dataclass
class ChaosCell:
    """Outcome of one matrix cell (also the failure record: ``error``
    carries the assertion + the repro line)."""

    scenario: str
    mode: str
    seed: int
    fired: int = 0                  # fault events the injector logged
    retries_spent: int = 0
    ok: bool = False
    error: str = ""

    @property
    def repro(self) -> str:
        return (f"PYTHONPATH=src python -m repro_torch.ft.chaos "
                f"--seeds {self.seed} --scenarios {self.scenario} "
                f"--modes {self.mode}")


# --------------------------------------------------------------- fixtures
def _stores(base_dir: str, *names: str):
    from ..core import LayerStore
    return [LayerStore(str(Path(base_dir) / n), chunk_bytes=512)
            for n in names]


def _normal(rng, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def _payloads(seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(1000 + seed)
    return {"src": {"a": _normal(rng, 1000), "b": _normal(rng, 500)},
            "deps": {"lib": _normal(rng, 4000)}}


def _build_app(store, payloads) -> None:
    from ..core import Instruction
    ins = [Instruction("FROM", "base", "config"),
           Instruction("COPY", "src", "content"),
           Instruction("RUN", "deps", "content"),
           Instruction("CMD", "run", "config")]
    store.build_image("app", "v1", ins,
                      {k: (lambda v=v: v) for k, v in payloads.items()})


def _inject_v2(store, payloads) -> None:
    from ..core import inject_payload_update
    src2 = {k: v.clone() for k, v in payloads["src"].items()}
    src2["b"][3] = 42.0                     # ONE changed 512 B chunk
    inject_payload_update(store, "app", "v1", "v2", {"src": src2},
                          providers={"deps": lambda: payloads["deps"]})


def _snapshot(store, name: str, tag: str) -> dict:
    """Byte-exact image state — manifest, config, layer files, blobs."""
    manifest, config = store.read_image(name, tag)
    layers, blobs = {}, {}
    for lid in manifest.layer_ids:
        with open(store._layer_path(lid), "rb") as f:
            layers[lid] = f.read()
        for rec in store.read_layer(lid).records:
            for h in rec.chunks:
                blobs[h] = store.read_blob(h)
    return {"manifest": manifest.to_json(), "config": config.to_json(),
            "layers": layers, "blobs": blobs}


def _assert_converged(src, dsts, name: str, tag: str) -> None:
    want = _snapshot(src, name, tag)
    for d in dsts:
        problems = d.verify_image(name, tag, deep=True)
        assert problems == [], f"torn store {d.root}: {problems}"
        assert _snapshot(d, name, tag) == want, \
            f"replica {d.root} not bit-identical to source"


#: every in-flight protocol seam, with the side of the wire it strikes —
#: cells rotate through this table seed by seed, so the nightly soak
#: range ([0, 16)) hits each seam at least twice under every mode. Every
#: fault point of the port belongs here or in a scenario's own specs: an
#: uncovered point is a dead kill-matrix cell.
SEAMS = (
    ("wire.negotiate", "dst"),
    ("wire.probe_blobs", "dst"),
    ("wire.receive_layer", "dst"),
    ("wire.receive_blob", "dst"),
    ("wire.commit", "dst"),
    ("store.read_blob", "src"),     # the SOURCE's disk read, mid-ship
    ("store.commit", "dst"),        # death/drop inside write_image
)


def _spec(mode: str, seed: int, dst_root: str,
          src_root: Optional[str] = None) -> FaultSpec:
    """The seam this cell strikes, rotated by seed. Topologies without a
    distinct source side (fan-out replicas share one source with the
    healthy majority) fall back to the canonical transfer seam so the
    fault stays scoped to the one sick replica."""
    point, side = SEAMS[seed % len(SEAMS)]
    if side == "src":
        if src_root is None:
            point = "wire.receive_blob"
        else:
            return FaultSpec(point=point, mode=mode, match=src_root)
    return FaultSpec(point=point, mode=mode, match=dst_root)


# ------------------------------------------------------- at-rest bitrot
def _chunkset(store, name: str, tag: str) -> list:
    """Every blob hash ``name:tag`` reaches — restricts the bitrot victim
    pool so the cell knows exactly which image to scrub and repair."""
    m, _ = store.read_image(name, tag)
    out = []
    for lid in m.layer_ids:
        for rec in store.read_layer(lid).records:
            out.extend(rec.chunks)
    return out


def _rot_and_heal(victim, name: str, tag: str, peers, seed: int,
                  count: int = 2) -> int:
    """The shared bitrot cell body: seeded at-rest flips on ``victim``,
    then the full self-healing loop — scrub must detect EXACTLY the
    flipped set (100% detection, no false positives), repair_image must
    restore it pulling only the damaged bytes from the given peers, and a
    re-scrub must run clean. Returns the number of flips (the cell's
    ``fired`` count)."""
    from ..core import repair_image
    flips = inject_bitrot(victim.root, seed, count=count,
                          candidates=_chunkset(victim, name, tag))
    assert flips, "bitrot found no victim blobs — fixture broken?"
    want = {h for h, _ in flips}
    rep = victim.scrub()
    assert set(rep.corrupt_blob_hashes) == want, \
        f"scrub detected {rep.corrupt_blob_hashes} != injected {sorted(want)}"
    # the healing path itself runs under fire: a dropped peer pull and a
    # simulated SIGKILL at the repair commit — a repair session must be
    # restartable from a (now stale) scrub report, re-verifying instead
    # of trusting it
    repair_specs = [FaultSpec(point="repair.pull", mode="drop",
                              match=victim.root, times=1),
                    FaultSpec(point="repair.commit", mode="crash",
                              match=victim.root, times=1)]
    rr = None
    with inject(seed, *repair_specs):
        for _ in range(4):
            try:
                rr = repair_image(victim, name, tag, peers=peers,
                                  scrub_report=rep)
                break
            except (ConnectionError, CrashInjected):
                continue            # the restarted repair session re-plans
    assert rr is not None and rr.verified_clean, \
        "repair did not deep-verify clean"
    assert rr.wire_amplification <= 1.25, \
        f"repair over-pulled: {rr.wire_amplification:.2f}x"
    victim.purge_quarantine()
    assert victim.scrub().clean, "re-scrub after repair found debris"
    return len(flips)


# -------------------------------------------------------------- scenarios
def _run_push(base_dir: str, mode: str, seed: int) -> tuple:
    from ..core import push_delta
    src, dst = _stores(base_dir, "src", "dst")
    payloads = _payloads(seed)
    _build_app(src, payloads)
    push_delta(src, dst, "app", "v1")               # warm base, no faults
    _inject_v2(src, payloads)
    if mode == "bitrot":
        push_delta(src, dst, "app", "v2")           # commit clean, rot at rest
        fired = _rot_and_heal(dst, "app", "v2", [src], seed)
        _assert_converged(src, [dst], "app", "v2")
        return fired, 0
    policy = RetryPolicy(seed=seed, **_POLICY_KW)
    with inject(seed, _spec(mode, seed, dst.root, src.root)) as inj:
        # in-run retries converge drops/corruption; a CrashInjected that
        # escapes is the PUSHER process dying (e.g. at its own disk read)
        # — the restarted pusher re-pushes, per kill-matrix semantics
        for _ in range(4):
            try:
                push_delta(src, dst, "app", "v2", retry=policy)
                break
            except CrashInjected:
                continue
    _assert_converged(src, [dst], "app", "v2")
    return inj.fired(), 0


def _run_fanout(base_dir: str, mode: str, seed: int) -> tuple:
    from ..core import replicate_fanout
    src, r0, r1, r2 = _stores(base_dir, "src", "r0", "r1", "r2")
    payloads = _payloads(seed)
    _build_app(src, payloads)
    replicate_fanout(src, [r0, r1, r2], "app", "v1")
    _inject_v2(src, payloads)
    policy = RetryPolicy(seed=seed, **_POLICY_KW)
    if mode == "bitrot":
        replicate_fanout(src, [r0, r1, r2], "app", "v2")
        # heal the rotten replica from a SIBLING, not the source —
        # any-peer anti-entropy across the fan
        fired = _rot_and_heal(r1, "app", "v2", [r0], seed)
        _assert_converged(src, [r0, r1, r2], "app", "v2")
        return fired, 0
    with inject(seed, _spec(mode, seed, r1.root)) as inj:  # one sick replica
        fan = replicate_fanout(src, [r0, r1, r2], "app", "v2",
                               retry=policy)
    assert fan.majority_ok, "healthy majority failed to commit"
    assert fan.n_ok == 3, \
        f"retry did not converge replica 1: {fan.replicas[1].error}"
    _assert_converged(src, [r0, r1, r2], "app", "v2")
    return inj.fired(), fan.retries_spent


def _run_relay(base_dir: str, mode: str, seed: int) -> tuple:
    from ..core import RelayNode, replicate_fanout
    src, mid, e0, e1 = _stores(base_dir, "src", "mid", "e0", "e1")
    payloads = _payloads(seed)
    _build_app(src, payloads)
    policy = RetryPolicy(seed=seed, **_POLICY_KW)
    relay = RelayNode(mid, children=[e0, e1], retry=policy)
    replicate_fanout(src, [relay], "app", "v1")
    _inject_v2(src, payloads)
    if mode == "bitrot":
        replicate_fanout(src, [relay], "app", "v2")
        # the MID tier rots and heals from its own CHILD — repair runs
        # the delta machinery in reverse, so direction doesn't matter
        fired = _rot_and_heal(mid, "app", "v2", [e1], seed)
        _assert_converged(src, [mid, e0, e1], "app", "v2")
        return fired, 0
    # the edge seam rotates; the relay's own fan point ALSO fires once —
    # the mid tier must survive its fan being dropped/killed and converge
    # through _retry_failed on the next fan attempt
    with inject(seed, _spec(mode, seed, e0.root),
                FaultSpec(point="relay.fan", mode=mode, match=mid.root,
                          times=1)) as inj:           # one sick edge
        fan = replicate_fanout(src, [relay], "app", "v2", retry=policy)
    rep = fan.replicas[0]
    assert rep.ok, f"relay tier failed: {rep.error}"
    assert rep.children is not None and rep.children.n_ok == 2, \
        "child retry did not converge the edge tier"
    _assert_converged(src, [mid, e0, e1], "app", "v2")
    assert not mid.leased("app", "v2"), \
        "converged children must have released their leases"
    return inj.fired(), fan.retries_spent + rep.children.retries_spent


def _run_follower(base_dir: str, mode: str, seed: int) -> tuple:
    # lazy: serve pulls in the model code; the other scenarios do not
    from ..core import Instruction, inject_payload_update
    from ..serve.engine import CheckpointFollower
    remote, local = _stores(base_dir, "remote", "local")
    rng = np.random.default_rng(2000 + seed)
    state = {"params/w": _normal(rng, 1000), "opt/m": _normal(rng, 500),
             "opt/__step__": torch.tensor([1], dtype=torch.int32)}
    ins = [Instruction("FROM", "arch", "config"),
           Instruction("COPY", "state", "content")]
    remote.build_image("ckpt", "step-00000001", ins,
                       {"state": lambda: state})
    policy = RetryPolicy(seed=seed, **_POLICY_KW)
    follower = CheckpointFollower(remote, local, keep=3, retry=policy)
    assert follower.poll().step == 1                 # warm base, no faults
    state2 = {k: v.clone() for k, v in state.items()}
    state2["params/w"][7] = 42.0
    state2["opt/__step__"][0] = 2
    inject_payload_update(remote, "ckpt", "step-00000001",
                          "step-00000002", {"state": state2})
    if mode == "bitrot":
        # a persisted write-path flip: the pull COMMITS a corrupt revision
        # (receive verified the wire bytes, the disk write rotted them) —
        # the follower's verify gate must catch it pre-swap and heal
        # in-line from the remote, within the same poll
        specs = [FaultSpec(point="store.write_blob", mode="bitrot",
                           match=local.root, times=1)]
    else:
        # the rotated seam plus the follower's own pull point: a poll
        # that dies (drop propagates out of _pull; CrashInjected is the
        # simulated SIGKILL) must be converged by the NEXT poll tick —
        # exactly how a supervised follower process behaves
        specs = [_spec(mode, seed, local.root, remote.root),
                 FaultSpec(point="follower.pull", mode=mode,
                           match=local.root, times=1)]
    with inject(seed, *specs) as inj:
        upd = None
        for _ in range(6):
            try:
                upd = follower.poll()
            except (ConnectionError, CrashInjected):
                continue            # the restarted follower re-polls
            if upd is not None and upd.step == 2:
                break
    assert upd is not None and upd.step == 2, "follower failed to advance"
    _assert_converged(remote, [local], "ckpt", "step-00000002")
    health = follower.health()
    assert health.consecutive_failures == 0 and health.last_success_step == 2
    if mode == "bitrot":
        assert health.corrupt_polls >= 1 and health.repairs >= 1, \
            "verify gate never engaged under write-path bitrot"
    return inj.fired(), health.retries_spent


def _run_bundle(base_dir: str, mode: str, seed: int) -> tuple:
    """The passive-registry chain under fire: the publisher writes bundles
    + a signed index through ``bundle.publish`` faults (torn bundle file,
    stale index, corrupt index), the follower plans and pulls through
    ``bundle.fetch`` faults (truncated/corrupt bundle, index/bundle hash
    mismatch, unreachable files). The contract: a corrupted advertisement
    is DETECTED at the edge (index signature, bundle sha) and the
    follower falls back — another published chain, or the smart remote
    pull — converging bit-identically; a crashed publisher leaves a
    stale-but-consistent index its restart converges."""
    from ..core import Instruction, PassiveRegistry, inject_payload_update
    from ..serve.engine import CheckpointFollower
    remote, local = _stores(base_dir, "remote", "local")
    reg = PassiveRegistry(str(Path(base_dir) / "registry"))
    rng = np.random.default_rng(3000 + seed)
    state = {"params/w": _normal(rng, 1000), "opt/m": _normal(rng, 500),
             "opt/__step__": torch.tensor([1], dtype=torch.int32)}
    ins = [Instruction("FROM", "arch", "config"),
           Instruction("COPY", "state", "content")]
    remote.build_image("ckpt", "step-00000001", ins,
                       {"state": lambda: state})
    policy = RetryPolicy(seed=seed, **_POLICY_KW)
    follower = CheckpointFollower(remote, local, keep=5, retry=policy,
                                  registry=reg)
    assert follower.poll().step == 1              # warm base, no faults
    prev_state = state
    for step in (2, 3):
        prev_state = {k: v.clone() for k, v in prev_state.items()}
        prev_state["params/w"][7] = float(step)
        prev_state["opt/__step__"][0] = step
        inject_payload_update(remote, "ckpt", f"step-{step - 1:08d}",
                              f"step-{step:08d}", {"state": prev_state})
    # a clean prior advertisement, so a faulted republish tests the
    # stale-index path (readers see THIS index until the new one lands)
    reg.publish_image(remote, "ckpt", "step-00000002",
                      from_tags=["step-00000001"])

    def publish_head():
        reg.publish_image(remote, "ckpt", "step-00000003",
                          from_tags=["step-00000001", "step-00000002"])

    if mode == "bitrot":
        publish_head()
        # at-rest rot in a published bundle file: the index still
        # advertises the clean hash, so the fetch MUST reject the bytes
        path = Path(reg.root) / "ckpt" / "bundles" / \
            "step-00000001__step-00000003.rdb"
        rotten = bytearray(path.read_bytes())
        rotten[len(rotten) // 2] ^= 0xFF
        path.write_bytes(bytes(rotten))
        fired = 1
        upd = follower.poll()
    else:
        specs = [FaultSpec(point="bundle.publish", mode=mode,
                           match=reg.root),
                 FaultSpec(point="bundle.fetch", mode=mode,
                           match=reg.root)]
        with inject(seed, *specs) as inj:
            # crash fires once PER FILE (spec counters are per key), so a
            # publisher that dies at bundle k restarts and dies at bundle
            # k+1 — bounded by the number of files, then it converges
            for _ in range(6):
                try:
                    publish_head()
                    break
                except CrashInjected:
                    continue        # the restarted publisher re-publishes
            upd = None
            for _ in range(6):
                try:
                    upd = follower.poll()
                except CrashInjected:
                    continue        # the restarted follower re-polls
                if upd is not None and upd.step == 3:
                    break
        fired = inj.fired()
    assert upd is not None and upd.step == 3, \
        "follower failed to reach head through the faulted registry"
    _assert_converged(remote, [local], "ckpt", "step-00000003")
    if mode == "bitrot":
        plan = follower.last_plan
        assert plan is not None and \
            (plan.edges_skipped >= 1 or plan.fallback == "remote"), \
            "rotten bundle was neither skipped nor fallen back from"
    return fired, follower.health().retries_spent


_RUNNERS = {"push": _run_push, "fanout": _run_fanout,
            "relay": _run_relay, "follower": _run_follower,
            "bundle": _run_bundle}


# ---------------------------------------------------------------- harness
def run_cell(scenario: str, mode: str, seed: int,
             base_dir: Optional[str] = None) -> ChaosCell:
    """One matrix cell; raises AssertionError (with the repro line) on a
    convergence failure so pytest integration stays natural."""
    cell = ChaosCell(scenario=scenario, mode=mode, seed=seed)
    try:
        if base_dir is None:
            with tempfile.TemporaryDirectory(prefix="chaos-") as tmp:
                fired, retries = _RUNNERS[scenario](tmp, mode, seed)
        else:
            fired, retries = _RUNNERS[scenario](str(base_dir), mode, seed)
        cell.fired, cell.retries_spent = fired, retries
        assert cell.fired >= 1, \
            f"fault point never fired — {scenario} wiring broken?"
        cell.ok = True
    except AssertionError as e:
        cell.error = f"{e}\n  repro: {cell.repro}"
        raise AssertionError(cell.error) from e
    return cell


def run_matrix(seeds: Iterable[int], modes: Iterable[str] = MODES,
               scenarios: Iterable[str] = SCENARIOS,
               fail_fast: bool = False) -> List[ChaosCell]:
    """The full soak. Never raises unless ``fail_fast`` — failed cells come
    back with ``ok=False`` and their repro line in ``error``."""
    cells: List[ChaosCell] = []
    for seed in seeds:
        for scenario in scenarios:
            for mode in modes:
                try:
                    cells.append(run_cell(scenario, mode, seed))
                except AssertionError as e:
                    if fail_fast:
                        raise
                    cells.append(ChaosCell(scenario=scenario, mode=mode,
                                           seed=seed, error=str(e)))
                except Exception as e:      # noqa: BLE001 — soak must
                    bad = ChaosCell(scenario=scenario, mode=mode,  # report
                                    seed=seed)                     # not die
                    bad.error = f"{type(e).__name__}: {e}\n" \
                                f"  repro: {bad.repro}"
                    if fail_fast:
                        raise AssertionError(bad.error) from e
                    cells.append(bad)
    return cells


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0:4",
                    help="'N', 'A:B', 'A:B:S', or the CI shard "
                         "shorthand 'I::S' (shard I of stride S over "
                         f"[0, {SOAK_SEEDS}))")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--repro-out", default=None, metavar="PATH",
                    help="write failed cells' repro lines here (CI "
                         "uploads the file as a per-shard artifact)")
    args = ap.parse_args(argv)
    cells = run_matrix(parse_seeds(args.seeds),
                       modes=args.modes.split(","),
                       scenarios=args.scenarios.split(","))
    bad = [c for c in cells if not c.ok]
    for c in cells:
        mark = "ok " if c.ok else "FAIL"
        print(f"[{mark}] seed={c.seed:<3d} {c.scenario:<8s} {c.mode:<7s} "
              f"fired={c.fired} retries={c.retries_spent}")
    for c in bad:
        print(f"\nFAILED {c.scenario}/{c.mode} seed={c.seed}:\n{c.error}",
              file=sys.stderr)
    if args.repro_out and bad:
        with open(args.repro_out, "w") as f:
            for c in bad:
                f.write(c.repro + "\n")
        print(f"repro lines written to {args.repro_out}", file=sys.stderr)
    print(f"\n{len(cells) - len(bad)}/{len(cells)} cells converged")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
