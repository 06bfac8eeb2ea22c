"""Serving under a closed loop of clients, optionally while a trainer
deploys a stream of fine-tune deltas to the serving replica.

Mix parameters (``bench/traffic/<mix>.json``):

    clients         requests in flight; each client sends its next request
                    when its last one is answered, and the engine serves
                    the clients' requests as one batch
    prompt_lengths  the lengths a batch may have (every prompt of a batch
                    has one length)
                    (an even number: batches go in complementary pairs,
                    see ``schedule``)
    new_tokens      tokens generated a request, greedy
    check_requests  finished requests sampled after the window for the
                    reference, the longest length among them
    deploy          false: no trainer; true: a deploy before every 2nd
                    batch (the first of each pair)
    metric_suffix   appended to the serving metrics' names, so that a mix
                    whose serving shares the host with deploys reports
                    them apart from plain serving
    update          the delta: "leaves" (a layer of each changes by a
                    rank-"rank" product, scaled to "relative" of the
                    layer's RMS); the first deploy of every block (see
                    ``schedule``) also moves "embed_rows" contiguous rows
                    of the embedding

A deploy is ``CheckpointManager.save`` on the trainer's store, then
``CheckpointFollower.poll_and_refresh`` of the replica's engine; a request
that waits behind it counts the wait. After every deploy the served
leaves are compared with the trainer's bit for bit (on the device, read
after the window) and the blobs the save wrote are linked aside, to be
re-hashed after the window.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..harness import sync
from ..reference.common import flatten
from ..reference.serve import widest_gap
from ..reference.store import (blob_path, chunk_count, chunk_of_elements,
                               chunk_sizes, misaddressed)

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.uint8}
STEP_BYTES = 4      # the int32 step a checkpoint carries


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_BITS[t.element_size()])


def schedule(rng, lengths, deploys: bool):
    """Endless (length, deploy) batches; deploy is None (the batch waits
    for nothing), "delta" or "delta+embed".

    Batches go in pairs of complementary lengths (shortest with longest,
    and inwards), so every pair carries the same tokens, and with
    ``deploys`` the first batch of each pair waits for a deploy. A block
    holds each pair kind twice, once in each order, kinds alternating, so
    every (length, deploy-or-not) combination comes once a block. The
    block's first deploy also moves embedding rows and always comes before
    its longest prompt; the seed orders the other pairs. So any run of
    whole pairs does the same work whatever the seed, and the slowest
    batches (the longest prompt behind the heaviest deploy) come at a
    fixed rate."""
    ls = sorted(lengths)
    if len(ls) % 2:
        raise ValueError("prompt_lengths must pair up: give an even number")
    kinds = [(ls[-1 - i], ls[i]) for i in range(len(ls) // 2)]
    while True:
        flips = [False] + [bool(rng.integers(2)) for _ in kinds[1:]]
        for turn in (0, 1):
            for k, ((a, b), flip) in enumerate(zip(kinds, flips)):
                first, second = (b, a) if flip ^ bool(turn) else (a, b)
                kind = None
                if deploys:
                    kind = "delta+embed" if turn == 0 and k == 0 else "delta"
                yield first, kind
                yield second, None


class Trainer:
    """The trainer's side of a deploy: its weights (the benchmark's), the
    deltas it applies on the device, and an undo log that takes the
    weights back to any earlier version after the window."""

    def __init__(self, ctx, weights: dict):
        self.ctx = ctx
        self.weights = weights
        self.flat = flatten(weights)
        self.version = 0
        self.undo = []             # per version: [(leaf, index, old)]
        self.changed = []          # per version: [(leaf, per-chunk counts)]

    def apply(self, embed: bool) -> None:
        ctx, up = self.ctx, self.ctx.mix["update"]
        self.version += 1
        rng = ctx.rng(7, self.version)
        layer = int(rng.integers(ctx.cfg.n_layers))
        gen = torch.Generator(device=ctx.device).manual_seed(
            int(rng.integers(2 ** 62)))
        edits = []
        for path in up["leaves"]:
            leaf = self.flat[path]
            w = leaf[layer].reshape(leaf.shape[1], -1)
            a = torch.randn(w.shape[0], up["rank"], device=ctx.device,
                            generator=gen)
            b = torch.randn(up["rank"], w.shape[1], device=ctx.device,
                            generator=gen)
            edits.append((path, layer, a @ b))
        if embed:
            emb = self.flat["embed"]
            r0 = int(rng.integers(ctx.cfg.vocab - up["embed_rows"]))
            rows = slice(r0, r0 + up["embed_rows"])
            edits.append(("embed", rows,
                          torch.randn(emb[rows].shape, device=ctx.device,
                                      generator=gen)))
        log, changed = [], []
        for path, index, delta in edits:
            leaf = self.flat[path]
            view = leaf[index]
            old = view.clone()
            wf = view.float()
            scale = up["relative"] * _rms(wf) / _rms(delta)
            view.copy_((wf + delta.reshape(wf.shape) * scale).to(leaf.dtype))
            log.append((path, index, old))
            first = view.storage_offset() - leaf.storage_offset()
            n_chunks = chunk_count(leaf.numel(), leaf.element_size(),
                                   ctx.config["store"]["chunk_bytes"])
            ids = chunk_of_elements(first, view.numel(), leaf.element_size(),
                                    ctx.config["store"]["chunk_bytes"],
                                    ctx.device)
            moved = (bits(old) != bits(view)).reshape(-1).to(torch.int64)
            changed.append((path, torch.zeros(n_chunks, dtype=torch.int64,
                                              device=ctx.device)
                            .index_add_(0, ids, moved)))
        self.undo.append(log)
        self.changed.append(changed)

    def revert_to(self, version: int) -> None:
        """Undo the deltas after ``version`` (after the window)."""
        while self.version > version:
            for path, index, old in reversed(self.undo[self.version - 1]):
                self.flat[path][index].copy_(old)
            self.version -= 1

    def changed_bytes(self, first_version: int) -> int:
        """Bytes of the chunks that the deltas from ``first_version`` on
        changed, and each save's step."""
        cb = self.ctx.config["store"]["chunk_bytes"]
        total = 0
        for changed in self.changed[first_version - 1:]:
            for path, counts in changed:
                leaf = self.flat[path]
                js = torch.nonzero(counts).flatten().tolist()
                total += chunk_sizes(leaf.numel(), leaf.element_size(), cb, js)
            total += STEP_BYTES
        return total


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.float().pow(2).mean().sqrt()


class Deploy:
    """Trainer's store, the replica's store and follower, and the checks
    made after each deploy."""

    def __init__(self, ctx, trainer: Trainer, root: str):
        from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
        from repro_torch.serve import CheckpointFollower
        st = ctx.config["store"]
        self.ctx, self.trainer = ctx, trainer
        self.aside = os.path.join(root, "aside")
        os.makedirs(self.aside)
        policy = CheckpointPolicy(
            use_fingerprints=st["use_fingerprints"],
            chunk_bytes=st["chunk_bytes"], async_write=st["async_write"],
            durability=st["durability"])
        self.mgr = CheckpointManager(os.path.join(root, "trainer"),
                                     ctx.cfg.name, policy)
        self.mgr.save(0, trainer.weights, {})
        self.known, self.layers_seen = set(), set()
        self._link_new(0)
        self.follower = CheckpointFollower(
            remote=self.mgr.store, local=os.path.join(root, "replica"),
            keep=st["follower_keep"])
        self.mismatch = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.missed = 0
        self.first_version = None

    def first_pull(self):
        upd = self.follower.poll()
        if upd is None or not upd.full:
            raise RuntimeError("the replica's first pull failed")
        return upd.params

    def __call__(self, engine, kind: str) -> None:
        ctx, rec, tr = self.ctx, self.ctx.rec, self.trainer
        with rec.span("update"):
            tr.apply(embed=kind == "delta+embed")
            sync(ctx.device)
        t0 = time.perf_counter()
        with rec.span("save"):
            report = self.mgr.save(tr.version, tr.weights, {})
        with rec.span("follow"):
            upd = self.follower.poll_and_refresh(engine)
            sync(ctx.device)
        deploy_s = time.perf_counter() - t0
        with rec.span("check"):
            if upd is None or upd.step != tr.version:
                self.missed += 1
            served = flatten(engine.params)
            for path, t in tr.flat.items():
                self.mismatch += (bits(served[path]) != bits(t)).sum()
            self._link_new(tr.version)
        rec.add("deploys")
        rec.add("deploy_s", deploy_s)
        ctx.note("save_follow_s", [round(t1 - t0, 4) for _, t0, t1 in
                                   rec.spans[-3:-1]])
        rec.add("bytes_serialized", report.bytes_serialized)
        if self.follower.last_pull is not None and upd is not None:
            rec.add("bytes_sent", self.follower.last_pull.bytes_sent)

    def _link_new(self, step: int) -> None:
        """Link aside the blobs that the save of ``step`` added to the
        image (read from its manifest): gc may remove them later."""
        store = self.mgr.store
        manifest, _ = store.read_image(self.mgr.image, self.mgr.tag_of(step))
        for lid in manifest.layer_ids:
            if lid in self.layers_seen:
                continue
            self.layers_seen.add(lid)
            for rec in store.read_layer(lid).records:
                for h in rec.chunks:
                    if h not in self.known:
                        self.known.add(h)
                        os.link(blob_path(store.root, h),
                                os.path.join(self.aside, h))

    def misaddressed(self) -> int:
        """Blobs linked aside whose SHA-256 is not their address."""
        with ThreadPoolExecutor(8) as pool:
            return sum(pool.map(lambda h: misaddressed(
                h, os.path.join(self.aside, h)), os.listdir(self.aside)))


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(ctx) -> None:
    from repro_torch.serve import Engine
    mix, cfg = ctx.mix, ctx.cfg
    B, new = mix["clients"], mix["new_tokens"]
    lengths = mix["prompt_lengths"]
    max_len = max(lengths) + new
    root = tempfile.mkdtemp(prefix="bench_store_")
    try:
        trainer = Trainer(ctx, ctx.weights())
        deploy = None
        if mix["deploy"]:
            deploy = Deploy(ctx, trainer, root)
            engine = Engine(cfg, deploy.first_pull(), max_len, ctx.device)
        else:
            engine = Engine(cfg, trainer.weights, max_len, ctx.device)
        prompt_rng = ctx.rng(3)

        def prompts(length):
            return prompt_rng.integers(0, cfg.vocab, (B, length),
                                       dtype=np.int32)

        for length in sorted(set(lengths)):          # warm-up, every shape
            engine.generate(prompts(length), new)
        if deploy is not None:                       # one of each kind
            deploy(engine, "delta+embed")
            deploy(engine, "delta")
            deploy.first_version = trainer.version + 1
        ctx.rec.spans.clear()
        ctx.rec.counters.clear()
        ctx.notes.clear()
        sched = schedule(ctx.rng(5), lengths, mix["deploy"])
        served, latency = [], []
        with ctx.open_window() as win:
            t_send = win.t0
            while win.remaining() > 0:
                length, kind = next(sched)
                ctx.attempted += B
                if kind:
                    deploy(engine, kind)
                p = prompts(length)
                with ctx.rec.span("generate"):
                    res = engine.generate(p, new)
                t_done = time.perf_counter()
                latency += [t_done - t_send] * B
                ctx.note("batch_s", [length, round(t_done - t_send, 4)])
                t_send = t_done
                served.append((p, res.tokens, trainer.version))
                ctx.rec.add("tokens", B * (length + new))
                ctx.rec.add("serve_flops",
                            ctx.flops.serve_flops(ctx.config, B, length, new))
        tree_bytes = sum(t.numel() * t.element_size()
                         for t in trainer.flat.values())
        ctx.rec.add("tree_bytes", tree_bytes + STEP_BYTES)
        suffix = mix.get("metric_suffix", "")
        ctx.report("serve_tokens_per_s" + suffix, ctx.rec.counters["tokens"] /
                   win.seconds)
        ctx.report("request_p95_s" + suffix, p95(latency))
        if deploy is not None:
            n = ctx.rec.counters["deploys"]
            ctx.report("deploy_s", ctx.rec.counters["deploy_s"] / n)
            ctx.rec.add("changed_chunk_bytes",
                        trainer.changed_bytes(deploy.first_version))
            ctx.failed += deploy.missed
            ctx.check("served_leaves_differing", int(deploy.mismatch))
            ctx.check("blobs_misaddressed", deploy.misaddressed())
            del deploy.follower, deploy.mgr
        del engine
        _check_tokens(ctx, trainer, served)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _check_tokens(ctx, trainer: Trainer, served) -> None:
    """The reference over a sample of finished requests, at the weights
    each was served with."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = ctx.rng(11)
    rows = [(b, r) for b in range(len(served)) for r in range(len(served[b][1]))]
    longest = max(served[b][0].shape[1] for b, _ in rows)
    first = [i for i, (b, _) in enumerate(rows)
             if served[b][0].shape[1] == longest]
    pick = [first[int(rng.integers(len(first)))]]
    rest = [i for i in range(len(rows)) if i != pick[0]]
    n = min(ctx.mix["check_requests"], len(rows)) - 1
    pick += [rest[i] for i in rng.choice(len(rest), n, replace=False)]
    by_version = {}
    for i in pick:
        b, r = rows[i]
        prompt, tokens, version = served[b]
        by_version.setdefault(version, []).append((prompt[r], tokens[r]))
    modes = {"program": False, **{m: True for m in ctx.modes
                                  if m == "control"}}
    worst = {m: 0.0 for m in modes}
    for version in sorted(by_version, reverse=True):
        trainer.revert_to(version)
        for m, control in modes.items():
            worst[m] = max(worst[m], widest_gap(
                ctx.family, ctx.config, trainer.weights, by_version[version],
                ctx.device, control=control))
    ctx.check("served_logit_gap", worst["program"])
    for m in modes:
        if m != "program":
            ctx.reading(m, "served_logit_gap", worst[m])
