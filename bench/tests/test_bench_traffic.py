"""The traffic is a function of the seed: the same seed gives the same
batches, prompts, deltas and training rows; every seed does the same
work, in its own order."""
import itertools

import numpy as np
import torch

from bench import spec
from bench.drivers import serve, train
from bench.harness import Context
from bench.reference.common import flatten
from bench.tests.tiny import TINY

LENGTHS = spec.traffic("long_docs_deploy")["prompt_lengths"]


def _first(seed, n, deploys=True):
    return list(itertools.islice(
        serve.schedule(np.random.default_rng([seed, 5]), LENGTHS, deploys), n))


def test_schedule_is_a_function_of_the_seed():
    assert _first(2 ** 31 + 11, 40) == _first(2 ** 31 + 11, 40)
    assert _first(2 ** 31 + 11, 40) != _first(2 ** 31 + 12, 40)


def test_every_block_holds_each_combination_once_and_pairs_carry_equal_tokens():
    for seed in (1, 2, 3000000001):
        batches = _first(seed, 64)
        for b in range(0, 64, 8):
            block = batches[b:b + 8]
            assert sorted((n, bool(k)) for n, k in block) == sorted(
                [(n, True) for n in LENGTHS] + [(n, False) for n in LENGTHS])
            assert block[0] == (max(LENGTHS), "delta+embed")
            assert [k for _, k in block].count("delta+embed") == 1
        pair_tokens = {batches[i][0] + batches[i + 1][0]
                       for i in range(0, 64, 2)}
        assert pair_tokens == {min(LENGTHS) + max(LENGTHS)}
        assert all(batches[i][1] and batches[i + 1][1] is None
                   for i in range(0, 64, 2))


def test_without_deploys_no_batch_waits():
    assert not any(d for _, d in _first(7, 16, deploys=False))


def _ctx(cell, seed):
    decl = spec.declaration()
    w = spec.cell(decl, cell)
    conf = {**spec.config(decl, w["config"]), **TINY[cell]["config"]}
    mix = {**spec.traffic(w["traffic"]), **TINY[cell]["traffic"]}
    return Context(conf, mix, spec.limits(cell), seed, 1.0, "cpu", False)


def test_weights_and_prompts_repeat_under_a_seed():
    a, b = _ctx("yi-6b.serve", 2 ** 33 + 5), _ctx("yi-6b.serve", 2 ** 33 + 5)
    for (k, x), (_, y) in zip(flatten(a.weights()).items(),
                              flatten(b.weights()).items()):
        assert torch.equal(x, y), k
    assert np.array_equal(a.rng(3).integers(0, 9, 50),
                          b.rng(3).integers(0, 9, 50))


def test_train_rows_repeat_and_differ_between_steps():
    a, b = _ctx("yi-6b.train", 99), _ctx("yi-6b.train", 99)
    assert np.array_equal(train.batch_at(a, 4)["tokens"],
                          train.batch_at(b, 4)["tokens"])
    assert not np.array_equal(train.batch_at(a, 4)["tokens"],
                              train.batch_at(a, 5)["tokens"])


def test_deltas_repeat_count_changed_chunks_and_revert():
    ctx = _ctx("minicpm3-4b.deploy", 3000000007)
    cb = ctx.config["store"]["chunk_bytes"]
    t1, t2 = (serve.Trainer(ctx, ctx.weights()) for _ in range(2))
    before = {k: v.clone() for k, v in t1.flat.items()}
    for i in range(4):                       # the 4th also moves embed rows
        t1.apply(embed=i == 3)
        t2.apply(embed=i == 3)
    for k in t1.flat:
        assert torch.equal(t1.flat[k], t2.flat[k]), k
    assert not torch.equal(t1.flat["embed"], before["embed"])
    # the chunks whose bytes differ, counted the plain way
    t3 = serve.Trainer(ctx, ctx.weights())
    t3.apply(embed=True)
    want = 0
    for k, new in t3.flat.items():
        old, new = before[k].reshape(-1).view(torch.uint8), \
            new.reshape(-1).view(torch.uint8)
        for j in range(0, old.numel(), cb):
            if not torch.equal(old[j:j + cb], new[j:j + cb]):
                want += min(cb, old.numel() - j)
    assert t3.changed_bytes(1) == want + serve.STEP_BYTES
    t1.revert_to(0)
    for k in t1.flat:
        assert torch.equal(t1.flat[k], before[k]), k
