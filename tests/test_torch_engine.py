"""Engine parity: the port's greedy ``Engine`` against the JAX package's,
token for token, on the same f32 weights; sampled decoding; sparse
refresh against a full reload; rollback.

JAX's PRNG cannot be reproduced in torch, so sampled tokens cannot match
the reference's token for token. Sampling is held three ways instead:
(a) one seed gives the same tokens twice and another seed other tokens;
(b) ``temperature=1e-4`` gives the greedy tokens where the top two logits
are apart; (c) a chi-square test of 20,000 first-step draws of the port's
``sample_logits`` against ``softmax(logits / T)`` of the JAX reference's
logits, bins expecting fewer than 5 draws pooled, at a fixed seed and
p > 1e-3, so the test is deterministic."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.engine import sample_logits  # noqa: E402

CASES = {
    # name: (config overrides, prompt length, steps, max_len)
    "dense": (dict(), 12, 10, 30),
    # prefill ring (12 slots) spliced into a 16-slot ring that then wraps
    "sliding_window": (dict(window=16, q_block=4, kv_block=4), 12, 10, 30),
    # a window shorter than the prompt: banded prefill
    "banded": (dict(window=8, q_block=4, kv_block=4), 12, 6, 18),
}


def _setup(case, seed=0):
    over, S, steps, max_len = CASES[case]
    cfg = get_smoke_config("yi-6b").replace(
        param_dtype="float32", compute_dtype="float32", **over)
    jp = init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (3, S)).astype(np.int32)
    return cfg, tcfg, jp, tp, prompts, steps, max_len


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax_engine(case):
    cfg, tcfg, jp, tp, prompts, steps, max_len = _setup(case)
    want = JaxEngine(cfg, jp, max_len=max_len).generate(prompts, steps)
    got = Engine(tcfg, tp, max_len=max_len, device="cpu").generate(
        prompts, steps)
    assert got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert np.abs(got.logits_last - np.asarray(want.logits_last)).max() < 1e-4


def test_stop_token_ends_generation():
    cfg, tcfg, jp, tp, prompts, steps, max_len = _setup("dense")
    first = Engine(tcfg, tp, max_len=max_len, device="cpu").generate(
        prompts[:1], steps).tokens
    stop = int(first[0, 2])
    want = JaxEngine(cfg, jp, max_len=max_len).generate(
        prompts[:1], steps, stop_token=stop).tokens
    got = Engine(tcfg, tp, max_len=max_len, device="cpu").generate(
        prompts[:1], steps, stop_token=stop).tokens
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 3


def test_generate_binds_the_references_arguments_by_position():
    """generate(prompts, steps, temperature, seed, stop_token): the
    reference's order, so a call written for it binds the same way."""
    cfg, tcfg, jp, tp, prompts, steps, max_len = _setup("dense")
    eng = Engine(tcfg, tp, max_len=max_len, device="cpu")
    stop = int(eng.generate(prompts[:1], steps).tokens[0, 3])
    want = JaxEngine(cfg, jp, max_len=max_len).generate(
        prompts[:1], steps, 0.0, 7, stop).tokens
    got = eng.generate(prompts[:1], steps, 0.0, 7, stop).tokens
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 4
    # a temperature in third place is a temperature, not a stop token
    np.testing.assert_array_equal(
        eng.generate(prompts, steps, 0.0).tokens,
        JaxEngine(cfg, jp, max_len=max_len).generate(prompts, steps,
                                                     0.0).tokens)
    # a sampled run is a function of its seed
    a = eng.generate(prompts, steps, 0.7, 1).tokens
    np.testing.assert_array_equal(a, eng.generate(prompts, steps, 0.7,
                                                  1).tokens)
    assert not np.array_equal(a, eng.generate(prompts, steps, 0.7, 2).tokens)


def _margins(tcfg, tp, prompts, steps, max_len):
    """The smallest gap between the top two logits at each greedy step."""
    from repro_torch.models import decode_step, init_cache, prefill
    eng = Engine(tcfg, tp, max_len=max_len, device="cpu")
    B, S = prompts.shape
    with torch.no_grad():
        pf, logits = prefill(tcfg, tp, torch.as_tensor(prompts).long())
        cache = eng._splice(init_cache(tcfg, B, max_len, "cpu"), pf, S)
        gaps = []
        for i in range(steps):
            top = torch.topk(logits[:, :tcfg.vocab], 2).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            tok = torch.argmax(logits[:, :tcfg.vocab], dim=-1)
            cache, logits = decode_step(tcfg, tp, cache, tok, S + i)
    return min(gaps)


def test_near_zero_temperature_gives_the_greedy_tokens():
    """At T = 1e-4 every step's top two logits are more than 30 T apart;
    the difference of two Gumbel draws passes 30 with probability below
    1e-13, so each draw is the argmax."""
    cfg, tcfg, jp, tp, prompts, steps, max_len = _setup("dense")
    assert _margins(tcfg, tp, prompts, steps, max_len) > 30 * 1e-4
    eng = Engine(tcfg, tp, max_len=max_len, device="cpu")
    greedy = JaxEngine(cfg, jp, max_len=max_len).generate(prompts, steps)
    for seed in (0, 1, 2):
        np.testing.assert_array_equal(
            eng.generate(prompts, steps, 1e-4, seed).tokens, greedy.tokens)


@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_first_step_draws_follow_the_references_softmax(temperature):
    from scipy import stats
    cfg, tcfg, jp, tp, prompts, _, _ = _setup("dense")
    _, jlogits = jax_prefill(cfg, jp, jax.numpy.asarray(prompts[:1]))
    logits = np.asarray(jlogits, np.float64)[0, :cfg.vocab]
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    draws = sample_logits(torch.from_numpy(logits).float().expand(n, -1),
                          temperature, gen).numpy()
    z = logits / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    expected = n * p
    observed = np.bincount(draws, minlength=cfg.vocab).astype(np.float64)
    rare = expected < 5
    exp_bins = np.append(expected[~rare], expected[rare].sum())
    obs_bins = np.append(observed[~rare], observed[rare].sum())
    if not rare.any():
        exp_bins, obs_bins = exp_bins[:-1], obs_bins[:-1]
    chi2 = float(((obs_bins - exp_bins) ** 2 / exp_bins).sum())
    pvalue = stats.chi2.sf(chi2, len(exp_bins) - 1)
    assert pvalue > 1e-3, (chi2, len(exp_bins), pvalue)


def test_sampling_draws_only_unpadded_vocab_ids():
    _, tcfg, _, tp, prompts, steps, max_len = _setup("dense")
    toks = Engine(tcfg, tp, max_len=max_len, device="cpu").generate(
        prompts, steps, temperature=5.0, seed=3).tokens
    assert toks.min() >= 0 and toks.max() < tcfg.vocab


def test_serve_launcher_passes_the_temperature(capsys):
    from repro_torch.launch import serve
    args = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--prompt-len", "8"]
    runs = {}
    for t in ("0", "0.7"):
        serve.main(args + ["--temperature", t])
        runs[t] = capsys.readouterr().out.splitlines()[-1]
    tcfg = ModelConfig(**dataclasses.asdict(get_smoke_config("yi-6b")))
    p, _ = serve.load_params(tcfg, None, "cpu")
    prompts = serve.make_prompts(tcfg, 2, 8)
    for t, line in runs.items():
        _, res, _ = serve.serve(tcfg, p, prompts, 6, "cpu", float(t))
        assert line == f"[serve] first sequences: {res.tokens[:2, :8].tolist()}"
    assert runs["0"] != runs["0.7"]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _updated(tp):
    new = {k: v for k, v in tp.items()}
    new["blocks"] = dict(tp["blocks"])
    new["blocks"]["w_up"] = tp["blocks"]["w_up"] * 1.25
    new["lm_head"] = tp["lm_head"] + 0.01
    return new, {"blocks/w_up", "lm_head"}


def test_sparse_refresh_bit_identical_to_full_reload():
    _, tcfg, _, tp, prompts, steps, max_len = _setup("dense")
    new, changed = _updated(tp)
    full = Engine(tcfg, tp, max_len=max_len, device="cpu")
    assert full.refresh(new) == 12           # every leaf of the dense tree
    sparse = Engine(tcfg, tp, max_len=max_len, device="cpu")
    part = {"blocks": {"w_up": new["blocks"]["w_up"]},
            "lm_head": new["lm_head"]}
    assert sparse.refresh(part, changed=changed, step=7) == len(changed)
    a, b = dict(_leaves(full.params)), dict(_leaves(sparse.params))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # unchanged leaves are shared, not copied
    assert sparse.params["embed"] is tp["embed"]
    np.testing.assert_array_equal(
        full.generate(prompts, steps).tokens,
        sparse.generate(prompts, steps).tokens)
    h = sparse.health()
    assert (h.refreshes, h.last_refresh_leaves, h.last_refresh_step) == \
        (1, 2, 7)


def test_rollback_restores_the_prior_tree():
    _, tcfg, _, tp, prompts, steps, max_len = _setup("dense")
    eng = Engine(tcfg, tp, max_len=max_len, device="cpu")
    before = eng.params
    tokens_before = eng.generate(prompts, steps).tokens
    new, changed = _updated(tp)
    eng.refresh({"blocks": {"w_up": new["blocks"]["w_up"]},
                 "lm_head": new["lm_head"]}, changed=changed, step=3)
    assert eng.params is not before
    assert eng.rollback()
    assert eng.params is before
    assert before["blocks"]["w_up"] is tp["blocks"]["w_up"]
    np.testing.assert_array_equal(eng.generate(prompts, steps).tokens,
                                  tokens_before)
    assert not eng.rollback()
    assert eng.health().rollbacks == 1


@pytest.mark.parametrize("path", ["blocks/nope", "embed/x", "nope/w"])
def test_stale_sparse_plan_raises(path):
    _, tcfg, _, tp, *_ = _setup("dense")
    eng = Engine(tcfg, tp, max_len=30, device="cpu")
    leaf = {"x": torch.zeros(1)}
    tree = {"blocks": {"nope": leaf["x"]}, "embed": {"x": leaf["x"]},
            "nope": {"w": leaf["x"]}}
    with pytest.raises(KeyError):
        eng.refresh(tree, changed={path})


def test_prompt_longer_than_cache_is_refused():
    _, tcfg, _, tp, prompts, *_ = _setup("dense")
    eng = Engine(tcfg, tp, max_len=14, device="cpu")
    with pytest.raises(ValueError):
        eng.generate(prompts, 8)
