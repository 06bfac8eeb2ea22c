"""``correct`` comes out true on sound runs and false under each fault a
cell can have, planted in the port underneath a whole run at tiny sizes on
the CPU; and the float8 control reads above a limit on at least one
number (the tiny sizes' limits, ``bench/tests/tiny/<cell>.json``). The
cells are the declared ones, found by their traffic: its driver (``serve``
or ``train``) and whether it deploys."""
import numpy as np
import pytest

from bench import spec
from bench.tests.tiny import overrides, tiny_run

DECL = spec.declaration()
CELLS = [w["name"] for w in DECL["workloads"]]
MIXES = {w["name"]: spec.traffic(w["traffic"]) for w in DECL["workloads"]}
SERVING = [c for c, mix in MIXES.items() if mix["driver"] == "serve"]
DEPLOYING = [c for c in SERVING if MIXES[c]["deploy"]]
TRAINING = [c for c, mix in MIXES.items() if mix["driver"] == "train"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, _ = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _served(monkeypatch, alter):
    from repro_torch.serve import engine
    generate = engine.Engine.generate

    def broken(self, prompts, steps, *a, **k):
        return alter(self, generate, prompts, steps, *a, **k)
    monkeypatch.setattr(engine.Engine, "generate", broken)


def _token_altered(self, generate, prompts, steps, *a, **k):
    res = generate(self, prompts, steps, *a, **k)
    res.tokens[:, 1] = (res.tokens[:, 1] + 1) % self.cfg.vocab
    return res


def _half_batch(self, generate, prompts, steps, *a, **k):
    half = prompts.shape[0] // 2
    res = generate(self, prompts[:half], steps, *a, **k)
    res.tokens = np.concatenate([res.tokens, res.tokens])
    return res


def _cache_unchanged(monkeypatch):
    from repro_torch.serve import engine
    step = engine.decode_step

    def broken(cfg, params, cache, tokens, pos):
        _, logits = step(cfg, params, {k: v.clone() for k, v in cache.items()},
                         tokens, pos)
        return cache, logits
    monkeypatch.setattr(engine, "decode_step", broken)


@pytest.mark.parametrize("cell", SERVING)
@pytest.mark.parametrize("fault", ["token_altered", "half_batch",
                                   "cache_unchanged"])
def test_serving_fault_is_not_correct(monkeypatch, cell, fault):
    if fault == "cache_unchanged":
        _cache_unchanged(monkeypatch)
    else:
        _served(monkeypatch, {"token_altered": _token_altered,
                              "half_batch": _half_batch}[fault])
    out, _ = tiny_run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", DEPLOYING)
def test_deploy_with_refresh_left_out_is_not_correct(monkeypatch, cell):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine.Engine, "refresh",
                        lambda self, params, changed=None, step=None: 0)
    out, _ = tiny_run(cell)
    assert out["checks"]["served_leaves_differing"]["value"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("cell", TRAINING)
def test_train_with_the_update_left_out_is_not_correct(monkeypatch, cell):
    from repro_torch.train import step
    monkeypatch.setattr(step, "apply_update",
                        lambda cfg, params, opt, grads: (params, opt, {}))
    out, _ = tiny_run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAINING)
def test_train_on_half_the_batch_is_not_correct(monkeypatch, cell):
    from repro_torch.train import step
    vg = step.value_and_grad

    def half(cfg, params, batch):
        n = batch["tokens"].shape[0] // 2
        return vg(cfg, params, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(step, "value_and_grad", half)
    out, _ = tiny_run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_reads_above_a_limit(cell):
    modes = ("control", "half_batch") if cell in TRAINING else ("control",)
    _, ctx = tiny_run(cell, readings=modes)
    limits = {**spec.limits(cell), **overrides(cell)["limits"]}
    for mode in modes:
        over = [k for k, v in ctx.readings[mode].items() if v > limits[k]]
        assert over, (mode, ctx.readings[mode], limits)
