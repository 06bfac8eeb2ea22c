"""The port's two walkthroughs against their JAX originals on the CPU, each
started from the JAX example's weights carried across (``params_from_jax``)
and called in process:

* ``examples/elastic_restart_torch.py``: the 10 losses of the uninterrupted
  run within the bf16 loss tolerance of tests/test_torch_train.py (0.05
  abs) of the JAX example's, the crashed-and-restored run's losses equal
  to the uninterrupted run's, and its params bitwise identical;
* ``examples/finetune_lora_ckpt_torch.py``: ``bytes_serialized`` of every
  save, full and incremental, equal to the JAX example's save for save
  (exact: the changed chunk ranges are those of the 8 soft rows), and the
  example's own ``incremental < full / 10``.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.models import init_params  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_BF16_TOL = 0.05


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def test_elastic_restart_matches_the_jax_example(tmp_path, capsys):
    jex, tex = _example("elastic_restart"), _example("elastic_restart_torch")
    tcfg, tacfg = tex.config()
    cfg = jex.get_smoke_config("musicgen-medium").replace(n_layers=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    acfg = jex.AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=100,
                           weight_decay=0.0)
    assert dataclasses.asdict(acfg) == dataclasses.asdict(tacfg)
    _, _, want = jex.run(cfg, acfg, 10)
    weights = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    la, lb, same = tex.crash_and_restore(
        tcfg, tacfg, lambda: params_from_jax(weights, "cpu"), "cpu",
        str(tmp_path / "ckpt"))
    assert same and lb == la
    assert len(la) == len(want) == 10
    assert max(abs(a - b) for a, b in zip(la, want)) <= LOSS_BF16_TOL, \
        (la, want)
    assert "restored at step 5" in capsys.readouterr().out


def test_finetune_saves_the_jax_examples_bytes(monkeypatch, capsys,
                                              tmp_path):
    jex, tex = _example("finetune_lora_ckpt"), _example(
        "finetune_lora_ckpt_torch")
    saved = {}
    mkdtemp = jex.tempfile.mkdtemp      # the JAX example leaves its stores
    monkeypatch.setattr(jex.tempfile, "mkdtemp", lambda prefix: mkdtemp(
        prefix=prefix, dir=str(tmp_path)))

    class Recording(jex.CheckpointManager):
        def save(self, step, params, opt_state):
            rep = super().save(step, params, opt_state)
            mode = "incremental" if self.policy.incremental else "full"
            if step > 0:
                saved.setdefault(mode, []).append(rep.bytes_serialized)
            return rep

    monkeypatch.setattr(jex, "CheckpointManager", Recording)
    jex.main()
    cfg = jex.get_smoke_config("gemma-2b").replace(n_layers=4, d_model=128,
                                                   d_ff=256, vocab=4096)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tex.config())
    weights = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    got = tex.finetune(_torch_cfg(cfg), params_from_jax(weights, "cpu"),
                       "cpu")
    got = {m: [r.bytes_serialized for r in reps] for m, reps in got.items()}
    assert got == saved
    assert len(got["full"]) == len(got["incremental"]) == tex.STEPS
    assert np.mean(got["incremental"]) < np.mean(got["full"]) / 10
    capsys.readouterr()


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("elastic_restart_torch", "finetune_lora_ckpt_torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main([])

