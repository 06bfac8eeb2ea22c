"""The plain references agree with the port at tiny sizes on the CPU, all
in float32: prefill, decode through the cache, and three train steps."""
import numpy as np
import pytest
import torch

from bench import spec
from bench.harness import port_config
from bench.reference import train as ref_train
from bench.reference.common import flatten
from bench.reference.serve import widest_gap
from bench.tests.tiny import TINY_DENSE, TINY_MLA

DECL = spec.declaration()
CASES = [("yi-6b", TINY_DENSE), ("minicpm3-4b", TINY_MLA)]


def _tiny(name, tiny):
    conf = dict(spec.config(DECL, name), **tiny, dtype="float32")
    ref, _ = spec.family(conf)
    w = ref.init_weights(conf, torch.Generator().manual_seed(3), "cpu",
                         torch.float32)
    return conf, ref, w


@pytest.mark.parametrize("name,tiny", CASES, ids=[c[0] for c in CASES])
def test_prefill_and_decode_match_the_reference(name, tiny):
    from repro_torch.models import prefill
    from repro_torch.serve import Engine
    conf, ref, w = _tiny(name, tiny)
    cfg = port_config(conf)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 21)))
    with torch.no_grad():
        _, last = prefill(cfg, w, toks)
    want = ref.logits(conf, w, ref.hidden(conf, w, toks)[:, -1])
    torch.testing.assert_close(last, want, rtol=1e-4, atol=1e-4)
    # decode through the cache: the served tokens' gaps are 0 in f32
    eng = Engine(cfg, w, max_len=32, device="cpu")
    res = eng.generate(toks.numpy().astype(np.int32), 6)
    reqs = [(toks[i].numpy(), res.tokens[i]) for i in range(2)]
    assert widest_gap(ref, conf, w, reqs, "cpu") < 1e-4
    seq = torch.cat([toks, torch.as_tensor(res.tokens[:, :-1])], 1)
    full = ref.logits(conf, w, ref.hidden(conf, w, seq.long())[:, -1])
    with torch.no_grad():
        _, again = prefill(cfg, w, seq.long())
    torch.testing.assert_close(again, full, rtol=1e-4, atol=1e-4)


def test_the_fp8_control_departs_from_the_reference():
    conf, ref, w = _tiny(*CASES[0])
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 199, (1, 40)))
    h = ref.hidden(conf, w, toks)
    h8 = ref.hidden(conf, w, toks, "fp8")
    rel = float((h8 - h).norm() / h.norm())
    assert 1e-3 < rel < 0.3


@pytest.mark.parametrize("name,tiny", CASES, ids=[c[0] for c in CASES])
def test_three_train_steps_match_the_reference(name, tiny):
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    conf, ref, w = _tiny(name, tiny)
    cfg = port_config(conf)
    adamw = dict(spec.traffic("pretrain")["adamw"], warmup_steps=2)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab, (4, 17), dtype=np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:].copy(),
                        "mask": np.ones((4, 16), np.float32)})
    params = {k: {kk: vv.clone() for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone() for k, v in w.items()}
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(adamw=AdamWConfig(**adamw),
                                            microbatches=2), 4, 16,
                           device="cpu")
    losses, grads = [], None
    for i, b in enumerate(batches):
        params, opt, met = step.fn(params, opt, b)
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {k: float(m.norm() / (1 - adamw["b1"]))
                     for k, m in flatten(opt["m"]).items()}
    init = flatten(w)
    change = {k: float((m - init[k]).norm())
              for k, m in flatten(opt["master"]).items()}
    got = ref_train.follow(ref, conf, w, batches, adamw, 2, "cpu")
    np.testing.assert_allclose(losses, got["loss"], rtol=1e-5)
    moved = ref_train.moved_leaves(got["grad_norm"])
    assert len(moved) == len(grads)
    assert ref_train.worst_leaf_gap(grads, got["grad_norm"], moved) < 1e-4
    assert ref_train.worst_leaf_gap(change, got["change_norm"], moved) < 1e-3


def test_a_blob_is_judged_by_its_address(tmp_path):
    import hashlib
    from bench.reference.store import blob_path, misaddressed
    data = b"chunk bytes"
    h = hashlib.sha256(data).hexdigest()
    path = blob_path(str(tmp_path), h)
    assert path.endswith(f"blobs/sha256/{h[:2]}/{h}")
    good, bad = tmp_path / "good", tmp_path / "bad"
    good.write_bytes(data)
    bad.write_bytes(data + b"!")
    assert not misaddressed(h, str(good)) and misaddressed(h, str(bad))
