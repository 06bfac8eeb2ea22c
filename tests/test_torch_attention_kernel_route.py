"""Which self-attention calls take the hand-written flash kernel
(``models.attention.uses_kernel``), and what they compute there.

On the CPU no kernel runs: ``flash_ops.flash_attention`` is replaced by a
recorder that calls the real entry point (for CPU tensors, its plain
version ``ref.flash_attention_ref``) and counts its calls in ``launches``
as the kernel does, and the kernel's device type is set to the CPU's, so
the rule can be driven call by call. An eligible call reaches the recorder
with (B, H, S, D) tensors, k and v at their own KV heads, and gives the
plain path's result; each ineligible call (autograd recording, an input
that requires grad, a DTensor, a fake tensor, a CPU tensor, bf16 scores,
an explicit ``impl``, a head pair or dtype the kernel lacks) never
reaches it and gives exactly what the plain version gives.

Marked ``card`` (skipped without a CUDA device): the served prefill
through the kernel against the plain path (``attn_impl="blockwise"``) at a
dense GQA config at head dim 128 and an MLA one at (96, 64), prompt 992,
in bf16 and f32, and ``engine.prefill``'s ``attn_kernel_launches``. This
file imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m card tests/test_torch_attention_kernel_route.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import init_params, prefill  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
B, S = 2, 40
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


class Recorder:
    """Stands in for ``flash_ops.flash_attention``: records each call's
    shapes, counts it in ``launches``, and runs the real entry point."""

    def __init__(self, real):
        self.real = real
        self.calls = []
        self.launches = 0

    def __call__(self, q, k, v, **kw):
        self.calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        self.launches += 1
        return self.real(q, k, v, **kw)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder(flash_ops.flash_attention)
    monkeypatch.setattr(flash_ops, "flash_attention", rec)
    return rec


@pytest.fixture
def on_cpu_kernel(monkeypatch, recorder):
    """The rule treats CPU tensors as the kernel's device's."""
    monkeypatch.setattr(ta, "_KERNEL_DEVICE", "cpu")
    return recorder


def _qkv(dtype=torch.bfloat16, hq=4, kvh=2, d=128, dv=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, hq, d), generator=g).to(dtype)
    k = torch.randn((B, S, kvh, d), generator=g).to(dtype)
    v = torch.randn((B, S, kvh, dv), generator=g).to(dtype)
    return q, k, v


def _plain(q, k, v, window=None, **kw):
    return ta.attention(q, k, v, window=window,
                        impl=ta.plain_impl(window, q.shape[1]), **kw)


ELIGIBLE = {
    # name: (grad mode, inputs require grad, dtype, (D, Dv), heads, window)
    "no_grad": ("no_grad", True, torch.bfloat16, (128, 128), (4, 2), None),
    "inference_mode": ("inference", False, torch.bfloat16, (128, 128),
                       (4, 1), None),
    "grad_on_nothing_requires": ("grad", False, torch.float32, (64, 64),
                                 (4, 4), None),
    "mla_pair": ("inference", False, torch.bfloat16, (96, 64), (4, 4),
                 None),
    "window_shorter_than_s": ("inference", False, torch.float32, (32, 32),
                              (4, 2), 9),
    "window_longer_than_s": ("inference", False, torch.bfloat16,
                             (256, 256), (2, 1), 64),
}


def _grad_mode(mode):
    return {"no_grad": torch.no_grad, "inference": torch.inference_mode,
            "grad": torch.enable_grad}[mode]()


@pytest.mark.parametrize("case", sorted(ELIGIBLE))
def test_eligible_call_takes_the_kernel(case, on_cpu_kernel):
    mode, needs_grad, dtype, (d, dv), (hq, kvh), window = ELIGIBLE[case]
    q, k, v = _qkv(dtype, hq, kvh, d, dv)
    for t in (q, k, v):
        t.requires_grad_(needs_grad)
    with _grad_mode(mode):
        assert ta.uses_kernel(q, k, v)
        got = ta.attention(q, k, v, window=window)
        want = _plain(q, k, v, window=window)
    assert on_cpu_kernel.calls == [((B, hq, S, d), (B, kvh, S, d),
                                    (B, kvh, S, dv))]
    assert got.shape == (B, S, hq, dv) and got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


INELIGIBLE = {
    # name: (call keywords, tensor keywords, what requires grad)
    "autograd": ({}, {}, "qkv"),
    "v_requires_grad": ({}, {}, "v"),
    "bf16_scores": ({"score_dtype": "bfloat16"}, {}, ""),
    "impl_blockwise": ({"impl": "blockwise"}, {}, ""),
    "impl_banded": ({"impl": "banded", "window": 9}, {}, ""),
    "head_pair_16": ({}, {"d": 16, "dv": 16}, ""),
    "head_pair_128_64": ({}, {"d": 128, "dv": 64}, ""),
    "float16": ({}, {"dtype": torch.float16}, ""),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligible_call_keeps_the_plain_path(case, on_cpu_kernel):
    kw, tkw, grads = INELIGIBLE[case]
    q, k, v = _qkv(**tkw)
    for name, t in zip("qkv", (q, k, v)):
        t.requires_grad_(name in grads)
    impl = kw.pop("impl", "auto")
    kw = {"window": None, **kw}
    assert not ta.uses_kernel(q, k, v, impl=impl,
                              score_dtype=kw.get("score_dtype",
                                                 torch.float32))
    got = ta.attention(q, k, v, impl=impl, **kw)
    want = _plain(q, k, v, **kw)
    assert on_cpu_kernel.calls == []
    assert torch.equal(got, want)
    if grads:
        got.float().sum().backward()
        assert v.grad is not None


TAKES = {
    # name: (dtype, (D, Dv), k's D)
    "bf16_128": (torch.bfloat16, (128, 128), 128),
    "f32_mla": (torch.float32, (96, 64), 96),
    "bf16_16": (torch.bfloat16, (16, 16), 16),
    "f32_128_64": (torch.float32, (128, 64), 128),
    "k_dim_differs": (torch.bfloat16, (64, 64), 32),
    "float16": (torch.float16, (64, 64), 64),
}


@pytest.mark.parametrize("case", sorted(TAKES))
def test_takes_is_what_check_kernel_inputs_accepts(case):
    dtype, (d, dv), dk = TAKES[case]
    q, k, v = (torch.zeros((1, 2, 8, n), dtype=dtype) for n in (d, dk, dv))
    try:
        flash_ops.check_kernel_inputs(q, k, v)
        accepted = True
    except ValueError:
        accepted = False
    assert flash_ops.takes(q, k, v) == accepted
    assert accepted == (case in ("bf16_128", "f32_mla"))


def test_cpu_tensors_keep_the_plain_path(recorder):
    q, k, v = _qkv()
    with torch.inference_mode():
        assert not ta.uses_kernel(q, k, v)
        got = ta.attention(q, k, v)
        want = _plain(q, k, v)
    assert recorder.calls == []
    assert torch.equal(got, want)


def test_fake_tensors_keep_the_plain_path(on_cpu_kernel):
    """A trace's fake tensors (the roofline counter's, the dry-run's) hold
    no data for the kernel: the plain path, with the plain result's
    shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    q, k, v = (mode.from_tensor(t) for t in _qkv())
    with mode, torch.inference_mode():
        assert not ta.uses_kernel(q, k, v)
        got = ta.attention(q, k, v)
    assert on_cpu_kernel.calls == []
    assert tuple(got.shape) == (B, S, 4, 128)


_DTENSOR = """
import torch
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as ta

calls = []
flash_ops.flash_attention = lambda *a, **k: calls.append(a)
ta._KERNEL_DEVICE = "cpu"
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn((2, 40, h, 128), generator=g).to(torch.bfloat16)
           for h in (4, 2, 2))
qd, kd, vd = (distribute_tensor(t, mesh, [Replicate(), Replicate()])
              for t in (q, k, v))
with torch.no_grad():
    assert ta.uses_kernel(q, k, v) and not ta.uses_kernel(qd, kd, vd)
    got = ta.attention(qd, kd, vd).full_tensor()
    want = ta.attention(q, k, v, impl="blockwise")
assert calls == [], calls
assert torch.equal(got, want)
print("OK")
"""


def test_dtensor_keeps_the_plain_path():
    """On a one-rank mesh, in a process of its own (the mesh initialises
    a process group)."""
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", _DTENSOR], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


# ------------------------------------------------------- the model's path
def _dense(dtype, **kw):
    """yi-6b's attention (GQA, head dim 128) at a small width."""
    return get_config("yi-6b").replace(
        n_layers=2, d_model=256, vocab=512, n_heads=8, n_kv_heads=2,
        head_dim=128, d_ff=512, param_dtype=dtype, compute_dtype=dtype,
        **kw)


def _mla(dtype, **kw):
    """minicpm3-4b's MLA at its (96, 64) head dims, at a small width."""
    return get_config("minicpm3-4b").replace(
        n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=4,
        q_lora_rank=64, kv_lora_rank=32, param_dtype=dtype,
        compute_dtype=dtype, **kw)


MODELS = {"dense_gqa_128": _dense, "mla_96_64": _mla}


def _tokens(cfg, batch, length, device):
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, length), generator=g) \
        .to(device)


def _prefill_both(cfg, device, length):
    """-> ((caches, logits) through ``cfg``, the same through the plain path,
    the kernel's launches in the first prefill, the weights, the tokens).
    The plain path is ``attn_impl="blockwise"``, which repeats k and v to
    q's heads."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    toks = _tokens(cfg, 2, length, device)
    with torch.inference_mode():
        n0 = flash_ops.flash_attention.launches
        fast = prefill(cfg, params, toks)
        launched = flash_ops.flash_attention.launches - n0
        plain = prefill(cfg.replace(attn_impl="blockwise"), params, toks)
    return fast, plain, launched, params, toks


@pytest.mark.parametrize("model", sorted(MODELS))
def test_prefill_through_the_rule_matches_the_plain_path(model,
                                                         on_cpu_kernel):
    cfg = MODELS[model]("float32")
    (cache, logits), (cache_p, logits_p), launched, _, _ = _prefill_both(
        cfg, "cpu", S)
    assert launched == cfg.n_layers
    kvh = cfg.n_kv_heads
    for _, k, _ in on_cpu_kernel.calls:
        assert k[1] == kvh                   # k at its own KV heads
    assert float((logits - logits_p).abs().max()) <= 1e-4
    for name in cache:
        assert float((cache[name] - cache_p[name]).abs().max()) <= 1e-4


def _engine_prefill_launches(cfg, device):
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, S),
                                                dtype=np.int32)
    engine = Engine(cfg, params, max_len=S + 2, device=device)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            engine.generate(prompts, 2)
            engine.generate(prompts, 2)
        return [s.attrs["attn_kernel_launches"] for s in tracing.spans()
                if s.name == "engine.prefill"]
    finally:
        tracing.clear()


@pytest.mark.parametrize("kernel", [True, False])
def test_prefill_span_counts_the_kernel_launches(kernel, recorder,
                                                 monkeypatch):
    if kernel:
        monkeypatch.setattr(ta, "_KERNEL_DEVICE", "cpu")
    cfg = _dense("float32")
    assert _engine_prefill_launches(cfg, "cpu") == \
        [cfg.n_layers if kernel else 0] * 2


# ---------------------------------------------------------- on the card
PROMPT = 992            # 2^5 x 31: not a multiple of 512


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present, decided when the
    test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_card_prefill_through_the_kernel_matches_the_plain_path(
        card, model, dtype):
    """Logits and caches through the kernel against the plain path's. In
    bf16 each is measured against the plain path in f32 (TF32 off) from
    the same weights, and the kernel's gap may be at most twice the plain
    path's; in f32 (the 3xTF32 kernel) the two lie within 1e-4."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = MODELS[model](dtype)
        (cache, logits), (cache_p, logits_p), launched, params, toks = \
            _prefill_both(cfg, "cuda", PROMPT)
        assert launched == cfg.n_layers
        f32 = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          attn_impl="blockwise")
        with torch.inference_mode():
            cache_r, logits_r = prefill(f32, _as_f32(params), toks)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    pairs = [("logits", logits, logits_p, logits_r)] + [
        (name, cache[name], cache_p[name], cache_r[name]) for name in cache]
    for name, fast, plain, ref in pairs:
        if dtype == "float32":
            assert _max_err(fast, plain) <= 1e-4, name
        else:
            assert _max_err(fast, ref) <= 2 * _max_err(plain, ref), name


def _as_f32(tree):
    return {k: _as_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.mark.card
@pytest.mark.parametrize("model", sorted(MODELS))
def test_card_prefill_span_counts_the_kernel_launches(card, model):
    cfg = MODELS[model]("bfloat16")
    assert _engine_prefill_launches(cfg, "cuda") == [cfg.n_layers] * 2
