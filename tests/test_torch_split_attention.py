"""The meshed paths' split attention, held on one device against the unsplit
functions (the port's and the JAX package's), and the meshed steps'
collectives counted on a fake 2x2 world.

* Split-cache decode: a cache cut along its length into blocks (even,
  uneven, 16 of them), each block's ``decode_partials`` taken at its
  global slot positions and the blocks merged by ``combine_partials``
  (flash-decoding's combine), against ``attention_decode`` on the whole
  cache: a ring of 18 slots over 2 blocks at positions 0-2 (the second
  block holds no valid slot yet), a ring that has wrapped, a window, GQA.
  f32 within 2e-6 abs of the port's unsplit path and 1e-5 of JAX's; bf16
  caches within 2e-2 of the unsplit bf16 path (the blocks' probabilities
  enter the value product in bf16 before they are normalised, the
  unsplit path's after).
* The MLA latent: ``blocks.mla_decode_partials`` per block, combined,
  against the reference's unsplit latent softmax (JAX), f32 within 1e-5.
* Query blocks: q cut into row blocks (even and uneven), each through
  ``attention_blockwise``/``attention_banded`` with its global offset,
  concatenated, against the whole call (port and JAX), causal and
  windowed, f32 within 1e-5.
* Rank 0 of a fake world of 4 on a 2x2 mesh (a subprocess; shapes only):
  the meshed yi-6b decode step all-gathers no cache bytes (no gathered
  tensor has the cache's length), all-reduces the combine's statistics,
  and makes no copy of its stacked cache (updated in place); neither it
  nor the meshed prefill gathers its logits, which come back vocab-sharded
  at the step's ``out_shardings``; a train step
  of 4 microbatches gathers each batch array at most once, where one
  gather a microbatch was issued before.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro.models.blocks import _cache_positions as jax_cache_positions  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
F32_PORT_TOL = 2e-6
F32_JAX_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cuts(n, parts):
    """Block bounds of n slots cut as DTensor cuts: chunks of ceil(n/parts),
    the tail short or empty."""
    chunk = -(-n // parts)
    starts = [min(i * chunk, n) for i in range(parts)]
    return [(s, min(n, s + chunk)) for s in starts]


def _split_decode(q, k, v, cpos, pos, parts, window=None):
    blocks = [ta.decode_partials(q, k[:, a:b], v[:, a:b], cpos[a:b], pos,
                                 window=window)
              for a, b in _cuts(k.shape[1], parts)]
    m, l, acc = (torch.stack(t) for t in zip(*blocks))
    return ta.finish_decode(ta.combine_partials(m, l, acc), q.dtype)


# (cache slots, blocks, positions, window)
DECODE_CASES = {
    "ring18_first_steps": (18, 2, (0, 1, 2), None),
    "ring18_wrapped": (18, 2, (17, 25, 40), None),
    "uneven_18_over_4": (18, 4, (3, 11, 29), None),
    "window": (24, 3, (5, 23, 50), 7),
    "sixteen_blocks": (64, 16, (0, 63, 100), None),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_matches_unsplit_and_jax(case):
    C, parts, positions, window = DECODE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B, Hq, KVH, D = 2, 8, 2, 16
    for pos in positions:
        q = _rand(rng, (B, 1, Hq, D))
        k, v = _rand(rng, (B, C, KVH, D)), _rand(rng, (B, C, KVH, D))
        cpos = tb._cache_positions(C, pos, "cpu")
        want = ta.attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), cpos, pos,
                                   window=window)
        got = _split_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), cpos, pos, parts, window)
        jwant = np.asarray(ja.attention_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jax_cache_positions(C, jnp.int32(pos)), jnp.int32(pos),
            window=window))
        assert got.shape == want.shape == (B, 1, Hq, D)
        assert float((got - want).abs().max()) <= F32_PORT_TOL, pos
        assert float(np.abs(got.numpy() - jwant).max()) <= F32_JAX_TOL, pos


def test_empty_block_adds_nothing():
    """At pos 0 only slot 0 is written: every later block has max -1e30,
    sum 0 and a zero output, and the combine equals slot 0's value."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rand(rng, (1, 1, 4, 8)))
    k = torch.from_numpy(_rand(rng, (1, 18, 2, 8)))
    v = torch.from_numpy(_rand(rng, (1, 18, 2, 8)))
    cpos = tb._cache_positions(18, 0, "cpu")
    m, l, acc = ta.decode_partials(q, k[:, 9:], v[:, 9:], cpos[9:], 0)
    assert torch.all(m == ta.NEG_INF) and torch.all(l == 0)
    assert torch.all(acc == 0)
    got = _split_decode(q, k, v, cpos, 0, 2)
    want = v[:, :1].repeat_interleave(2, dim=2)        # each group's value
    assert torch.allclose(got, want, atol=1e-6)


def test_split_decode_bf16_within_tolerance():
    rng = np.random.default_rng(5)
    B, C, Hq, KVH, D = 2, 96, 8, 2, 32
    q = torch.from_numpy(_rand(rng, (B, 1, Hq, D))).bfloat16()
    k = torch.from_numpy(_rand(rng, (B, C, KVH, D))).bfloat16()
    v = torch.from_numpy(_rand(rng, (B, C, KVH, D))).bfloat16()
    for pos in (40, 95, 150):
        cpos = tb._cache_positions(C, pos, "cpu")
        want = ta.attention_decode(q, k, v, cpos, pos)
        got = _split_decode(q, k, v, cpos, pos, 16)
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want.float()).abs().max()) <= BF16_TOL


def _jax_latent(q_abs, q_rope, c, r, cpos, pos, scale):
    """The reference's unsplit latent softmax (``decode_mla_block``)."""
    s = jnp.einsum("bqhr,bcr->bhqc", q_abs, c) + \
        jnp.einsum("bqhr,bcr->bhqc", q_rope, r)
    s = s * scale
    s = jnp.where(cpos[None, None, None] <= pos, s, -1e30)
    pw = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqc,bcr->bqhr", pw, c)


@pytest.mark.parametrize("parts", [2, 3, 16])
def test_split_mla_latent_matches_jax(parts):
    rng = np.random.default_rng(parts)
    B, C, H, kr, rope = 2, 20, 4, 16, 8
    scale = (8 + rope) ** -0.5
    for pos in (1, 19, 33):
        q_abs, q_rope = _rand(rng, (B, 1, H, kr)), _rand(rng, (B, 1, H, rope))
        c, r = _rand(rng, (B, C, kr)), _rand(rng, (B, C, rope))
        cpos = tb._cache_positions(C, pos, "cpu")
        blocks = [tb.mla_decode_partials(
            torch.from_numpy(q_abs), torch.from_numpy(q_rope),
            torch.from_numpy(c[:, a:b]), torch.from_numpy(r[:, a:b]),
            cpos[a:b], pos=pos, scale=scale) for a, b in _cuts(C, parts)]
        m, l, acc = (torch.stack(t) for t in zip(*blocks))
        got = tb._latent_rows(ta.combine_partials(m, l, acc))
        want = np.asarray(_jax_latent(
            jnp.asarray(q_abs), jnp.asarray(q_rope), jnp.asarray(c),
            jnp.asarray(r), jax_cache_positions(C, jnp.int32(pos)),
            jnp.int32(pos), scale))
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= F32_JAX_TOL


# (impl, window, query blocks)
QUERY_CASES = {"blockwise_causal": ("blockwise", None, 4),
               "blockwise_window": ("blockwise", 5, 2),
               "banded": ("banded", 6, 4),
               "blockwise_uneven": ("blockwise", None, 3),
               "banded_uneven": ("banded", 6, 5)}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_blocks_match_whole_attention(case):
    impl, window, parts = QUERY_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B, S, Hq, KVH, D = 2, 24, 4, 2, 8
    q, k, v = (_rand(rng, (B, S, h, D)) for h in (Hq, KVH, KVH))
    kr = np.repeat(k, Hq // KVH, axis=2)
    vr = np.repeat(v, Hq // KVH, axis=2)
    kw = dict(kv_block=8, q_block=8)
    whole = ta.attention(torch.from_numpy(q), torch.from_numpy(kr),
                         torch.from_numpy(vr), window=window, impl=impl, **kw)
    jwhole = np.asarray(ja.attention(jnp.asarray(q), jnp.asarray(kr),
                                     jnp.asarray(vr), window=window,
                                     impl=impl, **kw))
    outs = []
    for a, b in _cuts(S, parts):
        qb = torch.from_numpy(q[:, a:b])
        if impl == "banded":
            outs.append(ta.attention_banded(qb, torch.from_numpy(kr),
                                            torch.from_numpy(vr),
                                            window=window, q_block=8,
                                            _q_offset=a))
        else:
            outs.append(ta.attention_blockwise(qb, torch.from_numpy(kr),
                                               torch.from_numpy(vr),
                                               window=window, kv_block=8,
                                               _q_offset=a))
    got = torch.cat(outs, dim=1)
    assert float((got - whole).abs().max()) <= F32_JAX_TOL
    assert float(np.abs(got.numpy() - jwhole).max()) <= F32_JAX_TOL


_FAKE_2X2 = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import SHAPES, ShapeSpec, get_smoke_config, input_specs
from repro_torch.launch.dryrun import _fake_inputs
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import count
from repro_torch.models import param_specs
from repro_torch.sharding import placements
from repro_torch.train import (TrainConfig, make_decode_step,
                               make_prefill_step, make_train_step)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
ops = []


class Shapes(count.Counter):
    def _count(self, func, args, kwargs, out):
        super()._count(func, args, kwargs, out)
        name = func._overloadpacket.__name__
        kind = count._COLLECTIVES.get(name) \\
            if func.namespace in count._COLL_NAMESPACES else None
        if not func.is_view:
            for t in count._tensors(out):
                ops.append((kind or name, list(t.shape)))


cfg = get_smoke_config("yi-6b")
SHAPES["t_decode"] = ShapeSpec("t_decode", "decode", CACHE, 4)
SHAPES["t_prefill"] = ShapeSpec("t_prefill", "prefill", 16, 4)
SHAPES["t_train"] = ShapeSpec("t_train", "train", 16, 8)
out = {"vocab": cfg.vocab,
       "padded_vocab": list(param_specs(cfg)["embed"].shape)[0]}


def named(places):
    return [[type(p).__name__, getattr(p, "dim", None)] for p in places]


def logits_at(logits, sharding):
    if sharding is None or not hasattr(logits, "placements"):
        return {"placements": None, "spec": None, "local": None}
    return {"placements": named(logits.placements),
            "want": named(placements(sharding.mesh, sharding.spec,
                                     logits.ndim)),
            "spec": str(sharding.spec), "local": list(
                logits.to_local().shape)}


with FakeTensorMode():
    dec = make_decode_step(cfg, 4, CACHE, mesh=mesh)
    specs = input_specs(cfg, "t_decode")
    args = [_fake_inputs(m, s, "cpu") for m, s in
            zip((dec.abstract_inputs[0], specs["cache"], specs["tokens"]),
                dec.in_shardings)]
    out["local_cache"] = list(args[1]["k"].to_local().shape)
    with Shapes():
        _, logits = dec.fn(*args, CACHE - 1)
    out["decode"], ops[:] = list(ops), []
    out["decode_logits"] = logits_at(logits, dec.out_shardings[1])
    pre = make_prefill_step(cfg, 4, 16, mesh=mesh)
    specs = input_specs(cfg, "t_prefill")
    args = [_fake_inputs(m, s, "cpu") for m, s in
            zip((pre.abstract_inputs[0], specs["tokens"]), pre.in_shardings)]
    with Shapes():
        _, logits = pre.fn(*args)
    out["prefill"], ops[:] = list(ops), []
    out["prefill_logits"] = logits_at(logits, pre.out_shardings[1])
    tr = make_train_step(cfg, TrainConfig(microbatches=4), 8, 16, mesh=mesh)
    specs = input_specs(cfg, "t_train")
    pshape, oshape, _ = tr.abstract_inputs
    batch = {k: specs[k] for k in tr.in_shardings[2]}
    args = [_fake_inputs(m, s, "cpu") for m, s in
            zip((pshape, oshape, batch), tr.in_shardings)]
    with Shapes():
        tr.fn(*args)
    out["train"] = list(ops)
print("RESULT " + json.dumps(out))
"""
CACHE = 48          # a length no other tensor of the smoke model has


@pytest.fixture(scope="module")
def fake_2x2():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", f"CACHE = {CACHE}\n" +
         textwrap.dedent(_FAKE_2X2)], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_meshed_decode_gathers_no_cache_bytes(fake_2x2):
    ops = fake_2x2["decode"]
    gathers = [s for k, s in ops if k == "all-gather"]
    assert not any(CACHE in s or CACHE // 2 in s for s in gathers), gathers
    # the combine: max and sums of every layer's blocks, over "model"
    assert sum(k == "all-reduce" for k, _ in ops) >= 3 * 2


def test_meshed_decode_updates_its_cache_in_place(fake_2x2):
    """No operation of the step but a view produces a tensor of the
    stacked local cache's shape or of one layer's block (no rebuilt or
    stacked cache, no masked copy of it)."""
    local = fake_2x2["local_cache"]
    assert local[2] == CACHE // 2
    made = [(k, s) for k, s in fake_2x2["decode"]
            if s == local or s == local[1:]]
    assert made == [], made


@pytest.mark.parametrize("step", ["decode", "prefill"])
def test_meshed_step_leaves_its_logits_vocab_sharded(fake_2x2, step):
    """Neither meshed step gathers its logits: no all-gather has the
    width of the padded vocab, of the vocab, or of either's block on a
    rank of "model", and the logits come back as the DTensor the step
    computed, at its ``out_shardings`` (batch over "data", vocab over
    "model"), as the reference leaves them. The prefill's cut of the
    padded vocab to the vocab moves only the entries that change blocks
    (an all-to-all; none reach rank 0)."""
    vp, v = fake_2x2["padded_vocab"], fake_2x2["vocab"]
    assert vp > v             # the smoke vocab is padded: both widths differ
    widths = {vp, v, -(-vp // 2), -(-v // 2)}
    gathers = [s for k, s in fake_2x2[step] if k == "all-gather"]
    assert not [s for s in gathers if s[-1] in widths], gathers
    got = fake_2x2[f"{step}_logits"]
    assert got["spec"] == "PartitionSpec('data', 'model')"
    assert got["placements"] == got["want"] == [["Shard", 0], ["Shard", 1]]
    assert got["local"] == [2, -(-(vp if step == "decode" else v) // 2)]


def test_microbatches_gather_each_batch_array_once_a_step(fake_2x2):
    """4 microbatches of a (8, 16) batch (tokens, labels, mask): at most
    one collective a batch array for the step, moving the batch laid out
    as (4, 2, 16), and none when a microbatch is indexed."""
    batch_sized = [(k, s) for k, s in fake_2x2["train"]
                   if k in ("all-gather", "all-to-all")
                   and s in ([8, 16], [4, 2, 16], [2, 16], [4, 16])]
    assert 1 <= len(batch_sized) <= 3, batch_sized
