"""Fingerprint parity: the port's plain torch version (what the CUDA kernel
is held against on the card) against the JAX package's ``jnp`` path and its
Pallas kernel in interpret mode, bit-exactly.

Named traps: the arithmetic ``>>`` of torch's int32 in place of the logical
shift of the uint32 mix, and the lane order of 64-bit leaves. The CUDA
kernel itself runs only on the card (``python3 chip_smoke.py``); here the
wrapper is shown to launch it or raise for a non-CPU tensor, never to fall
back to the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax.numpy as jnp  # noqa: E402

from repro.core.fingerprint import (fingerprint_chunk_bytes_ref as  # noqa: E402
                                    jax_chunk_ref, fingerprint_chunks_ref,
                                    fingerprint_tree_packed as jax_packed)
from repro.kernels.fingerprint.ops import fingerprint as pallas_fp  # noqa: E402
from repro.kernels.fingerprint.ops import (  # noqa: E402
    fingerprint_tree as pallas_tree)
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core.fingerprint import (  # noqa: E402
    chunk_geometry, fingerprint_chunk_bytes_ref, fingerprint_tree_packed)
from repro_torch.kernels.fingerprint import ops  # noqa: E402
from repro_torch.kernels.fingerprint.ref import (  # noqa: E402
    C1, C2, C3, fingerprint_rows_plain)


def _port(tree, chunk_bytes, stats=None):
    return fingerprint_tree_packed(
        {k: tensor_from_numpy(v) for k, v in tree.items()}, chunk_bytes,
        stats=stats)


def _kernels_tree():
    """The mixed-dtype tree of tests/test_kernels.py (packed-tree case)."""
    rng = np.random.default_rng(4)
    return {
        "f32": rng.standard_normal(3000).astype(np.float32),
        "i8": rng.integers(-100, 100, 2000).astype(np.int8),
        "bf16": rng.standard_normal(1025).astype(ml_dtypes.bfloat16),
        "bool": rng.standard_normal(300) > 0,
    }


def _wide_tree():
    rng = np.random.default_rng(7)
    return {
        "f32": rng.standard_normal(5000).astype(np.float32),        # ragged
        "f32_exact": rng.standard_normal(1024).astype(np.float32),
        "bf16": rng.standard_normal(777).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-100, 100, 3333).astype(np.int8),
        "u16": rng.integers(0, 2 ** 16, 999).astype(np.uint16),
        "bool": rng.standard_normal(1000) > 0,
        "i64": rng.integers(-5, 5, 300).astype(np.int64),
        "f64": rng.standard_normal(129),
        "empty": np.zeros((0,), np.float32),
        "scalar": np.asarray(np.float32(3.5)),
        "matrix": rng.standard_normal((64, 48)).astype(np.float32),
    }


@pytest.mark.parametrize("tree_fn", [_kernels_tree, _wide_tree])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("chunk_bytes", [1024, 512])
def test_packed_tree_bit_exact_with_jax(tree_fn, backend, chunk_bytes):
    tree = tree_fn()
    want = jax_packed(tree, chunk_bytes, backend=backend, interpret=True)
    stats = {}
    got = _port(tree, chunk_bytes, stats)
    assert list(got) == list(want)
    for name in tree:
        assert np.array_equal(got[name], want[name]), name
        assert got[name].dtype == np.int32
    total = sum(v.shape[0] for v in got.values())
    assert stats == {"bytes_d2h": 8 * total, "device_dispatches": 1}


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64])
def test_64bit_lane_order_and_logical_shift(dtype):
    """64-bit leaves split into (low, high) u32 lanes in numpy's
    ``view(np.uint32)`` order; values with the high bit set reach the
    ``>> 15`` with bit 31 set, where an arithmetic shift would differ."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 64, 4099, dtype=np.uint64)
    bits[::3] |= np.uint64(1 << 63)
    a = bits.view(dtype)
    want = fingerprint_chunks_ref(a, 1024)
    got = _port({"x": a}, 1024)["x"]
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, jax_packed({"x": a}, 1024, backend="pallas", interpret=True)["x"])
    # the same words in swapped lane order give another table
    swapped = a.view(np.uint32).reshape(-1, 2)[:, ::-1].copy().view(dtype)
    assert not np.array_equal(_port({"x": swapped}, 1024)["x"], want)


def _mix_arithmetic_shift(u: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The mix as a naive int32 port would write it (the trap)."""
    def i32(x):
        return torch.tensor(x - (1 << 32) if x >= 1 << 31 else x,
                            dtype=torch.int32)
    m = (u * i32(C1)) ^ (pos * i32(C2) + i32(C3))
    m = m ^ (m >> 15)                      # arithmetic on int32
    return m * i32(C3)


def test_arithmetic_shift_trap():
    """int32 ``>>`` sign-extends; the uint32 mix needs a logical shift.
    The port's plain version matches the JAX oracle; the naive int32 mix
    does not, whenever a mixed lane has its top bit set."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2 ** 32, 256, dtype=np.uint32)
    want = fingerprint_chunks_ref(a, 1024)
    assert np.array_equal(_port({"x": a}, 1024)["x"], want)
    naive = _mix_arithmetic_shift(torch.from_numpy(a.view(np.int32)),
                                  torch.arange(256, dtype=torch.int32))
    naive_xor = 0
    for v in naive.tolist():
        naive_xor ^= v & 0xFFFFFFFF
    assert np.int64(naive_xor) != np.int64(want[0, 0]) & 0xFFFFFFFF


def test_chunk_wider_than_one_tile():
    """A chunk wider than the Pallas kernel's tile (cross-tile reduction)
    and wider than one 32 KiB block of the CUDA kernel."""
    x = np.random.default_rng(3).standard_normal(40000).astype(np.float32)
    want = np.asarray(pallas_fp(jnp.asarray(x), 1 << 16, tile_lanes=1024,
                                interpret=True))
    assert np.array_equal(_port({"x": x}, 1 << 16)["x"], want)
    assert np.array_equal(want, fingerprint_chunks_ref(x, 1 << 16))


@pytest.mark.parametrize("chunk_bytes", [1001, 24, 4])
def test_chunk_sizes_off_the_vector_width(chunk_bytes):
    """Rows that are not a multiple of 16 bytes (the kernel's per-lane
    path) and chunks smaller than one element."""
    for name, v in _wide_tree().items():
        got = _port({name: v}, chunk_bytes)[name]
        assert np.array_equal(got, fingerprint_chunks_ref(np.asarray(v),
                                                          chunk_bytes)), name


def test_single_bit_sensitivity():
    x = np.random.default_rng(2).standard_normal(8192).astype(np.float32)
    y = x.copy()
    y[5000] += 1e-7
    fx, fy = _port({"x": x}, 1024)["x"], _port({"x": y}, 1024)["x"]
    changed = np.nonzero(np.any(fx != fy, axis=-1))[0]
    assert list(changed) == [5000 * 4 // 1024]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_fingerprint_of_one_chunk_matches_jax(dtype):
    rng = np.random.default_rng(8)
    a = rng.standard_normal(700)
    a = (a > 0) if dtype == "bool" else a.astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    data = np.asarray(a).tobytes()[:512]
    assert fingerprint_chunk_bytes_ref(data, dtype, 1024) == \
        jax_chunk_ref(data, dtype, 1024)
    assert fingerprint_chunk_bytes_ref(data[:-1], "int16", 1024) is None


def test_geometry_copy_matches_jax():
    from repro.core.fingerprint import chunk_geometry as jax_geometry
    for shape in [(), (0,), (5,), (1000, 3)]:
        for dtype in ["bool", "int8", "bfloat16", "float32", "int64"]:
            for cb in [4, 64, 1000, 1 << 20]:
                assert chunk_geometry(shape, dtype, cb) == \
                    jax_geometry(shape, dtype, cb)


def test_empty_tree():
    assert fingerprint_tree_packed({}, 1024) == {}
    assert fingerprint_rows_plain([], []).shape == (0, 2)


class _CudaLeaf:
    """Stands in for a CUDA tensor on a machine without one."""
    device = torch.device("cuda", 0)


def test_cuda_leaf_launches_the_kernel_or_raises(monkeypatch, tmp_path):
    """For a tensor on the card the wrapper builds and launches the CUDA
    kernel; where it cannot (here: no nvcc, no card) it raises. It never
    runs the plain version for it."""
    from repro_torch.kernels import build

    def no_plain(*args, **kwargs):
        raise AssertionError("plain version used for a CUDA leaf")

    monkeypatch.setattr(ops, "fingerprint_rows_plain", no_plain)
    monkeypatch.setattr(ops, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    before = ops.fingerprint_leaves.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.fingerprint_leaves([_CudaLeaf()], [(1, 1)])
    assert ops.fingerprint_leaves.launches == before


# the entry points under the reference's names: one tensor, a whole tree
def _entry_tree():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2 ** 64, 1500, dtype=np.uint64)
    bits[::2] |= np.uint64(1 << 63)
    return {
        "f32": rng.standard_normal(3001).astype(np.float32),
        "bf16": rng.standard_normal((40, 33)).astype(ml_dtypes.bfloat16),
        "i64": bits.view(np.int64),
    }


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("chunk_bytes", [1024, 96])
def test_fingerprint_entry_point_bit_exact_with_pallas(name, chunk_bytes):
    """``kernels.fingerprint.ops.fingerprint`` against the reference's,
    the Pallas kernel in interpret mode. (A 64-bit jax array needs x64,
    which the reference leaves off; the tree below carries the 64-bit
    leaf.)"""
    a = _entry_tree()[name]
    want = np.asarray(pallas_fp(jnp.asarray(a), chunk_bytes, interpret=True))
    before = ops.fingerprint_leaves.launches
    got = ops.fingerprint(tensor_from_numpy(a), chunk_bytes)
    assert ops.fingerprint_leaves.launches == before     # plain on the CPU
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("chunk_bytes", [1024, 512])
def test_fingerprint_tree_entry_point_bit_exact_with_pallas(chunk_bytes):
    """``kernels.fingerprint.ops.fingerprint_tree`` (one dispatch, one D2H
    of the packed table) against the reference's in interpret mode: f32,
    bf16 and a 64-bit leaf with its high bits set, keyed by path."""
    tree = _entry_tree()
    jstats, tstats = {}, {}
    want = pallas_tree(tree, chunk_bytes, interpret=True, stats=jstats)
    got = ops.fingerprint_tree({k: tensor_from_numpy(v)
                                for k, v in tree.items()}, chunk_bytes,
                               stats=tstats)
    assert list(got) == list(want) == list(tree)
    for name in tree:
        assert got[name].dtype == np.int32
        assert np.array_equal(got[name].view(np.uint32),
                              np.asarray(want[name]).view(np.uint32)), name
    assert tstats == jstats == {
        "bytes_d2h": 8 * sum(v.shape[0] for v in got.values()),
        "device_dispatches": 1}


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        ops.fingerprint_leaves([torch.empty(4, device="meta")], [(1, 4)])
    with pytest.raises(ValueError):
        ops.fingerprint_leaves([torch.zeros(4), torch.empty(4, device="meta")],
                               [(1, 4), (1, 4)])


# ---------------------------------------------------------------------------
# the per-leaf baseline and the numpy oracles

@pytest.mark.parametrize("tree_fn", [_kernels_tree, _wide_tree])
@pytest.mark.parametrize("chunk_bytes", [1024, 100])
def test_per_leaf_and_oracles_bit_exact_with_jax(tree_fn, chunk_bytes):
    """``fingerprint_tree`` (one launch per leaf on the card),
    ``fingerprint_chunks`` and the numpy oracles ``fingerprint_chunks_ref``
    / ``fingerprint_tree_ref`` on bf16, f32, 64-bit, bool and ragged
    leaves: equal to the JAX package's functions of the same names."""
    from repro.core import fingerprint as J
    from repro_torch.core import fingerprint as T
    tree = tree_fn()
    ttree = {k: tensor_from_numpy(v) for k, v in tree.items()}
    want = J.fingerprint_tree(tree, chunk_bytes)
    got = T.fingerprint_tree(ttree, chunk_bytes)
    packed = T.fingerprint_tree_packed(ttree, chunk_bytes)
    ref_t = T.fingerprint_tree_ref(ttree, chunk_bytes)
    ref_np = T.fingerprint_tree_ref(
        {k: v for k, v in tree.items() if str(v.dtype) != "bfloat16"},
        chunk_bytes)
    assert list(got) == list(want) == list(ref_t)
    for name, v in tree.items():
        assert got[name].dtype == np.int32
        for table in (got[name], packed[name], ref_t[name],
                      J.fingerprint_chunks_ref(v, chunk_bytes),
                      J.fingerprint_tree_ref({name: v}, chunk_bytes)[name]):
            assert np.array_equal(table, want[name]), name
        if name in ref_np:
            assert np.array_equal(ref_np[name], want[name]), name
        one = T.fingerprint_chunks(ttree[name], chunk_bytes)
        assert one.dtype == torch.int32
        assert np.array_equal(one.numpy(), want[name]), name
        if v.dtype.itemsize < 8:        # jax without x64 narrows 64-bit
            assert np.array_equal(np.asarray(J.fingerprint_chunks(
                jnp.asarray(v), chunk_bytes)), want[name]), name


def test_per_leaf_saves_equal_packed_ones_with_a_dispatch_per_leaf(
        tmp_path):
    """``packed_fingerprints=False``: the saves, the fingerprint tables
    they keep and the stores equal the packed path's and the JAX
    package's per-leaf saves; ``device_dispatches`` counts one per leaf
    and ``bytes_d2h`` the tables, as the reference counts them."""
    from repro.ckpt import CheckpointManager as JaxManager
    from repro.ckpt import CheckpointPolicy as JaxPolicy
    from repro_torch.ckpt import CheckpointManager, CheckpointPolicy
    from repro_torch.convert import params_from_jax
    rng = np.random.default_rng(9)
    p0 = {"embed": rng.standard_normal((40, 16)).astype(ml_dtypes.bfloat16),
          "blocks": {"w": rng.standard_normal((2, 16, 24)).astype(np.float32),
                     "n": rng.integers(-9, 9, (2, 16)).astype(np.int64)},
          "final_norm": rng.standard_normal(16).astype(np.float32)}
    p1 = {**p0, "final_norm": p0["final_norm"] * np.float32(1.5)}
    kw = dict(async_write=False, use_fingerprints=True, chunk_bytes=256)
    mgrs = {"jax": JaxManager(str(tmp_path / "j"), "toy", JaxPolicy(
                packed_fingerprints=False, keep=10, **kw)),
            "per_leaf": CheckpointManager(str(tmp_path / "t"), "toy",
                                          CheckpointPolicy(
                                              packed_fingerprints=False, **kw)),
            "packed": CheckpointManager(str(tmp_path / "p"), "toy",
                                        CheckpointPolicy(**kw))}
    got = {}
    for name, m in mgrs.items():
        reps = []
        for step, p in ((0, p0), (1, p1)):
            p = p if name == "jax" else params_from_jax(p, "cpu")
            r = m.save(step, p, {})
            reps.append({k: getattr(r, k) for k in (
                "layers_built", "layers_injected", "chunks_written",
                "chunks_prefiltered", "bytes_d2h", "bytes_serialized")})
        stats = {}
        pay = m._payloads(p0 if name == "jax" else params_from_jax(p0, "cpu"),
                          {}, 2)
        fps = m._compute_fps(pay, stats)
        n_leaves = sum(len(t) for t in pay.values())
        got[name] = (reps, {k: v.tolist() for k, v in fps.items()},
                     stats["bytes_d2h"],
                     {k: v.tolist() for k, v in m._last_fps.items()})
        assert stats["device_dispatches"] == (
            1 if name == "packed" else n_leaves)
    assert got["per_leaf"] == got["jax"] == got["packed"]
