"""Chunk serialization parity: the torch port's chunker against the JAX
package's, bit for bit, over every dtype the store names.

Also pins two traps at the torch boundary: bf16 (and device) tensors must
never reach ``np.asarray``, and dtype strings must be numpy's names — a
``"torch.bfloat16"`` record would read as a structure change on every save.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core import chunker as jchunk  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import chunker as tchunk  # noqa: E402

DTYPES = sorted(jchunk._DTYPE_SIZES)
SHAPES = [(), (0,), (1,), (777,), (33, 65)]


def _array(dtype: str, shape, rng) -> np.ndarray:
    if dtype == "bool":
        return rng.standard_normal(shape) > 0
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    if dtype.startswith("float"):
        return np.asarray(rng.standard_normal(shape)).astype(dtype)
    info = np.iinfo(dtype)
    return np.asarray(rng.integers(info.min, info.max, size=shape,
                                   dtype=dtype, endpoint=True))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_tensor_matches_jax_package(dtype, shape):
    a = _array(dtype, shape, np.random.default_rng(len(dtype)))
    jrec, jpairs = jchunk.chunk_tensor("x", a, 256)
    trec, tpairs = tchunk.chunk_tensor("x", tensor_from_numpy(a), 256)
    assert trec.to_json() == jrec.to_json()
    assert [h for h, _ in tpairs] == [h for h, _ in jpairs]
    assert [bytes(p) for _, p in tpairs] == [bytes(p) for _, p in jpairs]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_str_is_numpy_name_never_torch(dtype):
    t = tensor_from_numpy(_array(dtype, (5,), np.random.default_rng(0)))
    name = tchunk.dtype_str(t)
    assert name == dtype
    assert not name.startswith("torch.")
    assert tchunk.torch_dtype(name) is t.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_bytes_to_tensor_roundtrip(dtype):
    a = _array(dtype, (7, 9), np.random.default_rng(1))
    data = jchunk.tensor_to_bytes(a)
    t = tchunk.bytes_to_tensor(data, (7, 9), dtype, device="cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert tchunk.dtype_str(t) == dtype and tuple(t.shape) == (7, 9)
    assert bytes(tchunk.tensor_to_bytes(t)) == data


@pytest.mark.parametrize("chunk_bytes", [64, 256, 1000, 1 << 20])
def test_tensor_chunk_bytes_matches_jax_package(chunk_bytes):
    a = np.random.default_rng(2).standard_normal(3001).astype(np.float32)
    t = tensor_from_numpy(a)
    full = bytes(tchunk.tensor_to_bytes(t))
    n = -(-len(full) // chunk_bytes)
    for i in range(n):
        got = tchunk.tensor_chunk_bytes(t, i, chunk_bytes)
        assert got == jchunk.tensor_chunk_bytes(a, i, chunk_bytes)
        assert got == full[i * chunk_bytes:(i + 1) * chunk_bytes]


def test_bf16_never_reaches_np_asarray():
    """The trap: numpy has no bf16, so ``np.asarray`` on a torch bf16
    tensor raises. The port serializes through the bytes instead."""
    a = np.random.default_rng(3).standard_normal(1025).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a)
    with pytest.raises(TypeError):
        np.asarray(t)
    assert bytes(tchunk.tensor_to_bytes(t)) == a.view(np.uint16).tobytes()
    assert tchunk.tensor_chunk_bytes(t, 1, 1024) == \
        a.view(np.uint16).tobytes()[1024:2048]
    rec, _ = tchunk.chunk_tensor("w", t, 1024)
    assert rec.dtype == "bfloat16"


def test_device_tensor_crosses_d2h_only_its_chunk_range(monkeypatch):
    """The other half of the trap: a device tensor handed to ``np.asarray``
    would be copied whole to the host. ``tensor_chunk_bytes`` moves only
    the chunk it was asked for."""
    moved = []
    cpu = torch.Tensor.cpu

    def spy(self, *args, **kwargs):
        moved.append(self.numel() * self.element_size())
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    t = torch.arange(100_000, dtype=torch.float32)
    tchunk.tensor_chunk_bytes(t, 7, 4096)
    assert moved == [4096]


def test_assemble_tensor_checks_the_record():
    t = torch.arange(10, dtype=torch.int16)
    rec, pairs = tchunk.chunk_tensor("x", t, 8)
    blobs = {h: bytes(p) for h, p in pairs}
    back = tchunk.assemble_tensor(rec, blobs.__getitem__)
    assert torch.equal(back, t)
    short = tchunk.TensorRecord("x", (11,), "int16", 8, rec.chunks)
    with pytest.raises(ValueError):
        tchunk.assemble_tensor(short, blobs.__getitem__)
