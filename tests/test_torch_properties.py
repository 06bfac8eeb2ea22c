"""The reference's four hypothesis properties of the store, held on the
port, with each drawn example run through both packages on the same numpy
inputs:

* injection equals a rebuild and leaves the old image as it was
  (``test_store_property.py``), over f32, f64, int8, bool and bf16 leaves,
  with the port's injected layers' checksums equal to the reference's;
* chunking round-trips (``test_store_property.py``), with the port's
  records, chunk hashes and chunk bytes equal to the reference's;
* a squashed bundle equals applying the deltas one by one
  (``test_squash_property.py``), with the port's squashed bundle the same
  bytes as the reference's squash of the same store;
* a ``DeltaBundle`` round-trips (``test_registry_delta.py``), with
  ``encode_delta`` giving the same bytes in both packages.

bf16 leaves are drawn as their uint16 bit patterns: ``ml_dtypes.bfloat16``
on the reference's side, ``torch.bfloat16`` on the port's.
"""
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from conftest import max_examples  # noqa: E402
from test_torch_crash import bits, port_leaf, ref_leaf  # noqa: E402

DTYPES = ("float32", "float64", "int8", "bool", "bfloat16")


def bf16_bits(a):
    """float32 -> bf16 bit patterns (truncated), as uint16."""
    return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)


def draw_values(rng, dtype: str, n: int) -> np.ndarray:
    """``n`` seeded values of ``dtype``; bf16 as uint16 bit patterns."""
    if dtype == "bfloat16":
        return bf16_bits(rng.standard_normal(n))
    if dtype == "int8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if dtype == "bool":
        return rng.random(n) > 0.5
    return rng.standard_normal(n).astype(dtype)


def cast(value: float, dtype: str):
    """An edit's drawn float as one element of ``dtype``."""
    if dtype == "bfloat16":
        return bf16_bits(np.float32(value))
    if dtype == "int8":
        return np.int8(int(value) % 256 - 128)
    if dtype == "bool":
        return value > 0
    return np.dtype(dtype).type(value)


def layer_sums(store, name, tag):
    m, _ = store.read_image(name, tag)
    return [(la.checksum, la.chain) for la in
            (store.read_layer(lid) for lid in m.layer_ids)]


# ------------------------------------------- injection equivalence (bf16 too)
INJECT_INS = [("FROM", "base", "config"), ("COPY", "data", "content"),
              ("ENV", "x", "config")]


@st.composite
def payload_and_edits(draw):
    n_tensors = draw(st.integers(1, 4))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    payload = {}
    for i in range(n_tensors):
        n = draw(st.integers(1, 3000))
        payload[f"t{i}"] = draw_values(rng, draw(st.sampled_from(DTYPES)), n)
    dtypes = {k: "bfloat16" if v.dtype == np.uint16 else str(v.dtype)
              for k, v in payload.items()}
    edits = []
    for _ in range(draw(st.integers(0, 6))):
        name = f"t{draw(st.integers(0, n_tensors - 1))}"
        idx = draw(st.integers(0, payload[name].size - 1))
        val = draw(st.floats(-1e6, 1e6, allow_nan=False))
        edits.append((name, idx, cast(val, dtypes[name])))
    return payload, edits


def _inject(pkg, leaf, root, payload, new_payload):
    """The reference property's store, v1 built, v2 injected; and a second
    store where v2's payload is built outright."""
    ins = [pkg.Instruction(*i) for i in INJECT_INS]
    store = pkg.LayerStore(root, chunk_bytes=256)
    store.build_image("m", "v1", ins, {"data": lambda: {
        k: leaf(v) for k, v in payload.items()}})
    pkg.inject_payload_update(store, "m", "v1", "v2", {"data": {
        k: leaf(v) for k, v in new_payload.items()}})
    rebuilt = pkg.LayerStore(root + "_rb", chunk_bytes=256)
    m, _, _ = rebuilt.build_image("m", "vr", ins, {"data": lambda: {
        k: leaf(v) for k, v in new_payload.items()}})
    return store, rebuilt, rebuilt.read_layer(m.layer_ids[1])


@settings(max_examples=max_examples(25), deadline=None)
@given(payload_and_edits())
def test_injection_equivalence_and_isolation(pe):
    payload, edits = pe
    new_payload = {k: v.copy() for k, v in payload.items()}
    for name, idx, val in edits:
        new_payload[name][idx] = val
    base = tempfile.mkdtemp(prefix="inject-prop-")
    try:
        store, _, l_rb = _inject(T, port_leaf, f"{base}/port", payload,
                                 new_payload)
        # the reference's four invariants, on the port's store
        assert store.verify_image("m", "v2") == []
        loaded = store.load_image_payload("m", "v2")
        for k in payload:
            assert np.array_equal(bits(loaded[k]), new_payload[k]), k
        assert store.verify_image("m", "v1") == []
        old = store.load_image_payload("m", "v1")
        for k in payload:
            assert np.array_equal(bits(old[k]), payload[k]), k
        m1, _ = store.read_image("m", "v2")
        assert store.read_layer(m1.layer_ids[1]).checksum == l_rb.checksum
        # the same payload and edits through the reference
        ref, _, ref_rb = _inject(J, ref_leaf, f"{base}/ref", payload,
                                 new_payload)
        assert layer_sums(store, "m", "v2") == layer_sums(ref, "m", "v2")
        assert layer_sums(store, "m", "v1") == layer_sums(ref, "m", "v1")
        assert l_rb.checksum == ref_rb.checksum
    finally:
        shutil.rmtree(base, ignore_errors=True)


# -------------------------------------------------------- chunking round trip
@settings(max_examples=max_examples(15), deadline=None)
@given(st.integers(1, 5000), st.integers(0, 2**31),
       st.sampled_from(("float32", "bfloat16")))
def test_chunking_roundtrip(n, seed, dtype):
    arr = draw_values(np.random.default_rng(seed), dtype, n)
    rec, pairs = T.chunk_tensor("x", port_leaf(arr), 512)
    data = b"".join(bytes(p) for _, p in pairs)
    back = T.bytes_to_tensor(data, rec.shape, rec.dtype)
    assert np.array_equal(bits(back), arr)
    rec2, _ = T.chunk_tensor("x", port_leaf(arr), 512)
    assert rec.chunks == rec2.chunks
    ref_rec, ref_pairs = J.chunk_tensor("x", ref_leaf(arr), 512)
    assert rec.to_json() == ref_rec.to_json()
    assert [bytes(p) for _, p in pairs] == [bytes(p) for _, p in ref_pairs]


# ----------------------------------------------- squash == sequential replay
SQUASH_INS = [("FROM", "arch", "config"), ("COPY", "state", "content"),
              ("COPY", "extra", "content"), ("CMD", "serve", "config")]
N_CHUNKS = 8
FLOATS_PER_CHUNK = 128                      # 512 B chunks


def tag(s):
    return f"step-{s:08d}"


def snapshot(store, name, t):
    manifest, config = store.read_image(name, t)
    blobs = {h: store.read_blob(h)
             for lid in manifest.layer_ids
             for rec in store.read_layer(lid).records
             for h in rec.chunks}
    return manifest.to_json(), config.layer_checksums, blobs


def _squash_source(pkg, leaf, root, hops, seed):
    """The reference property's trainer store: step 0 built, then one
    injected step per hop."""
    rng = np.random.default_rng(seed)
    src = pkg.LayerStore(root, chunk_bytes=512)
    state = rng.standard_normal(N_CHUNKS * FLOATS_PER_CHUNK).astype(
        np.float32)
    extra = rng.standard_normal(64).astype(np.float32)
    src.build_image("ckpt", tag(0), [pkg.Instruction(*i) for i in SQUASH_INS],
                    {"state": lambda: {"w": leaf(state)},
                     "extra": lambda: {"e": leaf(extra)}})
    for i, (chunk_ids, touch_extra) in enumerate(hops, start=1):
        state = state.copy()
        for c in chunk_ids:
            lo = c * FLOATS_PER_CHUNK
            state[lo:lo + FLOATS_PER_CHUNK] = \
                rng.standard_normal(FLOATS_PER_CHUNK)
        payload = {"state": {"w": leaf(state)}}
        if touch_extra:
            extra = extra.copy()
            extra[0] = float(i)
            payload["extra"] = {"e": leaf(extra)}
        pkg.inject_payload_update(src, "ckpt", tag(i - 1), tag(i), payload)
    return src


hop_st = st.tuples(
    st.lists(st.integers(0, N_CHUNKS - 1), max_size=3, unique=True),
    st.booleans())


@settings(max_examples=max_examples(25), deadline=None)
@given(hops=st.lists(hop_st, min_size=1, max_size=5),
       seed=st.integers(0, 2**16))
def test_squash_equals_sequential_application(hops, seed):
    base = tempfile.mkdtemp(prefix="squash-prop-")
    try:
        src = _squash_source(T, port_leaf, f"{base}/src", hops, seed)
        head = len(hops)
        seq = T.LayerStore(f"{base}/seq", chunk_bytes=512)
        sq = T.LayerStore(f"{base}/sq", chunk_bytes=512)
        for dst in (seq, sq):
            T.push(src, dst, "ckpt", tag(0))
        for i in range(1, head + 1):        # replay every per-commit hop
            T.import_delta(seq, T.encode_delta(
                T.squash_deltas(src, "ckpt", tag(i - 1), tag(i))))
        squashed = T.encode_delta(T.squash_deltas(src, "ckpt", tag(0),
                                                  tag(head)))
        T.import_delta(sq, squashed)        # ONE squashed bundle
        want = snapshot(src, "ckpt", tag(head))
        assert snapshot(seq, "ckpt", tag(head)) == want
        assert snapshot(sq, "ckpt", tag(head)) == want
        assert sq.verify_image("ckpt", tag(head), deep=True) == []
        # the reference squashes the port's store to the same bytes, and
        # its own injections give the same checksums
        assert J.encode_delta(J.squash_deltas(
            J.LayerStore(f"{base}/src", chunk_bytes=512), "ckpt", tag(0),
            tag(head))) == squashed
        ref = _squash_source(J, ref_leaf, f"{base}/ref", hops, seed)
        for i in range(head + 1):
            assert layer_sums(src, "ckpt", tag(i)) == \
                layer_sums(ref, "ckpt", tag(i))
    finally:
        shutil.rmtree(base, ignore_errors=True)


# -------------------------------------------------- DeltaBundle wire format
_name = st.text(st.characters(min_codepoint=48, max_codepoint=122),
                min_size=1, max_size=12)
_uuid = st.uuids().map(lambda u: u.hex)


@st.composite
def bundle_specs(draw):
    """The reference property's bundle, as plain data that either package
    builds (ids drawn, not taken from ``uuid4``, so both builds agree)."""
    blobs = {}
    for _ in range(draw(st.integers(0, 5))):
        payload = draw(st.binary(min_size=0, max_size=300))
        blobs[J.sha256_hex(payload)] = payload
    layers = []
    for _ in range(draw(st.integers(0, 3))):
        recs = [(f"t{j}", draw(st.lists(st.sampled_from(sorted(blobs)),
                                         min_size=1, max_size=3))
                 if blobs else [])
                for j in range(draw(st.integers(0, 2)))]
        layers.append({"id": draw(_uuid), "version": draw(st.integers(1, 9)),
                       "arg": draw(_name), "recs": recs})
    rekey = {la["id"]: draw(_uuid) for la in layers if draw(st.booleans())}
    return {"name": draw(_name), "tag": draw(_name), "base_tag": draw(_name),
            "config_id": draw(_uuid), "version": draw(st.integers(1, 5)),
            "layers": layers, "rekey": rekey, "blobs": blobs}


def make_bundle(pkg, spec):
    layers, parent = [], None
    for la in spec["layers"]:
        recs = [pkg.TensorRecord(name=n, shape=(4,), dtype="float32",
                                 chunk_bytes=512, chunks=tuple(chunks))
                for n, chunks in la["recs"]]
        ins = pkg.Instruction("COPY", la["arg"], "content")
        checksum = pkg.content_checksum(recs)
        layer = pkg.LayerDescriptor(
            layer_id=la["id"], version=la["version"], instruction=ins,
            checksum=checksum, chain=pkg.chain_checksum(parent, checksum,
                                                        ins.text),
            records=recs, empty=not recs)
        parent = layer.chain
        layers.append(layer)
    manifest = pkg.Manifest(name=spec["name"], tag=spec["tag"],
                            layer_ids=[la.layer_id for la in layers],
                            config_id=spec["config_id"])
    config = pkg.ImageConfig(
        config_id=spec["config_id"], arch="generic", version=spec["version"],
        layer_checksums={la.layer_id: la.checksum for la in layers},
        layer_chains={la.layer_id: la.chain for la in layers},
        history=[{"instruction": "INJECT", "edits": 1}])
    return pkg.DeltaBundle(name=spec["name"], tag=spec["tag"],
                           base_tag=spec["base_tag"], manifest=manifest,
                           config=config, layers=layers,
                           rekey=dict(spec["rekey"]),
                           blobs=dict(spec["blobs"]))


@settings(max_examples=max_examples(30), deadline=None)
@given(bundle_specs())
def test_delta_bundle_roundtrip(spec):
    bundle = make_bundle(T, spec)
    data = T.encode_delta(bundle)
    back = T.decode_delta(data)
    assert back.name == bundle.name
    assert back.tag == bundle.tag
    assert back.base_tag == bundle.base_tag
    assert back.manifest.to_json() == bundle.manifest.to_json()
    assert back.config.to_json() == bundle.config.to_json()
    assert [la.to_json() for la in back.layers] == \
        [la.to_json() for la in bundle.layers]
    assert back.rekey == bundle.rekey
    assert back.blobs == bundle.blobs
    assert T.encode_delta(back) == data
    # the reference builds the same bundle to the same bytes, and reads
    # the port's
    assert J.encode_delta(make_bundle(J, spec)) == data
    assert J.encode_delta(J.decode_delta(data)) == data
