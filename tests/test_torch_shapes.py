"""The port's abstract specs against the JAX package's, bit for bit in
shape and dtype, at full width for all ten archs: ``param_specs`` (the
params' tree on the meta device against ``jax.eval_shape``), and
``configs.shapes``: ``SHAPES``, ``applicable_shapes`` and every input of
``input_specs``, the decode caches included (``decode_32k`` at B 128, S
32768; ``long_500k`` for the sub-quadratic archs). Nothing is allocated on
either side."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jc  # noqa: E402
from repro import models as jm  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.core.chunker import dtype_str  # noqa: E402

ARCHS = list(jc.ARCH_IDS)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _torch_specs(tree):
    return {k: (tuple(v.shape), dtype_str(v)) for k, v in _leaves(tree)}


def _jax_specs(tree):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_at_full_width(arch):
    got = tm.param_specs(tc.get_config(arch))
    assert all(t.is_meta for _, t in _leaves(got))
    assert _torch_specs(got) == _jax_specs(jm.param_specs(jc.get_config(arch)))


def test_shape_table_is_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax_for_every_applicable_shape(arch):
    tcfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    names = tc.applicable_shapes(tcfg)
    assert names == jc.applicable_shapes(jcfg)
    assert ("long_500k" in names) == jcfg.sub_quadratic
    for name in names:
        got, want = tc.input_specs(tcfg, name), jc.input_specs(jcfg, name)
        assert sorted(got) == sorted(want), name
        g, w = dict(got), dict(want)
        if "cache" in w:
            assert _torch_specs(g.pop("cache")) == \
                _jax_specs(w.pop("cache")), name
        assert _torch_specs(g) == _jax_specs(w), name
        assert all(t.is_meta for _, t in _leaves(got)), name


def test_decode_32k_cache_is_the_full_serving_cache():
    """yi-6b's decode cache at the table's B 128 and S 32768: 32 layers of
    K and V, 4 KV heads of 128, in the compute dtype (abstract on both
    sides: 2 x 32 x 128 x 32768 x 4 x 128 x 2 bytes = 4.4 TB)."""
    spec = tc.input_specs(tc.get_config("yi-6b"), "decode_32k")
    k = spec["cache"]["k"]
    assert tuple(k.shape) == (32, 128, 32768, 4, 128)
    assert k.dtype == torch.bfloat16 and k.is_meta
    want = jax.eval_shape(lambda: jm.init_cache(jc.get_config("yi-6b"), 128,
                                                32768))
    assert tuple(want["k"].shape) == tuple(k.shape)
