"""The port's ``ft`` package against the JAX package's: its exports, the
straggler policy (``DeadlineSkipper``) decision for decision over a
scripted sequence of host step times, and ``shrink_mesh_shape`` over a
grid of surviving device counts."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.ft as JF  # noqa: E402
import repro_torch.ft as TF  # noqa: E402


def test_exports_are_the_references():
    assert TF.__all__ == JF.__all__
    assert all(hasattr(TF, name) for name in TF.__all__)


def timings(n_hosts, steps, seed):
    """Host step times: a steady fleet with a slow spell on one host, a
    persistent straggler, and one outlier step."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        t = {h: float(1.0 + 0.05 * rng.standard_normal())
             for h in range(n_hosts)}
        if 3 <= s < 6:
            t[1] = 2.6 + 0.1 * s
        if s >= 8:
            t[n_hosts - 1] = 5.0
        if s == 11:
            t[0] = 2.5
        out.append(t)
    return out


@pytest.mark.parametrize("n_hosts,factor,cordon_after,alpha", [
    (4, 2.0, 3, 0.1), (8, 1.5, 2, 0.3), (3, 2.0, 1, 0.0)])
def test_deadline_skipper_decides_as_the_reference(n_hosts, factor,
                                                   cordon_after, alpha):
    mine = TF.DeadlineSkipper(n_hosts, factor, cordon_after, alpha)
    ref = JF.DeadlineSkipper(n_hosts, factor, cordon_after, alpha)
    for t in timings(n_hosts, 16, seed=n_hosts):
        inc = mine.decide(t)
        assert inc == ref.decide(t)
        assert mine.contribution_weights(inc) == \
            ref.contribution_weights(inc)
        assert mine.ewma == ref.ewma
        assert mine.consecutive == ref.consecutive
    assert dataclasses.asdict(mine.stats) == dataclasses.asdict(ref.stats)
    assert mine.stats.skips > 0 and mine.stats.cordoned


def test_shrink_mesh_shape_is_the_references():
    for alive in (1, 7, 15, 16, 17, 31, 64, 255, 256, 1000):
        for model in (1, 2, 4, 8, 16):
            for pods in (1, 2, 4):
                assert TF.shrink_mesh_shape(alive, model, pods) == \
                    JF.shrink_mesh_shape(alive, model, pods)
    assert TF.shrink_mesh_shape(64) == JF.shrink_mesh_shape(64)
