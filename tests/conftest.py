import os

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def max_examples(default: int) -> int:
    """Hypothesis example count: the PR path runs the per-suite default;
    the nightly CI job raises it via HYPOTHESIS_MAX_EXAMPLES (see
    .github/workflows/ci.yml) to hunt rare generative counterexamples."""
    return int(os.environ.get("HYPOTHESIS_MAX_EXAMPLES", default))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
