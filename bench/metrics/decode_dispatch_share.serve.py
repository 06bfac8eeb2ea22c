"""The share of decode in which the host dispatches and has not run ahead
of the device, in %: 100 x (sum of ``engine.decode_step`` - sum of its
``engine.token_wait``) / sum of ``engine.decode_step`` (100: host-bound)."""
from bench.program_spans import dispatch_share


def read(trace):
    return dispatch_share(trace)
