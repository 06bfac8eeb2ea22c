"""Bytes the replica's verify gate re-hashed (``follower.verify``'s
``bytes``, summed) over the bytes of the chunks the deltas changed, which
the benchmark works out from the deltas it applied (and each save's
step)."""
from bench.program_spans import bytes_per_changed


def read(trace):
    return bytes_per_changed(trace, "follower.verify")
