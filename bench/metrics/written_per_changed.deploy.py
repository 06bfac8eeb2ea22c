"""Bytes the saves serialised (``BuildReport.bytes_serialized``) over the
bytes of the chunks the deltas changed, which the benchmark works out
from the deltas it applied (and each save's step)."""


def read(trace):
    c = trace.counters
    if not c.get("deploys") or not c.get("changed_chunk_bytes"):
        return None
    return c["bytes_serialized"] / c["changed_chunk_bytes"]
