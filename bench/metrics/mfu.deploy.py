"""The whole deploy's share of the H100's memory bandwidth, in %: the
tree's bytes read once (what the fingerprint pass must read, the least
device work of a deploy) over the mean deploy time x 3.35 TB/s. It bounds
what ``fingerprint_roofline`` can give ``deploy_s``."""
from bench.peaks import HBM_BYTES_PER_S


def read(trace):
    c = trace.counters
    if not c.get("deploys") or not c.get("tree_bytes"):
        return None
    mean_s = c["deploy_s"] / c["deploys"]
    return 100.0 * c["tree_bytes"] / (mean_s * HBM_BYTES_PER_S)
