"""The fingerprint kernel's share of its roofline, in %: the tree's bytes
read once over the H100's 3.35 TB/s, over the kernel's mean device time a
launch in the profile (kernel ``fp_kernel``)."""
from bench.peaks import HBM_BYTES_PER_S

KERNEL = "fp_kernel"


def read(trace):
    if trace.device is None or not trace.counters.get("tree_bytes"):
        return None
    hits = [(n, t) for k, (n, t) in trace.device["kernels"].items()
            if KERNEL in k]
    launches = sum(n for n, _ in hits)
    if not launches:
        return None
    per_launch = sum(t for _, t in hits) / launches
    return 100.0 * trace.counters["tree_bytes"] / HBM_BYTES_PER_S / per_launch
