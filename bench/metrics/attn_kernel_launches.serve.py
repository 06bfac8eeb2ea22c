"""The hand-written flash attention kernel's launches a prefill: the mean
over the port's ``engine.prefill`` spans of their ``attn_kernel_launches``
(one a layer where the prefill's attention runs on the kernel, 0 where it
runs the plain loop)."""
from bench.program_spans import mean_attr


def read(trace):
    return mean_attr(trace, "engine.prefill", "attn_kernel_launches")
