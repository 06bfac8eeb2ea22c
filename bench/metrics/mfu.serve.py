"""The served tokens' useful operations (``bench/flops``: prefill, decode,
the head where a token is produced) over the window x the H100's 989
TFLOP/s of bf16, in %."""
from bench.peaks import BF16_FLOPS


def read(trace):
    f = trace.counters.get("serve_flops")
    return 100.0 * f / (trace.window_s * BF16_FLOPS) if f else None
