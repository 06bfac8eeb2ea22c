"""The train steps' useful operations (6 x matrix params x tokens plus
causal attention x 3, ``bench/flops``) over the window x the H100's 989
TFLOP/s of bf16, in %."""
from bench.peaks import BF16_FLOPS


def read(trace):
    f = trace.counters.get("train_flops")
    return 100.0 * f / (trace.window_s * BF16_FLOPS) if f else None
