"""Mean host time of the port's ``ckpt.detect`` span a save, in ms: the
fingerprint kernel, its table's copy to the host and ``diff_image``."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "ckpt.detect")
