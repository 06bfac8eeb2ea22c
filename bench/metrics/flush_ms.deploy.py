"""Mean host time of the port's ``store.flush`` span a save, in ms: the
batched fsyncs and the manifest commit."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "store.flush")
