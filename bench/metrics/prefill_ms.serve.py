"""Mean host time of the port's ``engine.prefill`` span, in ms: a batch's
cache set-up, prefill, sampling and its first token's copy to the host."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "engine.prefill")
