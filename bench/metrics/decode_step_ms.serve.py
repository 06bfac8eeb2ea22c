"""Mean host time of the port's ``engine.decode_step`` span, in ms: one
decode step, its sampling and the copy of the token it produced."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "engine.decode_step")
