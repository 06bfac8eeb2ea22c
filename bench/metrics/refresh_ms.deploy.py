"""Mean host time of the port's ``engine.refresh`` span a deploy, in ms:
the changed leaves copied to the device into the serving tree."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "engine.refresh")
