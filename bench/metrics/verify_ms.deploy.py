"""Mean host time of the port's ``follower.verify`` span a deploy, in ms:
the verify gate's re-hash of every chunk of the changed leaves."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "follower.verify")
