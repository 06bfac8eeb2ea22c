"""Mean host time of the port's ``follower.pull`` span a deploy, in ms: the
replica's delta pull (negotiate, transfer with its import hashing,
commit)."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "follower.pull")
