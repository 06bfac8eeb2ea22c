"""Mean host time of the port's ``ckpt.retain`` span a save, in ms: the
trainer's retention (``prune_steps`` and the store's gc) and publish."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "ckpt.retain")
