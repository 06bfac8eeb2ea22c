"""Mean host time of the port's ``store.inject`` span a save, in ms:
``inject_image_multi``'s serialize, hash and write of the changed chunks,
its flush and commit included."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "store.inject")
