"""Mean host time of the port's ``follower.load`` span a deploy, in ms:
``load_image_payload`` of the changed leaves from the replica's store."""
from bench.program_spans import mean_ms


def read(trace):
    return mean_ms(trace, "follower.load")
