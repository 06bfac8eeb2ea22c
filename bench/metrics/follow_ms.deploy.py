"""Mean host time of ``CheckpointFollower.poll_and_refresh`` a deploy, in
ms: the pull, the verify gate, the sparse load and ``Engine.refresh``."""


def read(trace):
    d = trace.durations("follow")
    return 1e3 * sum(d) / len(d) if d else None
