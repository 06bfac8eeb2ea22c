"""Mean host time of ``CheckpointManager.save`` a deploy, in ms (the
benchmark's span around the synchronous save)."""


def read(trace):
    d = trace.durations("save")
    return 1e3 * sum(d) / len(d) if d else None
