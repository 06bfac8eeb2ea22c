"""Mean host time of ``Engine.generate`` a batch (prefill and every decode
step), in ms."""


def read(trace):
    d = trace.durations("generate")
    return 1e3 * sum(d) / len(d) if d else None
