"""Bytes on the wire to the replica (``PushStats.bytes_sent``: blobs,
descriptors, manifests and the negotiation) over the bytes the saves
serialised: the paper's redeployment claim."""


def read(trace):
    c = trace.counters
    if not c.get("deploys") or not c.get("bytes_serialized"):
        return None
    return c.get("bytes_sent", 0.0) / c["bytes_serialized"]
