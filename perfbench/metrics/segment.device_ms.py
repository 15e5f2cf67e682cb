"""segment.device_ms: device ms per traced frame in the plane
segmentation (the program's `segment` range)."""


def read(run):
    t = run.trace
    if t is None or not t.has(["segment"]):
        return None
    return 1e3 * t.device_s(["segment"]) / t.frames
