"""build.device_ms: device ms per traced frame in the frame build's
stitch and cloud stages (the program's `stitch` and `cloud` ranges)."""


def read(run):
    t = run.trace
    if t is None or not t.has(["stitch", "cloud"]):
        return None
    return 1e3 * t.device_s(["stitch", "cloud"]) / t.frames
