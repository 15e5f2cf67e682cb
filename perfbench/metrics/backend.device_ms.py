"""backend.device_ms: device ms per traced frame in the keyframe
back-end: the deferred keyframe-event engine (the benchmark's
`bench.event` range around each phase it advances) and the program's
`loop_closure` and `optimize` ranges."""

INCLUDE = ["bench.event", "loop_closure", "optimize"]


def read(run):
    t = run.trace
    if t is None or not t.has(INCLUDE):
        return None
    return 1e3 * t.device_s(INCLUDE) / t.frames
