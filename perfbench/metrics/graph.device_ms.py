"""graph.device_ms: device ms per traced frame in the pose-graph solves:
the program's `optimize` range around each solve (the edge terms, the
normal equations, the damped solve and the cost of every LM iteration)."""

INCLUDE = ["optimize"]


def read(run):
    t = run.trace
    if t is None or not t.has(INCLUDE):
        return None
    return 1e3 * t.device_s(INCLUDE) / t.frames
