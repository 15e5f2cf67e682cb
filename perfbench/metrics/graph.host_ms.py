"""graph.host_ms: host ms per traced frame in the pose-graph solves: the
program's `optimize` range around each solve, its launches and the host
read of each LM iteration's flags."""

INCLUDE = ["optimize"]


def read(run):
    t = run.trace
    if t is None or not t.has(INCLUDE):
        return None
    return 1e3 * t.host_s(INCLUDE) / t.frames
