"""plane_track.host_ms: host ms per traced frame in the plane tracking of
the PbMap tracker: the program's `register_pbmap` range around each plane
registration against a recent keyframe and the fetch of its result, and
the benchmark's `bench.register` inside it."""

INCLUDE = ["register_pbmap", "bench.register"]


def read(run):
    t = run.trace
    if t is None or not t.has(INCLUDE):
        return None
    return 1e3 * t.host_s(INCLUDE) / t.frames
