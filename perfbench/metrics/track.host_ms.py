"""track.host_ms: host ms per traced frame in the tracking solve: the
program's `fused_track`, `register_pbmap` and `register_dense` ranges and
the benchmark's `bench.align` / `bench.register` around the tracker's dense
and plane registrations, less the frame build inside them and the
keyframe events."""

INCLUDE = ["fused_track", "register_pbmap", "register_dense", "bench.align", "bench.register"]
EXCLUDE = ["stitch", "cloud", "pyramid", "segment", "bench.event"]


def read(run):
    t = run.trace
    if t is None or not t.has(INCLUDE):
        return None
    return 1e3 * t.host_s(INCLUDE, EXCLUDE) / t.frames
