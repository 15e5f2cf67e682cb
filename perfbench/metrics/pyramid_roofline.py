"""pyramid_roofline: the least time the frame pyramids of the traced
window could take (the bytes each must move, from its level shapes, over
the card's 3.35 TB/s) as a share of the device time of every kernel
launched inside the program's `pyramid` ranges, in %."""

from perfbench.roofline import bound_s, pyramid_bytes


def read(run):
    t = run.trace
    if t is None or not t.has(["pyramid"]):
        return None
    busy = t.device_s(["pyramid"])
    if busy <= 0:
        return None
    s = run.config.sphere
    least, _ = bound_s(pyramid_bytes(s.height, s.width, run.config.dense.pyramid_levels), 0.0)
    return 100.0 * least * t.range_count("pyramid") / busy
