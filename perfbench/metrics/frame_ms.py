"""frame_ms: the whole window, through the final flush of deferred
keyframe events and a synchronize, over the frames handed over in it."""


def read(run):
    return 1e3 * run.window_s / run.frames if run.frames else None
