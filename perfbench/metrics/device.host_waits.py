"""device.host_waits: calls per traced frame that block the host on the
card (`cudaStreamSynchronize`, `cudaEventSynchronize`, `cudaMemcpy`)."""


def read(run):
    t = run.trace
    return None if t is None else t.host_waits() / t.frames
