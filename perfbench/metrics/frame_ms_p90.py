"""frame_ms_p90: the 90th percentile (linear interpolation) of every
window frame's latency, from the call of `process` to its return with the
pose on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 90)) * 1e3 if run.latencies_s else None
