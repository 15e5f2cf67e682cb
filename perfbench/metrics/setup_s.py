"""setup_s: process start to the first timed frame (imports, the kernel
library's load or build, the traffic's render and noise, the warm-up)."""


def read(run):
    return run.setup_s
