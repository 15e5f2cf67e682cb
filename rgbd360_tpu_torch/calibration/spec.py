"""Construction-spec rig extrinsics, in numpy: the port's one definition
of `rgbd360_tpu/calibration/solver.py:construction_spec_rt`, which
`calibration.solver` imports (and the synthetic rig and the rawlog export
use without the solver).
"""

from __future__ import annotations

import numpy as np


def construction_spec_rt(num_sensors: int = 8, radius: float = 0.055) -> np.ndarray:
    """Construction-spec prior: sensors on a ring 45 deg apart, offset
    `radius` from the axis (reference `loadConstructionSpecs:763`).  The
    rig's up axis is x; sensor s looks along the rig direction of azimuth
    s * 2pi/S (consistent with `ops/camera.sphere_rays`)."""
    rts = []
    for s in range(num_sensors):
        ang = 2.0 * np.pi * s / num_sensors
        # sensor z (optical axis) points outward: rig dir (0, -sin, -cos)@ang
        z = np.array([0.0, -np.sin(ang), -np.cos(ang)])
        x = np.array([0.0, np.cos(ang), -np.sin(ang)])  # sensor x in rig
        y = np.cross(z, x)
        r = np.stack([x, y, z], axis=1)
        t = z * radius
        rt = np.eye(4)
        rt[:3, :3] = r
        rt[:3, 3] = t
        rts.append(rt)
    return np.stack(rts)
