"""Trajectory accuracy against the generator's ground truth, printed on
an earlier line of each run (not a compared number).

Frozen copy of `ate_rmse` from `rgbd360_tpu_torch/utils/metrics.py`
(repository commit e7cf3fe).
"""

from __future__ import annotations

import numpy as np


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (position RMSE, metres); with `align`, the
    estimate is first moved so that the first poses coincide."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    if align:
        est = np.einsum("ij,njk->nik", gt[0] @ np.linalg.inv(est[0]), est)
    d = est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d**2).sum(axis=1).mean()))
