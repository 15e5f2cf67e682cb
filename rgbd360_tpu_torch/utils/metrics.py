"""First-class SLAM quality metrics (twin of `rgbd360_tpu/utils/metrics.py`).

The reference prints these inline (SURVEY.md section 5.5); here they are
importable: registration entropy (Kerl IROS'13), matched-area tracking score
(reference `RegisterRGBD360::trackingScore:526`), SSO co-visibility, and
trajectory metrics (ATE / RPE) for evaluation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GOOD = 2
WEAK = 1
BAD = 0


def entropy(information: torch.Tensor) -> torch.Tensor:
    """Differential entropy of a pose estimate from its 6x6 information."""
    _, logdet = torch.linalg.slogdet(information)
    dof = 6.0
    # H = 0.5 (dof (1 + log 2pi) + log det Sigma); log det Sigma = -log det I
    return 0.5 * (dof * (1.0 + math.log(2.0 * math.pi)) - logdet)


def tracking_score(area_matched: float, area_source: float) -> int:
    """Matched-area ratio score (reference thresholds 0.7 / 0.3)."""
    ratio = area_matched / max(area_source, 1e-9)
    if ratio >= 0.7:
        return GOOD
    if ratio >= 0.3:
        return WEAK
    return BAD


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (position RMSE); optionally aligns the
    first poses (sequences share their start)."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    if align:
        t_align = gt[0] @ np.linalg.inv(est[0])
        est = np.einsum("ij,njk->nik", t_align, est)
    d = est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt((d**2).sum(axis=1).mean()))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over `delta`-frame intervals; returns
    (trans RMSE m, rot RMSE rad)."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    n = len(est) - delta
    terrs, rerrs = [], []
    for i in range(n):
        e_rel = np.linalg.inv(est[i]) @ est[i + delta]
        g_rel = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(g_rel) @ e_rel
        terrs.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )


def mean_and_std(v) -> tuple[float, float]:
    """Mean and standard deviation of a data vector (reference
    `Miscellaneous.h:calcMeanAndStDev:153`)."""
    a = np.asarray(v, np.float64)
    return float(a.mean()), float(a.std())


def trajectory_length(poses: np.ndarray) -> float:
    p = np.asarray(poses)[:, :3, 3]
    return float(np.sum(np.linalg.norm(np.diff(p, axis=0), axis=1)))
