"""ToF/Kinect cross-calibration from a rawlog of paired 3D observations
(twin of `rgbd360_tpu/calibration/tof.py`).

The reference's `Calibration/ToFCalibrator.cpp:162-284` walks a rawlog whose
sensory frames carry one `CObservation3DRangeScan` from each of two depth
cameras (labels ``KINECT`` and ``CAM3D``), RANSAC-fits the single dominant
plane of each cloud (PCL, 0.03 m threshold, `:231-239,258-266`), flips the
coefficients so d >= 0 (`:237,265`), and appends the plane pair as one row
``[n_a d_a n_b d_b]`` of a growing correspondence matrix saved to
``correspondences.txt`` (`:283`) — which then feeds the pairwise extrinsic
solver (rotation Procrustes + offset LS, `include/Calibrator.h:373,644`).

Here the collection is the same protocol over this framework's rawlog codec
(`io/rawlog.py`), with the plane fit as the batched RANSAC
(`ops/ransac.py`, on a torch device) and the solve as `calibration.solver.PairCalibrator`.
Observations are paired by timestamp proximity instead of sensory-frame
grouping (our rawlogs are observation-streams, format #2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rgbd360_tpu_torch.io.rawlog import Obs3DRangeScan, mrpt_to_unix_timestamp, read_rawlog
from rgbd360_tpu_torch.ops.ransac import ransac_plane

__all__ = ["cloud_from_obs", "collect_tof_correspondences", "calibrate_tof"]


def cloud_from_obs(
    obs: Obs3DRangeScan,
    k: np.ndarray | None = None,
    min_depth: float = 0.3,
    max_depth: float = 10.0,
) -> np.ndarray:
    """Point cloud (N, 3) from one 3D observation: the stored `points3d`
    when present (MRPT's pre-projected points), else the range image
    backprojected through the pinhole K (z-forward, this framework's depth
    convention — `io/rawlog.assemble_rig_frames` feeds range images to the
    same pinhole pipeline)."""
    if obs.points3d is not None and len(obs.points3d):
        return np.asarray(obs.points3d, np.float64)
    if obs.range_image is None:
        return np.zeros((0, 3))
    depth = np.asarray(obs.range_image, np.float64)
    h, w = depth.shape
    if k is None:
        # VGA-scaled default focal, principal point at center — the
        # convention of the reference's cloud builder
        # (`OpenNI2_Grabber/FrameRGBD/CloudRGBD_Ext.h:91-96`)
        f = 525.0 * w / 640.0
        k = np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0], [0, 0, 1.0]])
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (u - k[0, 2]) * depth / k[0, 0]
    y = (v - k[1, 2]) * depth / k[1, 1]
    pts = np.stack([x, y, depth], axis=-1).reshape(-1, 3)
    z = depth.reshape(-1)
    return pts[(z > min_depth) & (z < max_depth)]


@dataclass
class TofFrameResult:
    n_a: np.ndarray
    d_a: float
    n_b: np.ndarray
    d_b: float
    inliers_a: int
    inliers_b: int


def collect_tof_correspondences(
    rawlog_path,
    labels: tuple[str, str] = ("KINECT", "CAM3D"),
    *,
    k_a: np.ndarray | None = None,
    k_b: np.ndarray | None = None,
    dist_threshold: float = 0.03,
    sync_window_s: float = 0.05,
    num_hypotheses: int = 512,
    min_inlier_frac: float = 0.25,
    max_points: int = 16384,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Walk a rawlog, pair the two labeled observations by timestamp, fit
    each cloud's dominant plane, and return the (C, 8) correspondence matrix
    ``[n_a d_a n_b d_b]`` (the reference's `correspMat`,
    `ToFCalibrator.cpp:270-281`).

    Frames where either plane explains less than `min_inlier_frac` of its
    cloud are dropped (degenerate scenes would poison the solve; the
    reference relies on the operator pointing both sensors at a wall).
    The RANSAC runs on `device` (the card when None).
    """
    pending: dict[str, Obs3DRangeScan] = {}
    rows: list[np.ndarray] = []
    rng = np.random.default_rng(seed)
    for obs in read_rawlog(rawlog_path):
        if not isinstance(obs, Obs3DRangeScan) or obs.sensor_label not in labels:
            continue
        pending[obs.sensor_label] = obs
        if len(pending) < 2:
            continue
        ts = [mrpt_to_unix_timestamp(o.timestamp) for o in pending.values()]
        if abs(ts[0] - ts[1]) > sync_window_s:
            # drop the stale one, keep the newer
            older = min(pending, key=lambda lb: mrpt_to_unix_timestamp(pending[lb].timestamp))
            del pending[older]
            continue
        pair = (pending.pop(labels[0]), pending.pop(labels[1]))
        planes = []
        for o, k in zip(pair, (k_a, k_b)):
            pts = cloud_from_obs(o, k)
            if len(pts) < 32:
                planes = []
                break
            if len(pts) > max_points:
                pts = pts[rng.choice(len(pts), max_points, replace=False)]
            n, d, inl = ransac_plane(
                pts,
                dist_threshold=dist_threshold,
                num_hypotheses=num_hypotheses,
                seed=seed,
                device=device,
            )
            if inl.sum() < min_inlier_frac * len(pts):
                planes = []
                break
            planes.append((n, d))
        if planes:
            (na, da), (nb, db) = planes
            rows.append(np.concatenate([na, [da], nb, [db]]))
    return np.asarray(rows).reshape(-1, 8)


def calibrate_tof(corresp: np.ndarray, threshold_conditioning: float = 8000.0, device=None):
    """Pairwise extrinsic solve from a (C, 8) ToF correspondence matrix.

    Returns ``(rt, diag)`` with ``x_a = rt @ x_b`` (sensor B expressed in
    sensor A's frame) — the `Calibrator` consumption of
    ``correspondences.txt``.  The rotation's refinement runs on `device`
    (the card when None).
    """
    from rgbd360_tpu_torch.calibration.solver import PairCalibrator

    corresp = np.atleast_2d(np.asarray(corresp, np.float64))
    if corresp.shape[1] != 8:
        raise ValueError(f"expected (C, 8) correspondences, got {corresp.shape}")
    if len(corresp) < 3:
        raise ValueError("need at least 3 plane correspondences")
    return PairCalibrator(threshold_conditioning, device).calibrate(
        corresp[:, 0:3], corresp[:, 3], corresp[:, 4:7], corresp[:, 7]
    )
