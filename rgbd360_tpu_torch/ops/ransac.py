"""Batched-hypothesis RANSAC plane fit on unorganized point clouds (twin of
`rgbd360_tpu/ops/ransac.py`).

The reference fits one dominant plane per cloud with PCL's
`RandomSampleConsensus<SampleConsensusModelPlane>` at a 0.03 m distance
threshold in its ToF/Kinect cross-calibration app
(`Calibration/ToFCalibrator.cpp:231-239,258-266`), and MRPT's generic
RANSAC with a plane model in the control-plane matcher
(`Calibration/GetControlPlanes.cpp:129-243`).

All hypotheses are drawn up front and every (point, hypothesis) pair is
scored in one (N, H) matrix product; the argmax over hypotheses replaces
the sequential best-so-far, with the same result for a fixed budget:

  * H random 3-point index triples from a seeded `torch.Generator` (the
    reference draws them with `jax.random`, which PyTorch cannot
    reproduce: `_ransac_plane_core` takes the triples, so both packages
    can be fed the same ones);
  * a plane per triple by cross product, degenerate triples (collinear or
    repeated points, or an invalid point) masked out;
  * |P n^T + d| < tau inlier counts for all hypotheses at once;
  * optionally a least-squares refit (the covariance's smallest
    eigenvector) on the winner's inliers.

Plane convention: (n, d) with n . x + d = 0, |n| = 1, d >= 0 (the
reference flips the coefficients when d < 0, `ToFCalibrator.cpp:237,265`).
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_tpu_torch import resolve_device

__all__ = ["ransac_plane", "fit_plane_lsq"]


def draw_triples(n_pts: int, num_hypotheses: int, seed: int, device) -> torch.Tensor:
    """(H, 3) int64 point indices in [0, n_pts), from a generator seeded
    with `seed` on `device` (the same seed gives the same triples on one
    kind of device)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, n_pts, (num_hypotheses, 3), generator=gen, device=device)


def _ransac_plane_core(pts: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
                       dist_threshold: float):
    """pts (N, 3) f32, valid (N,) bool, idx (H, 3) index triples ->
    (n (3,), d (), best_count ()); the first hypothesis of the largest
    count wins, as the reference's argmax."""
    p0, p1, p2 = (pts[idx[:, k]] for k in range(3))  # (H, 3) each
    v0 = torch.all(valid[idx], dim=1)  # drawn from valid points only
    nrm = torch.linalg.cross(p1 - p0, p2 - p0)
    mag = torch.linalg.norm(nrm, dim=1)
    ok = v0 & (mag > 1e-8)
    nrm = nrm / torch.clamp(mag, min=1e-12)[:, None]
    d = -torch.sum(nrm * p0, dim=1)  # (H,)
    # (N, H) distances as one product; invalid points never vote
    dist = torch.abs(pts @ nrm.T + d[None, :])
    votes = (dist < dist_threshold) & valid[:, None]
    counts = torch.where(ok, torch.sum(votes, dim=0), -1)
    best = torch.argmax(counts)
    return nrm[best], d[best], counts[best]


def _refit_core(pts: torch.Tensor, w: torch.Tensor):
    """Weighted LS plane through pts: the weighted covariance's
    smallest eigenvector n, and d = -n . centroid."""
    sw = torch.clamp(torch.sum(w), min=1e-12)
    c = torch.sum(pts * w[:, None], dim=0) / sw
    q = (pts - c) * torch.sqrt(w)[:, None]
    _, vecs = torch.linalg.eigh(q.T @ q)
    n = vecs[:, 0]
    return n, -torch.dot(n, c)


def _oriented(n: torch.Tensor, d: torch.Tensor):
    n, d = n.cpu().numpy().astype(np.float64), float(d)
    return (-n, -d) if d < 0 else (n, d)


def fit_plane_lsq(points, weights=None, device=None):
    """Least-squares plane (n, d) through weighted points, d >= 0, computed
    on `device` (the card when None)."""
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    w = (torch.ones(pts.shape[0], device=device) if weights is None
         else torch.as_tensor(np.asarray(weights, np.float32), device=device))
    return _oriented(*_refit_core(pts, w))


def ransac_plane(
    points,
    valid=None,
    *,
    dist_threshold: float = 0.03,
    num_hypotheses: int = 512,
    seed: int = 0,
    refine: bool = True,
    device=None,
):
    """Fit the dominant plane of a point cloud on `device` (the card when
    None).

    Returns ``(n (3,) float64, d float, inlier_mask (N,) bool)`` with
    n . x + d = 0 and d >= 0.  `dist_threshold` defaults to PCL's 0.03 m
    from the reference ToF calibrator (`ToFCalibrator.cpp:232`).
    """
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(pts.shape)}")
    if pts.shape[0] < 3:
        raise ValueError("need at least 3 points")
    v = (torch.ones(pts.shape[0], dtype=torch.bool, device=device) if valid is None
         else torch.as_tensor(np.asarray(valid, bool), device=device))
    v = v & torch.all(torch.isfinite(pts), dim=1)
    pts = torch.nan_to_num(pts)
    idx = draw_triples(pts.shape[0], num_hypotheses, seed, device)
    n, d, count = _ransac_plane_core(pts, v, idx, dist_threshold)
    if int(count) <= 0:
        raise ValueError("RANSAC found no valid plane hypothesis")
    inliers = (torch.abs(pts @ n + d) < dist_threshold) & v
    if refine:
        n, d = _refit_core(pts, inliers.to(torch.float32))
        inliers = (torch.abs(pts @ n + d) < dist_threshold) & v
    n, d = _oriented(n, d)
    return n, d, inliers.cpu().numpy()
