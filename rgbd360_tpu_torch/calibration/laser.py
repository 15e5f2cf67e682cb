"""Laser(2D scanner) <-> rig extrinsic calibration (a copy of
`rgbd360_tpu/calibration/laser.py`, host float64 numpy).

Covers the reference's laser cross-calibration variant
(`include/CalibrateLaser.h`, `Calibration/LaserCalibrator.cpp`): the rig
observes planes; the laser observes points that lie on those planes; the
laser's pose (R, t) wrt the rig satisfies

    n_k . (R p_i + t) + d_k = 0     for every scan point p_i on plane k.

Solver design (round 5 rewrite — the previous version differentiated
*through* the Huber weight, so far from the solution the cost degenerated to
a flat L1 basin in float32 and translation stalled ~0.1 m off on ~25% of
seeds):

- Host-side float64 Gauss-Newton with the analytic point-on-plane Jacobian
  row [n^T | (q x n)^T] (twist = (v, w), translation first, matching
  `ops/se3.py`).  This is a tiny offline problem (K planes, a few hundred
  points) — the reference solves it in Eigen doubles on the CPU too
  (`include/CalibrateLaser.h`); there is nothing for the card to do here.
- IRLS: a non-robust warmup first (quadratic basin, fast convergence from
  far away), then Huber weights *fixed per iteration* (classic IRLS — the
  weight is a constant during the linear solve, never differentiated).
- Multi-start over a coarse rotation grid; the start with the lowest robust
  cost wins.  Makes the solver independent of the initial guess for any
  physically plausible mounting.
- Eigen-truncated normal equations: directions of the 6x6 Hessian with
  eigenvalues below `cond_eps * max_eig` are zeroed out of the update, so a
  scan that observes fewer than 3 independent plane orientations yields the
  observable components and reports the degeneracy via `conditioning`
  instead of producing a garbage step (same treatment the plane-pose solver
  got in `registration/planes.py`).
"""

from __future__ import annotations

import numpy as np

from rgbd360_tpu_torch.calibration.solver import conditioning


def _exp_se3(xi: np.ndarray) -> np.ndarray:
    """Float64 SE(3) exp, xi = (v, w) translation-first (ops/se3.py layout)."""
    v, w = xi[:3], xi[3:]
    theta = float(np.linalg.norm(w))
    wx = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64
    )
    wx2 = wx @ wx
    if theta < 1e-10:
        a, b, c = 1.0 - theta**2 / 6.0, 0.5 - theta**2 / 24.0, 1.0 / 6.0
    else:
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta**2
        c = (1.0 - a) / theta**2
    r = np.eye(3) + a * wx + b * wx2
    vmat = np.eye(3) + b * wx + c * wx2
    t4 = np.eye(4)
    t4[:3, :3] = r
    t4[:3, 3] = vmat @ v
    return t4


def _rotation_starts() -> list[np.ndarray]:
    """Identity + the 6 axis-aligned 90-degree mounts + 180-degree flips."""
    starts = [np.eye(3)]
    axes = np.eye(3)
    for k in range(3):
        wx = np.array(
            [
                [0, -axes[k, 2], axes[k, 1]],
                [axes[k, 2], 0, -axes[k, 0]],
                [-axes[k, 1], axes[k, 0], 0],
            ]
        )
        for ang in (np.pi / 2, -np.pi / 2, np.pi):
            starts.append(
                np.eye(3) + np.sin(ang) * wx + (1 - np.cos(ang)) * (wx @ wx)
            )
    return starts


class LaserCalibrator:
    def __init__(
        self,
        huber_scale: float = 0.02,
        iters: int = 30,
        warmup_iters: int = 8,
        cond_eps: float = 1e-9,
    ):
        self.huber_scale = huber_scale
        self.iters = iters
        self.warmup_iters = warmup_iters
        self.cond_eps = cond_eps

    def _solve_from(
        self,
        rt0: np.ndarray,
        n: np.ndarray,
        d: np.ndarray,
        p: np.ndarray,
    ) -> tuple[np.ndarray, float]:
        """GN/IRLS from one start; returns (rt, robust cost)."""
        rt = rt0.copy()
        scale = self.huber_scale
        for it in range(self.iters):
            q = p @ rt[:3, :3].T + rt[:3, 3]
            r = np.sum(n * q, axis=1) + d
            if it < self.warmup_iters:
                w = np.ones_like(r)
            else:
                # Huber IRLS weight, held constant during the solve.
                absr = np.maximum(np.abs(r), 1e-12)
                w = np.where(absr < scale, 1.0, scale / absr)
            jac = np.concatenate([n, np.cross(q, n)], axis=1)  # (N, 6)
            jw = jac * w[:, None]
            h = jac.T @ jw
            g = jw.T @ r
            evals, evecs = np.linalg.eigh(h)
            keep = evals > self.cond_eps * max(evals[-1], 1e-30)
            inv = np.where(keep, 1.0 / np.where(keep, evals, 1.0), 0.0)
            delta = -(evecs * inv) @ (evecs.T @ g)
            rt = _exp_se3(delta) @ rt
            if np.linalg.norm(delta) < 1e-12:
                break
        q = p @ rt[:3, :3].T + rt[:3, 3]
        r = np.sum(n * q, axis=1) + d
        absr = np.abs(r)
        cost = float(
            np.sum(
                np.where(
                    absr < scale, 0.5 * r**2, scale * (absr - 0.5 * scale)
                )
            )
        )
        return rt, cost

    def calibrate(
        self,
        plane_normals: np.ndarray,
        plane_ds: np.ndarray,
        scan_points: np.ndarray,
        point_plane: np.ndarray,
        rt0: np.ndarray | None = None,
    ):
        """plane_normals (K, 3) / plane_ds (K,): planes in the rig frame;
        scan_points (N, 3): points in the laser frame (2D scans have z = 0);
        point_plane (N,): plane index per point.
        Returns (rt (4, 4) laser->rig, diagnostics)."""
        plane_normals = np.asarray(plane_normals, np.float64)
        plane_ds = np.asarray(plane_ds, np.float64)
        n = plane_normals[point_plane]
        d = plane_ds[point_plane]
        p = np.asarray(scan_points, np.float64)

        if rt0 is not None:
            starts = [np.asarray(rt0, np.float64)]
        else:
            starts = []
            for r0 in _rotation_starts():
                t4 = np.eye(4)
                t4[:3, :3] = r0
                starts.append(t4)

        best_rt, best_cost = None, np.inf
        for s in starts:
            rt, cost = self._solve_from(s, n, d, p)
            if cost < best_cost:
                best_rt, best_cost = rt, cost

        q = p @ best_rt[:3, :3].T + best_rt[:3, 3]
        resid = np.sum(n * q, axis=1) + d
        # Inlier rms (Huber scale gate) — outlier clutter must not pollute
        # the convergence diagnostic.
        inl = np.abs(resid) < 3 * self.huber_scale
        rms_all = float(np.sqrt(np.mean(resid**2)))
        rms_inl = float(np.sqrt(np.mean(resid[inl] ** 2))) if inl.any() else rms_all
        diag = dict(
            rms=rms_inl,
            rms_all=rms_all,
            inlier_frac=float(np.mean(inl)),
            conditioning=conditioning(plane_normals),
            n_points=len(scan_points),
        )
        return np.asarray(best_rt, np.float32), diag
