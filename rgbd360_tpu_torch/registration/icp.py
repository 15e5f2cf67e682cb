"""Projective ICP on spherical range images (twin of
`rgbd360_tpu/registration/icp.py`).

The reference's geometric-only registrations: `alignPyramidICP`
(point-to-point ICP over depth pyramids, reference
`include/RegisterPhotoICP.h:4800-4903`) and the PCL GICP refinement of
`RegisterPairRGBD360` (reference `Registration/RegisterPairRGBD360.cpp:
112-142`).  Data association is projective (a warp into the target's
spherical grid, no KD-tree), and the error metric is selectable:

  * point-to-point (the reference ICP),
  * point-to-plane with target normals, or
  * GICP, the plane-to-plane metric (Segal et al., RSS 2009): each
    correspondence is weighted by M = (C_q + R C_p R^T)^-1 with the
    surface-aligned covariance C(n) = I - (1-eps) n n^T from the local
    normal on BOTH sides.

Each level runs a fixed number of Gauss-Newton iterations (the reference's
`fori_loop`); an ill-posed step (det(H) < 1e-10 or fewer than 100
correspondences) does not move.  The loop never reads the device: no host
sync until the caller fetches the result.
"""

from __future__ import annotations

import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import camera, se3

POINT_TO_POINT = 0
POINT_TO_PLANE = 1
GICP = 2

# GICP surface-covariance thickness along the normal (Segal et al. use 1e-3;
# the reference links PCL's default-configured GICP).
GICP_EPSILON = 1e-3


def _inv3_sym(s: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric 3x3 matrices (adjugate over
    the determinant, clamped below at 1e-12 as the reference's, negative
    determinants included)."""
    a, b, c = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    d, e, f = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
    i00 = d * f - e * e
    i01 = c * e - b * f
    i02 = b * e - c * d
    i11 = a * f - c * c
    i12 = b * c - a * e
    i22 = a * d - b * b
    det = a * i00 + b * i01 + c * i02
    inv = torch.stack(
        [
            torch.stack([i00, i01, i02], dim=-1),
            torch.stack([i01, i11, i12], dim=-1),
            torch.stack([i02, i12, i22], dim=-1),
        ],
        dim=-2,
    )
    return inv / torch.clamp(det, min=1e-12)[..., None, None]


def _target_normals(depth: torch.Tensor) -> torch.Tensor:
    """Organized normals (H, W, 3) on the spherical grid from central
    differences of the backprojected points (both axes wrap, rows too, as
    the reference's), facing the sensor; 0 where the depth or the normal
    is invalid."""
    pts = camera.sphere_backproject(depth)
    du = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dv = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    n = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-9)
    flip = torch.sum(n * pts, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where((depth > 0)[..., None] & (norm > 1e-9), n, 0.0)


def _jacobian_blocks(tp: torch.Tensor) -> torch.Tensor:
    """[I | -skew(T p)] per point: (N, 3, 6)."""
    eye = torch.eye(3, device=tp.device).expand(tp.shape[:-1] + (3, 3))
    return torch.cat([eye, -se3.skew(tp)], dim=-1)


def _icp_sweep(
    pose, src_pts, src_valid, trg_pack, cfg, variant, max_corr_dist, src_norm=None
):
    """One projective-association sweep at `pose`: (hessian (6, 6),
    gradient (6,), squared error, correspondence count)."""
    h, w = src_valid.shape
    tp = src_pts @ pose[:3, :3].T + pose[:3, 3]
    rc, _ = camera.sphere_project(tp, h, w)
    r = torch.clamp(torch.round(rc[..., 0]).to(torch.int32), 0, h - 1)
    c = torch.remainder(torch.round(rc[..., 1]).to(torch.int32), w)
    inb = (rc[..., 0] >= 0) & (rc[..., 0] < h) & src_valid

    # one row gather of [point, normal, valid] per sweep
    tv = trg_pack.reshape(-1, 7)[(r * w + c).long()]
    q = tv[..., 0:3]
    qn = tv[..., 3:6]
    qv = tv[..., 6] > 0.5
    diff = q - tp
    dist = torch.linalg.norm(diff, dim=-1)
    m = inb & qv & (dist < max_corr_dist)
    wgt = m.to(torch.float32)

    if variant == GICP:
        # plane-to-plane: S = 2I - (1-eps)(nq nq^T + rn rn^T), rn = R n_p;
        # an invalid normal is a zero row, so its covariance degrades to I
        rn = src_norm @ pose[:3, :3].T
        k = 1.0 - GICP_EPSILON
        eye = torch.eye(3, device=tp.device)
        s = (
            2.0 * eye
            - k * (qn[..., :, None] * qn[..., None, :])
            - k * (rn[..., :, None] * rn[..., None, :])
        )
        # Huber on the Mahalanobis distance caps each correspondence's
        # influence at the 1-sigma radius (see the reference)
        minv = _inv3_sym(s)
        d2 = (diff[..., None, :] @ minv @ diff[..., :, None])[..., 0, 0]
        huber = torch.clamp(1.0 / torch.sqrt(torch.clamp(d2, min=1e-12)), max=1.0)
        mw = minv * (wgt * huber)[..., None, None]
        j2 = _jacobian_blocks(tp).reshape(-1, 3, 6)
        m2 = mw.reshape(-1, 3, 3)
        r2 = diff.reshape(-1, 3)
        mj = m2 @ j2  # (N, 3, 6)
        hess = j2.reshape(-1, 6).T @ mj.reshape(-1, 6)
        grad = mj.reshape(-1, 6).T @ r2.reshape(-1)
        err2 = torch.sum(r2[:, None, :] @ m2 @ r2[:, :, None])
    elif variant == POINT_TO_PLANE:
        # residual n . (q - T p); jacobian row [n | (T p) x n]
        rres = torch.sum(qn * diff, dim=-1)
        jac = torch.cat([qn, torch.linalg.cross(tp, qn, dim=-1)], dim=-1)
        jf = (jac * wgt[..., None]).reshape(-1, 6)
        rf = (rres * wgt).reshape(-1)
        hess = jf.T @ jf
        grad = jf.T @ rf
        err2 = torch.sum(rf * rf)
    else:
        # residual vector q - T p; jacobian [I | -skew(T p)] row blocks
        jblk = _jacobian_blocks(tp) * wgt[..., None, None]
        rblk = diff * wgt[..., None]
        j2 = jblk.reshape(-1, 6)
        hess = j2.T @ j2
        grad = j2.T @ rblk.reshape(-1)
        err2 = torch.sum(rblk * rblk)

    return hess, grad, err2, torch.sum(wgt)


class ICPAligner:
    """Coarse-to-fine projective ICP over spherical depth pyramids."""

    def __init__(
        self,
        cfg: DenseRegConfig = DenseRegConfig(),
        variant: int = POINT_TO_PLANE,
        max_corr_dist: float = 0.4,
        iters_per_level: int = 10,
    ):
        self.cfg = cfg
        self.variant = variant
        self.max_corr_dist = max_corr_dist
        self.iters = iters_per_level

    def align(self, src_depth_pyr, trg_depth_pyr, init_pose=None):
        """src/trg: sequences of spherical depth images (level 0 first).

        Returns (pose T_trg<-src, hessian, rms error, n_correspondences),
        tensors on the pyramids' device."""
        dev = src_depth_pyr[0].device
        if init_pose is None:
            init_pose = torch.eye(4, device=dev)
        pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        return self._align_impl(tuple(src_depth_pyr), tuple(trg_depth_pyr), pose)

    def _align_impl(self, src_pyr, trg_pyr, pose):
        cfg = self.cfg
        dev = pose.device
        eye6 = torch.eye(6, device=dev)
        hess = torch.zeros((6, 6), device=dev)
        err = torch.zeros((), device=dev)
        n = torch.zeros((), device=dev)
        for lvl in reversed(range(len(src_pyr))):
            sd, td = src_pyr[lvl], trg_pyr[lvl]
            src_pts = camera.sphere_backproject(sd)
            src_valid = (sd > cfg.min_depth) & (sd < cfg.max_depth)
            src_norm = _target_normals(sd) if self.variant == GICP else None
            trg_valid = (td > cfg.min_depth) & (td < cfg.max_depth)
            # the target channels, packed once per level for the sweep's
            # single row gather
            trg_pack = torch.cat(
                [camera.sphere_backproject(td), _target_normals(td),
                 trg_valid[..., None].to(torch.float32)],
                dim=-1,
            )
            for _ in range(self.iters):
                hess, grad, err2, n = _icp_sweep(
                    pose, src_pts, src_valid, trg_pack, cfg, self.variant,
                    self.max_corr_dist, src_norm=src_norm,
                )
                bad = (torch.linalg.det(hess) < 1e-10) | (n < 100)
                hsafe = torch.where(bad, eye6, hess + 1e-6 * eye6)
                delta = torch.linalg.solve_ex(hsafe, grad[:, None])[0][:, 0]
                delta = torch.where(bad, 0.0, delta)
                pose = se3.se3_exp(delta) @ pose
            err = torch.sqrt(err2 / torch.clamp(n, min=1.0))
        return pose, hess, err, n
