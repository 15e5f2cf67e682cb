"""Joint dense alignment of a whole multi-sensor rig in the robot frame
(twin of `rgbd360_tpu/registration/rig_dense.py`).

The reference's `RegisterRGBD360::RegisterDensePhotoICP`
(`include/RegisterRGBD360.h:344-460`) with the robot-frame variants
`calcPhotoICPError_robot` / `calcHessianGradient_robot`
(`include/RegisterPhotoICP.h:4905,5083`): the 8 per-sensor pinhole RGB-D
pairs are aligned with ONE shared robot pose.  The sensors are the batch
axis of the dense sweep (`dense._hess_grad_packed`, per-sensor normal
equations and statistics), folded through each sensor's SE(3) adjoint:

    T_i = Rt_i^-1 . T . Rt_i         (camera-frame motion of sensor i)
    H  = sum_i Ad_i^T H_i Ad_i,   g = sum_i Ad_i^T g_i,   Ad_i = Ad(Rt_i^-1)

This registers two rig captures from the RAW per-sensor images without a
stitched sphere.
"""

from __future__ import annotations

import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import se3
from rgbd360_tpu_torch.registration.dense import (
    _CHANNELS,
    PHOTO_DEPTH,
    AlignResult,
    FramePyramid,
    _build_pyramid,
    _gn_loop,
    _hess_grad_packed,
    _pack_target,
    _src_points,
    scale_intrinsics,
)

__all__ = ["RigDenseAligner", "build_rig_pyramid"]

_STATS = ("photo_sq", "photo_n", "depth_sq", "depth_n")


def _zero(stat: str, device) -> torch.Tensor:
    """The starting value of a joint statistic: counts are integers."""
    dtype = torch.int64 if stat.endswith("_n") or stat == "visible" else torch.float32
    return torch.zeros((), dtype=dtype, device=device)


def build_rig_pyramid(
    grays: torch.Tensor, depths: torch.Tensor, cfg: DenseRegConfig = DenseRegConfig()
) -> FramePyramid:
    """Per-sensor pinhole pyramids with a leading sensor axis, (S, H, W)
    levels (gray in [0, 1], depth in metres): the sensors are the batch
    of one pyramid build, 1 K1 launch and one K2 launch per level
    transition, with no seam masking."""
    return _build_pyramid(grays, depths, cfg, None, grays.shape[0], spherical=False)


class RigDenseAligner:
    """Coarse-to-fine joint Gauss-Newton over all rig sensors.

    intrinsics: (3, 3) pinhole K shared by the sensors (reference
    `include/Calib360.h:59-77`).  extrinsics: (S, 4, 4) sensor-to-robot
    transforms Rt_i (reference `Calib360::getRt_id`)."""

    def __init__(self, intrinsics, extrinsics, cfg: DenseRegConfig = DenseRegConfig()):
        self.cfg = cfg
        self.rt = torch.as_tensor(extrinsics, dtype=torch.float32)
        self.k = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.rt.device)
        self.rt_inv = se3.se3_inverse(self.rt)
        self.adj = se3.adjoint(self.rt_inv)  # (S, 6, 6)

    def align(
        self,
        src: FramePyramid,
        trg: FramePyramid,
        init_pose=None,
        method: int = PHOTO_DEPTH,
        occlusion: int = 0,
    ) -> AlignResult:
        """Align two rig pyramids (`build_rig_pyramid`); returns the
        ROBOT-frame relative pose (source -> target) and the joint 6x6
        information matrix."""
        dev = src.gray[0].device
        if init_pose is None:
            init_pose = torch.eye(4, device=dev)
        init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        return self._align_impl(src, trg, init_pose, method, occlusion)

    def _joint_normal_eqs(self, src_gray, pts, valid, trg_pack, pose, intr, method, occlusion):
        """The sensors' sweeps (one batched sweep) folded through their
        adjoints into the robot frame's normal equations and statistics."""
        rt, rt_inv, adj = (x.to(pose.device) for x in (self.rt, self.rt_inv, self.adj))
        cam_poses = rt_inv @ pose @ rt  # (S, 4, 4)
        h_i, g_i, stats = _hess_grad_packed(
            src_gray, pts, valid, trg_pack, cam_poses, self.cfg, method, occlusion, intr
        )
        adj_t = adj.mT
        hess = torch.sum(adj_t @ h_i @ adj, dim=0)
        grad = torch.sum((adj_t @ g_i[..., None])[..., 0], dim=0)
        joint = {k: torch.sum(stats[k]) if k in stats else _zero(k, pose.device)
                 for k in _STATS}
        joint["visible"] = torch.sum(stats["visible"])
        n = joint["photo_n"] + joint["depth_n"]
        joint["mean_err"] = torch.sqrt(
            (joint["photo_sq"] + joint["depth_sq"]) / torch.clamp(n, min=1)
        )
        return hess, grad, joint

    def _align_impl(self, src, trg, init_pose, method, occlusion=0):
        cfg = self.cfg
        dev = init_pose.device
        pose = init_pose
        ill = torch.zeros((), dtype=torch.bool, device=dev)
        iters = []
        for lvl in reversed(range(cfg.pyramid_levels)):
            intr = scale_intrinsics(self.k.to(dev), lvl)
            depth = src.depth[lvl]
            pts, valid = _src_points(depth, cfg, intr)
            # (S, H, W, 6), or 24 channels when cfg.bilinear: each sensor's
            # taps with pinhole edge-clamped columns
            trg_pack = _pack_target(
                {k: getattr(trg, k)[lvl] for k in _CHANNELS}, cfg.bilinear, wrap=False
            )
            src_gray = src.gray[lvl].flatten(-2)
            pts, valid = pts.flatten(-3, -2), valid.flatten(-2)

            def sweep(cand):
                return self._joint_normal_eqs(
                    src_gray, pts, valid, trg_pack, cand, intr, method, occlusion
                )

            st0 = {k: _zero(k, dev) for k in _STATS + ("mean_err", "visible")}
            pose, err, n_it, ill, hess_lvl, stats_lvl = _gn_loop(
                sweep, pose, ill, cfg, cfg.max_iters_per_level, st0
            )
            iters.append(torch.clamp(n_it, min=0))
            if lvl == 0:
                hess_out, stats = hess_lvl, stats_lvl
                size = depth.numel()

        return AlignResult(
            pose=pose,
            hessian=hess_out,
            error=err,
            av_photo_residual=torch.sqrt(stats["photo_sq"] / torch.clamp(stats["photo_n"], min=1)),
            av_depth_residual=torch.sqrt(stats["depth_sq"] / torch.clamp(stats["depth_n"], min=1)),
            sso=stats["visible"] / size,
            iters=torch.stack(iters[::-1]),
            ill_posed=ill,
        )
