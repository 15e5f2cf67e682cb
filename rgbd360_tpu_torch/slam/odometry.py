"""Frame-to-frame odometry (twin of the `FrameToFrameOdometry` part of
`rgbd360_tpu/slam/odometry.py`).

Pose conventions, as the reference's:
  * `DenseAligner.align(src, trg)` returns T_trg<-src, so
    `align(new_frame, prev_frame)` yields T_prev<-new.
  * `PlaneRegistration.register(ref, trg)` returns T_ref<-trg.
  * World poses compose as pose_new = pose_prev @ T_prev<-new.

Each tracked frame: the front end (`FrameBuilder.build_full`: build,
pyramid, plane segmentation), the PbMap registration against the previous
frame's planes, then the dense aligner from a seed chain (the
constant-velocity step, the PbMap pose, identity, then a yaw-grid rescue).
The seed chain's decisions are host logic on fetched results: each solve's
result comes to the host in ONE copy (`fetch`).  The keyframe engine and
`KeyframeSLAM` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import FrameworkConfig
from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame, SphereFrame
from rgbd360_tpu_torch.ops import se3, stitch as stitch_ops
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration
from rgbd360_tpu_torch.utils.trace import StageTimer


def fetch(tree):
    """The tensors of a result (a dataclass, tuple or list of tensors, or a
    tensor) on the host in ONE device-to-host copy: every leaf goes into
    one float64 buffer (exact for the f32, int and bool fields results
    carry) and is cut back out with its dtype and shape."""
    leaves = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                collect(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves]).cpu()
    host = iter(
        part.reshape(t.shape).to(t.dtype)
        for part, t in zip(torch.split(flat, [t.numel() for t in leaves]), leaves)
    )

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(host)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(
                x, **{f.name: rebuild(getattr(x, f.name)) for f in dataclasses.fields(x)}
            )
        if isinstance(x, (tuple, list)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


def rotation_angle_np(r: np.ndarray) -> float:
    """Host-side rotation angle (radians) of a 3x3 (or 4x4) matrix."""
    return float(np.arccos(np.clip((np.trace(r[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)))


def is_motion_continuous(
    rel: np.ndarray, max_translation: float, max_rotation: float
) -> bool:
    """Odometry continuity guard (reference
    `Registration/OdometryKeyFrame360.cpp:75-95`,
    `include/Miscellaneous.h:69-72`)."""
    dt = float(np.linalg.norm(rel[:3, 3]))
    dr = rotation_angle_np(np.asarray(rel))
    return dt < max_translation and dr < max_rotation


@dataclass
class FrameState:
    """Per-frame working set kept for the tracked reference frame."""

    sphere: SphereFrame
    pyramid: D.FramePyramid
    planes: object  # PlaneSet


class TrackerBase:
    """The aligners, the plane registration, the pyramid function and the
    stage timer a tracker needs, the per-frame state, and the dense seed
    chain."""

    def __init__(self, builder: FrameBuilder, config: FrameworkConfig | None = None):
        self.config = config or builder.config
        self.builder = builder
        self.aligner = D.DenseAligner(self.config.dense)
        # salient tracking is a throughput configuration; hard frames fall
        # back to full dense sweeps
        self.aligner_full = (
            D.DenseAligner(dataclasses.replace(self.config.dense, salient_pixels=0))
            if self.config.dense.salient_pixels > 0
            else None
        )
        self.plane_reg = PlaneRegistration(self.config.matcher)
        seam = stitch_ops.seam_mask_from_maps(builder.maps, 1)
        seam_levels = D.seam_masks_per_level(seam, self.config.dense.pyramid_levels)
        self._pyr = lambda g, d: D.build_frame_pyramid(g, d, self.config.dense, seam_levels)
        # the stage taxonomy as named regions: print(tracker.timer.report())
        self.timer = StageTimer()

    @property
    def device(self) -> torch.device:
        return self.builder.sensor.device

    def make_state(self, raw) -> FrameState:
        """Per-frame tracking state: build + pyramid + segmentation
        (`FrameBuilder.build_full`).  A tracker handed a dense config other
        than the builder's builds its pyramid itself."""
        frame = RigFrame.from_raw(raw, self.device)
        if self.config.dense == self.builder.config.dense:
            with self.timer.region("build"):
                sphere, pyramid, planes = self.builder.build_full(frame, self.timer)
            return FrameState(sphere=sphere, pyramid=pyramid, planes=planes)
        with self.timer.region("build"):
            sphere = self.builder.build(frame)
        with self.timer.region("pyramid"):
            pyramid = self._pyr(sphere.sphere_gray, sphere.sphere_depth)
        with self.timer.region("segment"):
            planes = self.builder.segment_planes(sphere)
        return FrameState(sphere=sphere, pyramid=pyramid, planes=planes)

    def align_with_fallback(self, src_pyr, trg_pyr, seeds, prev_rel=None):
        """Dense alignment tried from a priority-ordered seed chain.

        `seeds` is one 4x4 seed or a list ordered best-guess first;
        identity is always the last resort.  The first solve that is
        well-posed, motion-continuous and below `fallback_error` wins;
        otherwise every remaining seed is tried, then (spherical aligner)
        the two best of a 16-heading yaw grid refined at the coarsest level,
        and, with a salient aligner, the full-sweep re-solve; the best good
        result is returned (the reference's tracking-loss fallbacks).
        `prev_rel`: the previous tracked pose in the same target frame, so
        continuity is checked on the step inv(prev_rel) @ pose.  Returns the
        chosen `AlignResult`, fetched to the host."""
        kf_cfg = self.config.kf
        if not isinstance(seeds, (list, tuple)):
            seeds = [seeds]
        inv_prev = None if prev_rel is None else np.linalg.inv(prev_rel)
        tried: list[np.ndarray] = []

        def novel(s):
            s = np.asarray(s)
            if any(np.allclose(s, u, atol=1e-5) for u in tried):
                return None
            tried.append(s)
            return s

        best = last = None

        def solve(s, aligner=None):
            nonlocal best, last
            res = fetch(
                (aligner or self.aligner).align(
                    src_pyr, trg_pyr, torch.as_tensor(s, dtype=torch.float32, device=self.device),
                    method=D.PHOTO_DEPTH,
                )
            )
            pose = res.pose.numpy()
            step = pose if inv_prev is None else inv_prev @ pose
            good = not bool(res.ill_posed) and is_motion_continuous(
                step, kf_cfg.max_translation_odometry, kf_cfg.max_rotation_odometry
            )
            accepted = good and float(res.error) < kf_cfg.fallback_error
            if good and (best is None or float(res.error) < float(best.error)):
                best = res
            last = res
            return accepted

        for s in [*seeds, np.eye(4)]:
            s = novel(s)
            if s is not None and solve(s):
                return best
        if self.aligner.intrinsics is None:
            # rotation rescue: every seed failed, so the true rotation is
            # outside all their basins; score a yaw grid about the vertical
            # axis in ONE batched coarsest-level refinement and full-align
            # from the best two hypotheses not already tried
            cands = torch.as_tensor(se3.yaw_grid(16), dtype=torch.float32, device=self.device)
            refined, errs = fetch(self.aligner.coarse_align(src_pyr, trg_pyr, cands))
            refined, errs = refined.numpy(), errs.numpy()
            tries = 0
            for i in np.argsort(errs):
                if tries >= 2:
                    break
                s = novel(refined[i])
                if s is None:
                    continue
                tries += 1
                if solve(s):
                    return best
        if self.aligner_full is not None and (
            best is None or float(best.av_depth_residual) >= self.config.kf.select_kf_icp_dist
        ):
            # degraded-salient fallback: re-solve with FULL dense sweeps
            # (seeded by the salient pose first)
            sal_best, sal_last = best, last
            best = last = None
            tried.clear()
            retry = [sal_best.pose.numpy()] if sal_best is not None else []
            for s in [*retry, *seeds, np.eye(4)]:
                s = novel(s)
                if s is not None and solve(s, self.aligner_full):
                    return best
            if best is not None and (
                sal_best is None
                or float(best.av_depth_residual) < float(sal_best.av_depth_residual)
            ):
                return best
            best = sal_best if sal_best is not None else best
            last = sal_last if sal_last is not None else last
        return best if best is not None else last

    def make_state_from_sphere(self, gray, depth, rgb=None) -> FrameState:
        """Tracking state from a raw spherical frame (stereo-variant style
        input, reference `Frame360_stereo`): planes come from the sphere
        itself, and the per-sensor cloud fields are empty placeholders."""
        dev = gray.device
        sphere = SphereFrame(
            sphere_rgb=rgb if rgb is not None else torch.zeros(gray.shape + (3,), device=dev),
            sphere_gray=gray,
            sphere_depth=depth,
            cloud_xyz=torch.zeros((1, 1, 1, 3), device=dev),
            cloud_rgb=torch.zeros((1, 1, 1, 3), device=dev),
            cloud_valid=torch.zeros((1, 1, 1), dtype=torch.bool, device=dev),
            local_xyz=torch.zeros((1, 1, 1, 3), device=dev),
        )
        pyramid = self._pyr(gray, depth)
        planes = self.builder.segment_planes_from_sphere(depth, sphere.sphere_rgb)
        return FrameState(sphere=sphere, pyramid=pyramid, planes=planes)


class FrameToFrameOdometry(TrackerBase):
    """Dense (PbMap-seeded) frame-to-frame odometry (the reference
    `Registration/OdometryRGBD360.cpp` pipeline)."""

    def __init__(self, builder: FrameBuilder, config: FrameworkConfig | None = None):
        super().__init__(builder, config)
        self.prev: FrameState | None = None
        self.pose = np.eye(4)
        self.trajectory: list[np.ndarray] = []
        self.stats: list[dict] = []
        # constant-velocity motion model: the last accepted step
        self.last_step = np.eye(4)

    def process(self, raw) -> dict:
        """Track one raw capture (a `core.frame.RawRigFrame`, or the reference's
        `io.bin_format.RawRigFrame`: anything with `rgb` and `depth_mm`)."""
        return self.process_state(self.make_state(raw))

    def process_state(self, state: FrameState) -> dict:
        info = {"keyframe": False, "tracked": True}
        if self.prev is None:
            self.trajectory.append(self.pose.copy())
            self.prev = state
            info["keyframe"] = True
            return info

        # seed chain: constant-velocity prediction, then the PbMap pose
        # (reference OdometryRGBD360.cpp:205 then dense :251)
        with self.timer.region("register"):
            pb = fetch(self.plane_reg.register(self.prev.planes, state.planes, mode=PLANAR_3DOF))
        seeds = [self.last_step]
        if bool(pb.success):
            seeds.append(pb.pose.numpy())
        with self.timer.region("align"):
            res = self.align_with_fallback(state.pyramid, self.prev.pyramid, seeds)
        rel = res.pose.numpy()  # T_prev<-new
        kf_cfg = self.config.kf
        ok = not bool(res.ill_posed) and is_motion_continuous(
            rel, kf_cfg.max_translation_odometry, kf_cfg.max_rotation_odometry
        )
        if ok:
            self.pose = self.pose @ rel
            self.last_step = rel.copy()
        info.update(
            tracked=ok,
            rel=rel,
            av_depth_residual=float(res.av_depth_residual),
            sso=float(res.sso),
            pb_matches=int(pb.n_matches),
        )
        self.trajectory.append(self.pose.copy())
        self.stats.append(info)
        self.prev = state
        return info
