"""Odometry and keyframe SLAM trackers (twin of
`rgbd360_tpu/slam/odometry.py`).

Pose conventions, as the reference's:
  * `DenseAligner.align(src, trg)` returns T_trg<-src, so
    `align(new_frame, keyframe)` yields T_kf<-new.
  * `PlaneRegistration.register(ref, trg)` returns T_ref<-trg, so
    `register(keyframe, new_frame)` also yields T_kf<-new.
  * World poses compose as pose_new = pose_kf @ T_kf<-new.

Trackers:
  * FrameToFrameOdometry: PbMap seed + dense refinement each frame,
    trajectory accumulation, continuity guards.
  * KeyframeSLAM: plane fast path, dense tracking against the current
    keyframe, residual-based keyframe selection, neighbor-keyframe
    connections, loop closure, pose-graph optimization, topological
    partitioning, relocalization after tracking loss.  The per-keyframe map
    work runs as a deferred, phased event (see `TrackerBase`).

Each tracked frame: the front end (`FrameBuilder.build_full`: build,
pyramid, plane segmentation), the PbMap registration against the previous
frame's planes, then the dense aligner from a seed chain (the
constant-velocity step, the PbMap pose, identity, then a yaw-grid rescue).
The seed chain's decisions are host logic on fetched results: each solve's
result comes to the host in ONE copy (`fetch`).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import FrameworkConfig
from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame, SphereFrame
from rgbd360_tpu_torch.ops import se3, stitch as stitch_ops
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration
from rgbd360_tpu_torch.slam.graph import optimize_pose_graph, optimize_pose_graph_pcg
from rgbd360_tpu_torch.slam.loop_closure import LoopCloser, top_k_stable
from rgbd360_tpu_torch.slam.map import Map360, tree_leaves
from rgbd360_tpu_torch.slam.relocalizer import Relocalizer
from rgbd360_tpu_torch.slam.topological import (
    MAX_AREAS_DEVICE,
    _clamp_areas,
    area_adjacency_device,
    partition_map,
)
from rgbd360_tpu_torch.utils.host import fetch
from rgbd360_tpu_torch.utils.trace import StageTimer


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
    stage timer a tracker needs, the per-frame state, the dense seed chain,
    and the deferred keyframe-event engine.

    The engine (the reference's background loop-closure thread,
    `include/LoopClosure360.h:93`, as a queue on the host): `_pending` is a
    FIFO of (generator, awaited tensors, dispatch counter, readiness
    marker), advanced HEAD-ONLY between frames.  Each phase of an event's
    generator enqueues device work and yields the tensors it needs fetched;
    the poller fetches them (one copy) and sends the host values back in.
    Head-only advancement serializes events (no two events' phases
    interleave, and every event's first phase observes its predecessors'
    applied effects) while a new keyframe ENQUEUES its event instead of
    draining the previous one.  A phase is ready when a `torch.cuda.Event`
    recorded after its last launch has completed (`Event.query()`); on the
    CPU a phase is ready at once.  The reference's fixed polling cadence for
    multi-process runs is not ported (it exists for the sharded path, see
    `KeyframeSLAM`)."""

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
        self._pending: deque = deque()
        # per-event count of dispatch sites (map updates, batched scans and
        # solves); _advance_head swaps in the advancing event's counter so
        # every dispatch is attributed to the event that issued it
        self._cur_counter = [0]
        self.kf_event_dispatches: list[int] = []

    @property
    def device(self) -> torch.device:
        return self.builder.sensor.device

    # ------------------------------------------------ deferred event engine

    def _nd(self, n: int = 1) -> None:
        """Count one dispatch site of the active keyframe event: each map
        update or batched scan / solve is 1 (the places where the reference
        launches one compiled program)."""
        self._cur_counter[0] += n

    def _event_backpressure(self) -> None:
        """Bound the in-flight keyframe-event queue at 2: when keyframes
        cluster faster than events complete, drain the HEAD first.  The
        bound keeps worst-case staleness at one event (a looser one let
        partitions and optimized poses lag several keyframes in the
        reference's measurements)."""
        while len(self._pending) >= 2:
            self._advance_head()

    def _mark_phase(self):
        """The readiness marker of the work enqueued so far: an event on
        the card's stream, None on the CPU."""
        if self.device.type != "cuda":
            return None
        marker = torch.cuda.Event()
        marker.record()
        return marker

    @staticmethod
    def _phase_ready(marker) -> bool:
        return marker is None or marker.query()

    def _poll_pending(self, block: bool = False) -> None:
        """Advance the deferred keyframe-event queue, HEAD event only: to
        the next phase whenever the head's awaited tensors are ready, so
        tracked frames interleave with the event instead of blocking on it.
        `block=True` runs the whole queue to completion (drain)."""
        while self._pending:
            _, struct, _, marker = self._pending[0]
            if struct is not None and not block and not self._phase_ready(marker):
                return
            self._advance_head()

    def _advance_head(self) -> None:
        """Resume the head event's generator one phase, attributing its
        dispatches to its own counter.  Generators follow a send protocol:
        each phase yields the tensors it needs FETCHED and receives the
        fetched (host) values as the yield's result, so the poller owns the
        copy to the host."""
        gen, struct, counter, _ = self._pending[0]
        saved = self._cur_counter
        self._cur_counter = counter
        try:
            try:
                # first advance: run to the first yield
                out = next(gen) if struct is None else gen.send(fetch(struct))
                self._pending[0] = (gen, out, counter, self._mark_phase())
            except StopIteration:
                self._pending.popleft()
        finally:
            self._cur_counter = saved

    def _drain_pending(self) -> None:
        """Run any deferred keyframe event to completion (map readers and
        the next keyframe event need the fully-applied map)."""
        self._poll_pending(block=True)

    def flush(self) -> None:
        """Public drain: call before reading `map`, `optimized_trajectory`
        or exporting; applies any still-deferred keyframe-event work."""
        self._drain_pending()

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

    def align_with_fallback(self, src_pyr, trg_pyr, seeds, prev_rel=None, pre=None):
        """Dense alignment tried from a priority-ordered seed chain.

        `seeds` is one 4x4 seed or a list ordered best-guess first;
        identity is always the last resort.  The first solve that is
        well-posed, motion-continuous and below `fallback_error` wins;
        otherwise every remaining seed is tried, then (spherical aligner)
        the two best of a 16-heading yaw grid refined at the coarsest level,
        and, with a salient aligner, the full-sweep re-solve; the best good
        result is returned (the reference's tracking-loss fallbacks).
        `prev_rel`: the previous tracked pose in the same target frame, so
        continuity is checked on the step inv(prev_rel) @ pose.  `pre`: an
        optional (seed, fetched result) pair from the fused tracked frame;
        the first chain entry matching that seed reuses the solve instead
        of running it again.  Returns the chosen `AlignResult`, fetched to
        the host."""
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
        pre_seed, pre_res = pre if pre is not None else (None, None)

        def solve(s, aligner=None):
            nonlocal best, last, pre_seed
            if aligner is None and pre_seed is not None and np.allclose(s, pre_seed, atol=1e-9):
                res = pre_res
                pre_seed = None  # consume once
            else:
                res = fetch(
                    (aligner or self.aligner).align(
                        src_pyr, trg_pyr,
                        torch.as_tensor(s, dtype=torch.float32, device=self.device),
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


def _connection_kernel(opt_poses, n_kf, area, n_areas, edges_ij, emask, k: int, radius: float):
    """Device-side connection-candidate selection (reference
    `KFsphere_SLAM.cpp:405-461`): same/neighbor-area keyframes within the
    connection radius, nearest first (equal distances: the older keyframe
    first).  Returns a FIXED top-16 slate (indices, validity, seeds
    inv(T_kf) @ T_new computed on the device), so a keyframe event pulls
    O(16), not O(capacity), to the host."""
    n = opt_poses.shape[0]
    idx = torch.arange(n, device=opt_poses.device)
    live = idx < n_kf
    kf_pose = opt_poses[k]
    dist = torch.linalg.norm(opt_poses[:, :3, 3] - kf_pose[:3, 3], dim=1)
    neigh = area_adjacency_device(area, edges_ij, emask, n)
    a = _clamp_areas(area, min(n, MAX_AREAS_DEVICE))
    allowed = (n_areas <= 1) | neigh[a[k]][a]
    ok = live & allowed & (idx != k) & (dist < radius)
    score = torch.where(ok, -dist, -torch.inf)
    top_s, top_i = top_k_stable(score, min(16, n))
    seeds = torch.linalg.solve_ex(opt_poses[top_i], kf_pose.expand(len(top_i), 4, 4))[0]
    return top_i, top_s > -torch.inf, seeds


class KeyframeSLAM(TrackerBase):
    """Keyframe SLAM with dense tracking, loop closure and pose-graph
    optimization, on one device.

    A tracked frame is `build_full` -> `PlaneRegistration.register` against
    the keyframe -> `DenseAligner.align` from the motion-model seed, with
    ONE fetch of both results (`process`); every other case (first frame,
    lost, config mismatch) takes the split path (`make_state` +
    `process_state`).

    A promotion is ONE path: capacity growth, `_add_keyframe`,
    `_add_edges`, `_post_keyframe`.  The reference also has a fused
    promotion program that computes the event's first phase in the same
    launch when no event is pending; a fresh head event is advanced at once
    by `_post_keyframe`, so its first phase sees exactly the map that fused
    program would, and the generator's phase A is the only one here.

    `mesh=` (the reference's keyframe-sharded loop-closure scan and
    distributed pose-graph PCG) is not ported: it raises
    NotImplementedError until `parallel/sharded.py` is (ROADMAP P8)."""

    def __init__(self, builder: FrameBuilder, config: FrameworkConfig | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "KeyframeSLAM(mesh=) waits for ROADMAP P8 (parallel/sharded.py: the "
                "sharded plane scan and distributed_pose_graph_pcg)"
            )
        super().__init__(builder, config)
        cfg = self.config
        self.map = self._empty_map()
        # connection aligns start `kf.connection_coarse_level` pyramid
        # levels below full resolution: one level down is 4x fewer rows at
        # a few mm of extra error, ample for auxiliary graph edges
        self._conn_level = min(cfg.kf.connection_coarse_level, cfg.dense.pyramid_levels - 1)
        self._conn_aligner = (
            D.DenseAligner(
                dataclasses.replace(
                    cfg.dense,
                    pyramid_levels=cfg.dense.pyramid_levels - self._conn_level,
                    salient_pixels=0,
                    polish_iters=0,
                )
            )
            if self._conn_level > 0
            else self.aligner
        )
        self.loop_closer = LoopCloser(cfg)
        self.relocalizer = Relocalizer(cfg)
        self._reset_state()

    def _empty_map(self) -> Map360:
        cfg = self.config
        return Map360.empty(
            cfg.map, cfg.sphere.height, cfg.sphere.width, cfg.seg.max_planes,
            cfg.seg.hull_dirs, self.device,
        )

    def _reset_state(self) -> None:
        self.current_kf = -1
        self.kf_state: FrameState | None = None
        # host mirror of the optimized pose array: per-frame policy reads
        # (keyframe pose, trajectory anchors) would otherwise cost a copy
        # from the device EACH, and a wait on all queued work.  Invalidated
        # by whatever changes the optimized poses (optimize, resume).
        self._opt_poses_host: np.ndarray | None = None
        # keyframe payloads do not change -> their pyramids are memoized
        self._kf_pyr_cache: dict = {}
        # host mirror of the graph's edge pairs, kept incrementally
        self._edge_set: set[tuple[int, int]] = set()
        # host mirrors of the live counts and the area ids: reading
        # `int(map.n_kf)` waits for every queued launch
        self._n_kf_host = 0
        self._n_edges_host = 0
        self._area_host: list[int] = []
        self._pending.clear()
        self._cur_counter = [0]
        self.kf_event_dispatches = []
        self.pose = np.eye(4)  # current frame world pose
        self.trajectory: list[np.ndarray] = []
        self.lost = False
        self.n_loop_closures = 0
        self.events: list[dict] = []
        # constant-velocity motion model: pose of the last tracked frame
        # relative to the current KF, and the last accepted frame-to-frame
        # step; their composition predicts the next frame's T_kf<-new
        self.track_rel: np.ndarray | None = None
        self.last_step = np.eye(4)
        # last well-tracked frame (state + rel/hessian/sso/dres), retained
        # as the keyframe-promotion candidate
        self._last_frame: dict | None = None
        # per-frame anchor (kf index, T_kf<-frame) for optimized_trajectory
        self.frame_anchors: list[tuple[int, np.ndarray]] = []
        # running photometric residual of accepted tracking solves: the
        # self-calibrating reference level for the LC photo gate
        self._ref_photo: float | None = None

    # ------------------------------------------------------------ helpers

    def reset(self) -> None:
        """Clear the map, the trajectory and the tracking state."""
        self.map = self._empty_map()
        self._reset_state()
        self.timer.reset()

    def _opt_pose(self, k: int) -> np.ndarray:
        """Optimized pose of keyframe k from the host mirror (one bulk copy
        per invalidation instead of one per read)."""
        if self._opt_poses_host is None:
            self._opt_poses_host = self.map.opt_poses.cpu().numpy()
        return self._opt_poses_host[k]

    def _add_keyframe(self, state: FrameState, pose: np.ndarray) -> int:
        self._event_backpressure()
        self._cur_counter = [0]  # the event's dispatch count starts here
        k = self._n_kf_host
        # a new keyframe joins its tracking parent's topological area; the
        # periodic partitioner refines the assignment (reference
        # `TopologicalMap360::addKeyframe`, `TopologicalMap360.h:81`)
        area_id = self._area_host[self.current_kf] if self.current_kf >= 0 else 0
        self._area_host.append(area_id)
        self.map = self.map.add_keyframe(
            pose, state.sphere.sphere_gray, state.sphere.sphere_depth, state.planes,
            area_id=area_id, n_live=k,
        )
        self._nd()
        self._n_kf_host = k + 1
        self.current_kf = k
        self.kf_state = state
        # update the host pose mirror IN PLACE (the new KF's optimized pose
        # IS its trajectory pose): invalidating would make the next
        # `_opt_pose` read wait for every queued launch
        if self._opt_poses_host is not None and k < len(self._opt_poses_host):
            self._opt_poses_host[k] = np.asarray(pose)
        else:
            self._opt_poses_host = None
        self._kf_pyr_cache[k] = state.pyramid
        # the new KF IS the last tracked frame; the frame-to-frame step of
        # the motion model remains valid across the reference switch
        self.track_rel = np.eye(4)
        # any retained promotion candidate was relative to the old KF
        self._last_frame = None
        return k

    def _add_edge(self, i: int, j: int, rel, info, sso=0.0, is_loop=False):
        """Add a graph edge and mirror the pair host-side."""
        self._add_edges([(i, j, rel, info, sso, is_loop)])

    def _add_edges(self, edges: list[tuple]) -> None:
        """Add a batch of (i, j, rel, info, sso, is_loop) edges in ONE map
        update (`Map360.add_edges`) and mirror the pairs host-side."""
        if not edges:
            return
        ij = np.asarray([(int(i), int(j)) for i, j, *_ in edges], np.int32)
        self.map = self.map.add_edges(
            ij,
            np.stack([np.asarray(e[2], np.float32) for e in edges]),
            np.stack([np.asarray(e[3], np.float32) for e in edges]),
            np.asarray([float(e[4]) for e in edges], np.float32),
            np.asarray([bool(e[5]) for e in edges]),
            n_live=self._n_edges_host,
        )
        self._nd()
        self._n_edges_host += len(edges)
        self._edge_set.update((int(i), int(j)) for i, j in ij)

    def _promote(self, state: FrameState, pose: np.ndarray, prev_kf: int,
                 edges: list[tuple], ev: dict) -> tuple[int, bool]:
        """Promote `state` as a new keyframe with its (prev_kf -> k) edge
        slate and enqueue the keyframe event.  `edges`: list of (rel, info,
        sso, is_loop).  Returns (k, optimized); `optimized` is meaningful
        only in synchronous mode (see `_post_keyframe`)."""
        k = self._add_keyframe(state, pose)
        ev["keyframe"] = True
        self._add_edges([(prev_kf, k, r, i, s, l) for r, i, s, l in edges])
        return k, self._post_keyframe(state, k, ev)

    # --------------------------------------------------- checkpoint/resume

    def save_checkpoint(self, path: str) -> None:
        """Persist the whole SLAM state: the map's leaves plus the
        host-side tracking state (current KF, pose, trajectory, lost flag).
        The keyframe pyramids are rebuilt from the map payload on resume."""
        self._drain_pending()
        np.savez_compressed(
            path,
            **{f"map_{i}": a for i, a in enumerate(self.map.to_numpy())},
            current_kf=np.int64(self.current_kf),
            pose=self.pose,
            trajectory=np.stack(self.trajectory) if self.trajectory else np.zeros((0, 4, 4)),
            lost=np.bool_(self.lost),
            n_loop_closures=np.int64(self.n_loop_closures),
            track_rel=(
                self.track_rel if self.track_rel is not None else np.full((4, 4), np.nan)
            ),
            last_step=self.last_step,
            anchor_kf=np.asarray([k for k, _ in self.frame_anchors], np.int64),
            anchor_rel=(
                np.stack([r for _, r in self.frame_anchors])
                if self.frame_anchors
                else np.zeros((0, 4, 4))
            ),
        )

    def resume_from_checkpoint(self, path: str) -> None:
        """Restore what `save_checkpoint` saved into this tracker."""
        data = np.load(path)
        n_leaves = len(tree_leaves(self.map))
        self.map = Map360.from_numpy([data[f"map_{i}"] for i in range(n_leaves)], self.map)
        self.current_kf = int(data["current_kf"])
        self.pose = np.asarray(data["pose"])
        self.trajectory = list(np.asarray(data["trajectory"]))
        self.lost = bool(data["lost"])
        self.n_loop_closures = int(data["n_loop_closures"])
        self.kf_state = None  # pyramids rebuilt lazily from the map payload
        self._opt_poses_host = None
        self._kf_pyr_cache = {}
        self._pending.clear()
        self._n_kf_host = int(self.map.n_kf)
        self._n_edges_host = int(self.map.n_edges)
        self._area_host = [int(a) for a in self.map.area[: self._n_kf_host].cpu()]
        self._edge_set = {
            (int(a), int(b)) for a, b in self.map.graph.edges_ij[: self._n_edges_host].cpu()
        }
        if "track_rel" in data:
            tr = np.asarray(data["track_rel"])
            self.track_rel = None if np.isnan(tr).any() else tr
            self.last_step = np.asarray(data["last_step"])
        else:
            self.track_rel, self.last_step = None, np.eye(4)
        if "anchor_kf" in data:
            self.frame_anchors = list(
                zip([int(k) for k in data["anchor_kf"]], np.asarray(data["anchor_rel"]))
            )
        else:
            self.frame_anchors = []

    def _emit(self, ev: dict) -> dict:
        """Close out a frame: record the trajectory sample, its keyframe
        anchor (for `optimized_trajectory`), and the event."""
        kf = max(self.current_kf, 0)
        anchor = np.linalg.inv(self._opt_pose(kf)) @ self.pose
        self.frame_anchors.append((kf, anchor))
        self.trajectory.append(self.pose.copy())
        self.events.append(ev)
        # opportunistic non-blocking advance of any deferred keyframe event
        # (after the anchor read: phases may apply optimized poses)
        self._poll_pending()
        return ev

    def optimized_trajectory(self) -> np.ndarray:
        """Full per-frame trajectory with every frame re-anchored to its
        keyframe's CURRENT optimized pose, so pose-graph corrections (loop
        closures) apply to the whole history, not just to keyframes added
        afterwards."""
        self._drain_pending()
        opt = self.map.opt_poses.cpu().numpy()
        return np.stack([opt[kf] @ rel for kf, rel in self.frame_anchors])

    def _keep_tracking(self, state: FrameState, rel, res, depth_res: float) -> bool:
        """Keyframe decision (reference `KFsphere_SLAM.cpp:388-396` plus the
        rotation trigger): True when the frame stays a tracked, non-keyframe
        frame.  Healthy frames are retained as the last-good promotion
        candidate and refresh the LC photo-gate reference level (degraded
        solves must NOT loosen that gate)."""
        kf_cfg = self.config.kf
        ang = rotation_angle_np(np.asarray(rel))
        healthy = depth_res < kf_cfg.select_kf_icp_dist
        small_rot = ang < kf_cfg.max_rotation_keyframes
        small_motion = (
            float(np.linalg.norm(rel[:3, 3])) < kf_cfg.min_dist_keyframes and small_rot
        )
        if healthy:
            self._last_frame = {
                "state": state,
                "rel": rel,
                "hessian": res.hessian.numpy(),
                "sso": float(res.sso),
                "dres": depth_res,
            }
            self._ref_photo = float(res.av_photo_residual)
        return (healthy and small_rot) or small_motion

    def _optimize_dispatch(self):
        """The pose-graph solve; returns (poses, chi2) on the device and the
        iteration count.  The solver is chosen by the map's CAPACITY: dense
        LM up to `graph.pcg_threshold_kf` keyframes, matrix-free LM-PCG
        beyond."""
        g = self.config.graph
        loop_mask = self.map.edge_is_lc if g.robust_lc else None
        if self.map.kf_capacity > g.pcg_threshold_kf:
            return optimize_pose_graph_pcg(
                self.map.graph, g.max_iters, lm_lambda0=g.lm_lambda0, lm_step=g.lm_step,
                loop_mask=loop_mask, dcs_phi=g.dcs_phi,
            )
        return optimize_pose_graph(
            self.map.graph, g.max_iters, g.lm_lambda0, g.lm_step,
            loop_mask=loop_mask, dcs_phi=g.dcs_phi,
        )

    def _optimize(self):
        with self.timer.region("optimize"):
            poses, chi2, iters = self._optimize_dispatch()
        self.map = self.map.with_optimized(poses)
        self._opt_poses_host = None
        return float(chi2), int(iters)

    # ------------------------------------------------------------ process

    def process(self, raw) -> dict:
        """Process one raw rig capture.  The common healthy-tracking case
        runs the fused tracked frame (front end + PbMap + motion-model
        seeded dense solve, one fetch of both results); every other case
        (first frame, lost, config mismatch) takes the split path.

        DEFERRED-COMPLETION SEMANTICS: with `async_kf_events=True` (the
        default), the returned event dict for a keyframe frame is a LIVE
        object: `loop_closures`, `connections`, `chi2`, `optimized` and
        `kf_dispatches` are filled in on later frames as the deferred
        event's phases complete (and by `flush()`).  A consumer that needs
        final numbers reads the aggregate counters (`n_loop_closures`) or
        inspects events only after `flush()`."""
        # deferred keyframe-event phases advance in process_state, AFTER
        # this frame's own work is enqueued
        if (
            self.current_kf >= 0
            and not self.lost
            and self.kf_state is not None
            and self.track_rel is not None
            and self.config.dense == self.builder.config.dense
        ):
            frame = RigFrame.from_raw(raw, self.device)
            seed = self.track_rel @ self.last_step
            with self.timer.region("fused_track"):
                sphere, pyr, planes = self.builder.build_full(frame, self.timer)
                pb = self.plane_reg.register(self.kf_state.planes, planes, mode=PLANAR_3DOF)
                res = self.aligner.align(pyr, self.kf_state.pyramid, seed, method=D.PHOTO_DEPTH)
                pb, res = fetch((pb, res))
            state = FrameState(sphere=sphere, pyramid=pyr, planes=planes)
            return self.process_state(state, _pre=(pb, seed, res))
        return self.process_state(self.make_state(raw))

    def _relocalize(self, state: FrameState):
        """After tracking loss: scan the map for the frame's planes, then
        verify the plane-only hypothesis with a dense solve before trusting
        it (the reference accepts on >=5 matched planes alone, which
        aliases in self-similar spaces).  Gates mirror the loop-closure
        acceptance.  Returns (keyframe, T_kf<-frame) or None."""
        # relocalization scans the map: apply any deferred event first
        self._drain_pending()
        r = self.relocalizer.relocalize(self.map, state.planes)
        if not r.success:
            return None
        kf_pyr = self.loop_closer.kf_pyramid(self.map, r.kf, self._kf_pyr_cache)
        ok = lambda res: self.loop_closer.gates_ok(res, self._ref_photo)  # noqa: E731
        res = fetch(self.aligner.align(state.pyramid, kf_pyr, r.pose, method=D.PHOTO_DEPTH))
        if ok(res):
            return r.kf, res.pose.numpy()
        # The plane hypothesis is heading-aliased.  The true pose relates
        # to the alias by the environment's symmetry, a rotation about an
        # axis we don't know, so sweep THREE yaw-hypothesis families
        # (left-composed, right-composed, and pure yaw about the KF) in one
        # coarsest-level batch, then dense-verify the best few.
        yaws = se3.yaw_grid(16)
        pb = np.asarray(r.pose)[None]
        cands = np.concatenate([yaws @ pb, pb @ yaws, yaws])
        refined, errs = fetch(self.aligner.coarse_align(state.pyramid, kf_pyr, cands))
        refined, errs = refined.numpy(), errs.numpy()
        for i in np.argsort(errs)[:3]:
            cand = fetch(
                self.aligner.align(state.pyramid, kf_pyr, refined[i], method=D.PHOTO_DEPTH)
            )
            if ok(cand):
                return r.kf, cand.pose.numpy()
        return None  # reject: stay lost, try again next frame

    def _mark_lost(self, ev: dict) -> None:
        self.lost = True
        ev["lost"] = True
        self.track_rel = None
        self.last_step = np.eye(4)
        self._last_frame = None

    def process_state(self, state: FrameState, _pre=None) -> dict:
        kf_cfg = self.config.kf
        self._poll_pending()
        ev: dict = {"keyframe": False, "loop_closures": 0, "relocalized": False}

        if self.current_kf < 0:  # first frame seeds the map
            self._add_keyframe(state, np.eye(4))
            ev["keyframe"] = True
            return self._emit(ev)

        if self.lost:
            found = self._relocalize(state)
            ev["relocalized"] = found is not None
            if found is None:
                return self._emit(ev)
            kf_r, rel_r = found  # dense-refined T_kf<-frame
            self.current_kf = kf_r
            self.kf_state = None  # pyramid of that KF rebuilt below
            self.pose = self._opt_pose(kf_r) @ rel_r
            self.lost = False
            self.track_rel = rel_r
            self.last_step = np.eye(4)

        # reference keyframe pyramids (cached; rebuilt from the map payload
        # only after relocalization to an old keyframe, or a resume)
        if self.kf_state is None:
            kf_pyr = self.loop_closer.kf_pyramid(self.map, self.current_kf, self._kf_pyr_cache)
            kf_planes = type(self.map.planes)(**{
                f.name: getattr(self.map.planes, f.name)[self.current_kf]
                for f in dataclasses.fields(self.map.planes)
            })
        else:
            kf_pyr = self.kf_state.pyramid
            kf_planes = self.kf_state.planes

        # plane fast path (reference KFsphere_SLAM.cpp:314,354-366); the
        # fused tracked frame already computed it for the common case
        if _pre is not None:
            pb = _pre[0]
        else:
            with self.timer.region("register_pbmap"):
                pb = fetch(self.plane_reg.register(kf_planes, state.planes, mode=PLANAR_3DOF))
        kf_pose = self._opt_pose(self.current_kf)

        # dense tracking: T_kf<-new (reference :370-373); seed chain =
        # constant-velocity prediction, then the PbMap pose
        seeds = []
        if self.track_rel is not None:
            seeds.append(self.track_rel @ self.last_step)
        if bool(pb.success):
            seeds.append(pb.pose.numpy())
        with self.timer.region("register_dense"):
            res = self.align_with_fallback(
                state.pyramid, kf_pyr, seeds, prev_rel=self.track_rel,
                pre=None if _pre is None else (_pre[1], _pre[2]),
            )
        rel = res.pose.numpy()
        depth_res = float(res.av_depth_residual)
        ev["av_depth_residual"] = depth_res
        ev["sso"] = float(res.sso)
        ev["pb_matches"] = int(pb.n_matches)

        step = rel if self.track_rel is None else np.linalg.inv(self.track_rel) @ rel
        continuous = is_motion_continuous(
            step, kf_cfg.max_translation_odometry, kf_cfg.max_rotation_odometry
        )
        # catastrophic-residual gate: a failed solve can stay near its seed
        # (the step looks continuous) while explaining nothing of the scene,
        # e.g. after a teleport (KeyframeConfig.lost_residual_factor)
        lost_gate = kf_cfg.lost_residual_factor * self.config.lc.max_depth_residual
        if bool(res.ill_posed) or not continuous or depth_res > lost_gate:
            self._mark_lost(ev)
            return self._emit(ev)

        self.pose = kf_pose @ rel
        if self.track_rel is not None:
            self.last_step = np.linalg.inv(self.track_rel) @ rel
        self.track_rel = rel.copy()

        if self._keep_tracking(state, rel, res, depth_res):
            return self._emit(ev)

        # ---- keyframe promotion (reference :516-633).  The tracked
        # residual crossed the threshold, i.e. the CURRENT alignment is
        # already degraded, so promote the LAST well-tracked frame as the
        # keyframe and re-track this frame against it: every KF enters the
        # map at a pose measured by a healthy solve (the reference promotes
        # the degraded frame itself).
        lf = self._last_frame
        if (
            lf is not None
            and float(np.linalg.norm(lf["rel"][:3, 3])) >= kf_cfg.min_dist_keyframes
        ):
            prev_kf = self.current_kf
            # T_newKF<-frame composed from two already-fetched healthy
            # solves (lf's and this frame's): the re-track seed
            seed = np.linalg.inv(lf["rel"]) @ rel
            k, _ = self._promote(
                lf["state"], kf_pose @ lf["rel"], prev_kf,
                [(lf["rel"], lf["hessian"], lf["sso"], False)], ev,
            )
            if lf["state"] is state:
                # the current frame itself was the healthy candidate
                # (rotation-triggered promotion): it IS the new keyframe
                self.pose = self._opt_pose(k)
                self.track_rel = np.eye(4)
                return self._emit(ev)
            kf_pose = self._opt_pose(k)
            # common case: the composed pose sits comfortably inside the
            # keyframe thresholds; REUSE it instead of a synchronous
            # re-track against the new keyframe.  The next frame's track
            # against the new KF, seeded by exactly this composition,
            # measures the alignment.
            if (
                float(np.linalg.norm(seed[:3, 3])) < kf_cfg.min_dist_keyframes
                and rotation_angle_np(seed) < kf_cfg.max_rotation_keyframes
            ):
                self.pose = kf_pose @ seed
                self.track_rel = seed.copy()  # frame-to-frame step unchanged
                return self._emit(ev)
            # rare: the frame is already beyond the keyframe thresholds vs
            # the FRESH keyframe; run the measured re-track (it may fall
            # through to promoting this frame too)
            with self.timer.region("register_dense"):
                res = self.align_with_fallback(
                    state.pyramid, lf["state"].pyramid, [seed], prev_rel=seed
                )
            rel = res.pose.numpy()
            depth_res = float(res.av_depth_residual)
            ev["av_depth_residual"] = depth_res
            rstep = np.linalg.inv(seed) @ rel
            ok = (
                not bool(res.ill_posed)
                and depth_res <= lost_gate
                and is_motion_continuous(
                    rstep, kf_cfg.max_translation_odometry, kf_cfg.max_rotation_odometry
                )
            )
            if not ok:
                self._mark_lost(ev)
                # optimization inside _post_keyframe may have shifted the
                # map; sample this frame's trajectory entry in the SAME
                # (optimized) frame as its neighbors
                self.pose = kf_pose @ seed
                return self._emit(ev)
            self.pose = kf_pose @ rel
            self.track_rel = rel.copy()  # frame-to-frame step unchanged
            if self._keep_tracking(state, rel, res, depth_res):
                return self._emit(ev)
            # still beyond the threshold even against the fresh KF: fall
            # through and promote the current frame too
            pb = None

        prev_kf = self.current_kf
        # dense odometry edge (T_prev<-new); info = dense Hessian; plus a
        # consistent PbMap edge when available (reference :547-554)
        promo_edges = [(rel, res.hessian.numpy(), float(res.sso), False)]
        if pb is not None and bool(pb.success):
            dpb = pb.pose.numpy()
            dt = np.linalg.norm(dpb[:3, 3] - rel[:3, 3])
            dr = rotation_angle_np(dpb[:3, :3].T @ rel[:3, :3])
            if dt < 0.1 and dr < np.deg2rad(5):
                promo_edges.append((dpb, pb.information.numpy(), float(res.sso), False))
        k, optimized = self._promote(state, self.pose, prev_kf, promo_edges, ev)
        if optimized:
            self.pose = self._opt_pose(k)
        return self._emit(ev)

    _connection_kernel = staticmethod(_connection_kernel)

    def _post_keyframe(self, state: FrameState, k: int, ev: dict) -> bool:
        """Per-new-keyframe map work: neighbor connections, loop-closure
        search, pose-graph optimization, topological partitioning, as a
        phased pipeline (`_kf_event_gen`).  With `kf.async_kf_events`
        (default) the pipeline is DEFERRED: later frames drain it via
        `_poll_pending`, so tracking does not wait for the event.
        Synchronous mode drains here and returns True when optimization ran
        (the caller refreshes poses read from the map afterwards); async
        always returns False: optimized poses apply on a later frame."""
        gen = self._kf_event_gen(state, k, ev)
        self._pending.append((gen, None, self._cur_counter, None))
        if self.config.kf.async_kf_events:
            self._poll_pending()
            return False
        self._drain_pending()
        return ev.get("optimized", False)

    def _kf_event_gen(self, state: FrameState, k: int, ev: dict):
        """Keyframe-event pipeline as a generator: each `yield` hands the
        device tensors the next phase needs to `_poll_pending`, which
        resumes the generator with their host values once they are ready
        (or at once when draining).  One code path serves both sync and
        async modes."""
        kf_cfg = self.config.kf

        # ---- phase A: connection-candidate selection + LC scan.
        # Connection candidates: nearby KFs of the SAME or a NEIGHBOR
        # topological area (reference KFsphere_SLAM.cpp:405-461); area
        # membership bounds the pool independent of map size; selection
        # runs on the device and a fixed slate comes back.
        kf_pose = self._opt_pose(k)
        m = self.map
        conn = _connection_kernel(
            m.opt_poses, m.n_kf, m.area, m.n_areas, m.graph.edges_ij, m.graph.emask,
            k, kf_cfg.connection_radius,
        )
        self._nd()
        scan = None
        if self._n_kf_host > 3:  # LC needs non-recent candidates
            with self.timer.region("loop_closure"):
                scan = self.loop_closer.scan_dispatch(m, state.planes, kf_pose, k)
            self._nd()
        # ---- phase B: host-filter both slates (ONE combined fetch, owned
        # by the poller); the batched dense aligns (connections) and
        # verifications (LC candidates)
        (top_i, top_ok, top_seeds), scan_f = yield (conn, scan)
        near = [
            (int(kf), seed.numpy())
            for kf, v, seed in zip(top_i, top_ok, top_seeds)
            if v
            and (int(kf), k) not in self._edge_set
            and (k, int(kf)) not in self._edge_set
        ]
        cands = near[: kf_cfg.max_connections]
        conn_res = None
        if cands:
            lv = self._conn_level
            pyrs = [
                D.pyramid_tail(
                    self.loop_closer.kf_pyramid(self.map, kf, self._kf_pyr_cache), lv
                )
                for kf, _ in cands
            ]
            conn_res = D.batch_align_targets_dispatch(
                self._conn_aligner, D.pyramid_tail(state.pyramid, lv), pyrs,
                [seed for _, seed in cands],
            )
            self._nd()
        lc_cand: list = []
        lc_pose: dict = {}
        verify_res = cand_pyrs = None
        if scan_f is not None:
            with self.timer.region("loop_closure"):
                lc_cand, lc_pose = self.loop_closer.select_host(scan_f)
                if lc_cand:
                    # the tracker's own (seam-masked) pyramid serves as
                    # the query: the front end already built it
                    verify_res, cand_pyrs = self.loop_closer.verify_dispatch(
                        self.map, state.pyramid, lc_cand, lc_pose, self._kf_pyr_cache
                    )
                    self._nd()
        # ---- phase C: gate fetched results (ONE combined fetch); rescue
        # failed LC candidates; add the edge slate in ONE update
        res_f, vf = yield (conn_res, verify_res)
        new_edges: list[tuple] = []
        n_connections = 0
        if res_f is not None:
            for i, (kf, _) in enumerate(cands):
                res2 = D._result_item(res_f, i)
                if (
                    not bool(res2.ill_posed)
                    and float(res2.av_depth_residual) < kf_cfg.max_connection_residual
                ):
                    new_edges.append(
                        (kf, k, res2.pose.numpy(), res2.hessian.numpy(), float(res2.sso), False)
                    )
                    n_connections += 1
        ev["connections"] = ev.get("connections", 0) + n_connections

        lcs = []
        failures = []
        if vf is not None:
            for i, kf in enumerate(lc_cand):
                res = D._result_item(vf, i)
                if self.loop_closer.gates_ok(res, self._ref_photo):
                    lcs.append(self.loop_closer.accept(res, kf, k))
                else:
                    failures.append((i, kf))
        # heading rescue for yaw-aliased plane seeds: ALL failed candidates
        # run their coarse-sweep + argmin + verify in ONE phase (one
        # combined fetch)
        if failures:
            res_rs = tuple(
                self.loop_closer.rescue_fused_dispatch(state.pyramid, cand_pyrs[i], lc_pose[kf])
                for i, kf in failures
            )
            self._nd(len(failures))
            res_rs_f = yield res_rs
            for (i, kf), res_r in zip(failures, res_rs_f):
                if self.loop_closer.gates_ok(res_r, self._ref_photo):
                    lcs.append(self.loop_closer.accept(res_r, kf, k))
        for lc in lcs:
            new_edges.append((lc.kf_from, lc.kf_to, lc.rel, lc.info, lc.sso, True))
        ev["loop_closures"] = ev.get("loop_closures", 0) + len(lcs)
        self.n_loop_closures += len(lcs)
        self._add_edges(new_edges)

        # ---- phase D: optimize whenever the graph gained a non-odometry
        # constraint; apply the optimized poses once the solve has
        # finished.  The periodic partition (reference :710-717, a host
        # spectral solve over the fetched SSO) shares D's wait point.
        optimized = bool(lcs or n_connections)
        # the event's OWN keyframe index decides the partition cadence (the
        # live count would drift when queued events complete late)
        partition_due = (k + 1) % self.config.map.partition_every_n_kf == 0
        sso_f = None
        if optimized:
            n0 = self._n_kf_host  # keyframes the solve covers
            with self.timer.region("optimize"):
                poses, chi2, _ = self._optimize_dispatch()
            self._nd()
            # the map is updated in place: the SSO matrix this event's
            # partition reads is the one of NOW, so it is cloned here (a
            # keyframe promoted before the next phase writes its edge's
            # entry into the map's)
            if partition_due:  # ONE combined fetch
                chi2_f, sso_f = yield (chi2, self.map.sso.clone())
            else:
                chi2_f = (yield (chi2,))[0]
            # apply only the first n0 poses: a keyframe promoted while the
            # solve was pending occupies a LATER slot, whose value in
            # `poses` is the pre-promotion padding
            if self._n_kf_host > n0:
                poses = torch.cat([poses[:n0], self.map.opt_poses[n0:]])
                self._nd()
            self.map = self.map.with_optimized(poses)
            self._opt_poses_host = None
            ev["chi2"] = float(chi2_f)
            ev["optimized"] = True
        elif partition_due:
            sso_f = (yield (self.map.sso.clone(),))[0]
        if partition_due:
            area, n_areas = partition_map(
                self.map, self.config.map.sso_partition_threshold,
                sso=sso_f, n_kf=self._n_kf_host,
            )
            self.map.area.copy_(torch.from_numpy(area))
            self.map.n_areas.fill_(n_areas)
            self._area_host = [int(a) for a in area[: self._n_kf_host]]
        # the generator body always runs under _advance_head with its own
        # counter swapped in, so this reads the event's exact dispatch count
        ev["kf_dispatches"] = self._cur_counter[0]
        self.kf_event_dispatches.append(self._cur_counter[0])
