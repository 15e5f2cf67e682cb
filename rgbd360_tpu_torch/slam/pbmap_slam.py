"""PbMap-tracking graph SLAM (the reference `SLAM/SphereGraphSLAM.cpp`;
twin of `rgbd360_tpu/slam/pbmap_slam.py`).

Every frame is tracked by sparse plane registration (PLANAR_ODOMETRY_3DOF)
against up to `track_depth` recent keyframes (reference `:175-244` tries up
to 5 previous KFs before declaring loss), every successfully tracked frame
joins the map as a keyframe with an SSO entry, loop closures come from the
batched LoopCloser, and the topological partitioner runs periodically.

The loop-closure search, pose-graph optimization and partition of each
keyframe run as an event on the deferred keyframe-event engine of
`TrackerBase` (the reference's background loop-closure thread,
`SLAM/SphereGraphSLAM.cpp:141`, `include/LoopClosure360.h:93,108`): with
`kf.async_kf_events` (default) a keyframe frame only DISPATCHES the scan,
and verification, edges, optimization and partitioning complete over later
frames; synchronous mode drains inline.

The map is updated in place (`slam/map.py`), so what an event keeps across
a later update it clones (the SSO snapshot of its partition) or applies as
a prefix (the optimized poses of the keyframes its solve covered).  Every
tracked frame is a keyframe here, so the keyframe pyramid cache holds one
pyramid per frame on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_tpu_torch.config import FrameworkConfig
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration.planes import PLANAR_ODOMETRY_3DOF
from rgbd360_tpu_torch.slam.graph import optimize_pose_graph
from rgbd360_tpu_torch.slam.loop_closure import LoopCloser
from rgbd360_tpu_torch.slam.map import Map360
from rgbd360_tpu_torch.slam.odometry import (
    TrackerBase,
    graph_solve_region,
    is_motion_continuous,
    traced_frame,
)
from rgbd360_tpu_torch.utils.host import fetch


class PbMapGraphSLAM(TrackerBase):
    def __init__(
        self,
        builder: FrameBuilder,
        config: FrameworkConfig | None = None,
        track_depth: int = 5,
    ):
        super().__init__(builder, config)
        cfg = self.config
        self.track_depth = track_depth
        self.map = Map360.empty(
            cfg.map, cfg.sphere.height, cfg.sphere.width, cfg.seg.max_planes,
            cfg.seg.hull_dirs, self.device,
        )
        self.loop_closer = LoopCloser(cfg)
        self.trajectory: list[np.ndarray] = []
        self.no_assoc = 0
        self.n_loop_closures = 0
        self.events: list[dict] = []
        # host mirrors: reading `int(map.n_kf)` or a pose waits for every
        # queued launch, the deferred event's too
        self._n_kf_host = 0
        self._n_edges_host = 0
        self._opt_poses_host: np.ndarray | None = None
        self._kf_pyr_cache: dict = {}

    def _opt_pose(self, k: int) -> np.ndarray:
        if self._opt_poses_host is None:
            self._opt_poses_host = self.map.opt_poses.cpu().numpy()
        return self._opt_poses_host[k]

    def _add_kf(self, state, pose: np.ndarray) -> int:
        k = self._n_kf_host
        self.map = self.map.add_keyframe(
            pose, state.sphere.sphere_gray, state.sphere.sphere_depth, state.planes, n_live=k,
        )
        self._nd()
        self._n_kf_host = k + 1
        if self._opt_poses_host is not None and k < len(self._opt_poses_host):
            self._opt_poses_host[k] = np.asarray(pose)
        else:
            self._opt_poses_host = None
        self._kf_pyr_cache[k] = state.pyramid
        return k

    @traced_frame
    def process(self, raw) -> dict:
        return self.process_state(self.make_state(raw))

    def process_state(self, state) -> dict:
        """One frame.  DEFERRED-COMPLETION SEMANTICS (async mode, default):
        the returned event dict's `loop_closures`/`chi2`/`optimized` fields
        are filled in on later frames as the deferred event's phases
        complete (and by `flush()`); read the aggregate
        `self.n_loop_closures` for always-current totals."""
        ev = {"keyframe": False, "tracked": False, "loop_closures": 0}
        self._poll_pending()
        n_kf = self._n_kf_host
        if n_kf == 0:
            self._add_kf(state, np.eye(4))
            self.trajectory.append(np.eye(4))
            ev.update(keyframe=True, tracked=True)
            self.events.append(ev)
            return ev

        # track against up to `track_depth` most recent keyframes
        kf_cfg = self.config.kf
        planes_area = torch.sum(torch.where(state.planes.valid, state.planes.area, 0.0))
        matched = None
        for back in range(1, min(self.track_depth, n_kf) + 1):
            ref_kf = n_kf - back
            kf_planes = self.map.planes.map(lambda name, a: a[ref_kf])
            with self.timer.region("register_pbmap"):
                pb, area = fetch((
                    self.plane_reg.register(kf_planes, state.planes, mode=PLANAR_ODOMETRY_3DOF),
                    planes_area,
                ))
            if bool(pb.success):
                rel = pb.pose.numpy().astype(np.float64)
                if is_motion_continuous(
                    rel, kf_cfg.max_translation_odometry, kf_cfg.max_rotation_odometry
                ):
                    matched = (ref_kf, pb, rel, float(area))
                    break
        if matched is None:
            self.no_assoc += 1
            self.trajectory.append(self.trajectory[-1] if self.trajectory else np.eye(4))
            self.events.append(ev)
            return ev

        ref_kf, pb, rel, area = matched
        pose = self._opt_pose(ref_kf) @ rel
        self._event_backpressure()
        self._cur_counter = [0]
        k = self._add_kf(state, pose)
        sso = float(pb.area_matched) / max(area, 1e-6)
        self.map = self.map.add_edge(
            ref_kf, k, pb.pose, pb.information, sso=min(sso, 1.0), n_live=self._n_edges_host,
        )
        self._nd()
        self._n_edges_host += 1
        ev.update(keyframe=True, tracked=True, ref_kf=ref_kf, matches=int(pb.n_matches))

        gen = self._kf_event_gen(state, k, np.asarray(pose), ev, n_edges_snapshot=self._n_edges_host)
        self._enqueue_event(gen, k)
        if self.config.kf.async_kf_events:
            self._poll_pending()
        else:
            self._drain_pending("sync")
            if ev.get("optimized"):
                pose = self._opt_pose(k)

        self.trajectory.append(np.asarray(pose))
        self.events.append(ev)
        return ev

    def _kf_event_gen(self, state, k: int, kf_pose: np.ndarray, ev: dict,
                      n_edges_snapshot: int | None = None):
        """The SphereGraphSLAM keyframe event: LC scan -> verify -> edges ->
        optimize -> partition, as a phased generator on the shared deferred
        engine (the reference's LC thread body, `LoopClosure360.h:108-366`,
        and the app's inline optimize).  The snapshot caps pin the scan to
        the map state the event was created against, so the deferred scan
        matches the synchronous one exactly (see `scan_dispatch`).  Its
        phases are named after `KeyframeSLAM`'s (A scan, B verify, C gate,
        rescue, D optimize and partition)."""
        lc = self.loop_closer
        timer = self.timer

        # ---- phase A: dispatch the LC candidate scan (device-side gate,
        # batched plane match, top-k select)
        scan = None
        # event-indexed condition (k is fixed at creation; _n_kf_host may
        # have advanced by the time a deferred generator body runs)
        if k + 1 > 3:  # the scan excludes the 2 most recent KFs
            with timer.region("loop_closure"):
                scan = lc.scan_dispatch(
                    self.map, state.planes, kf_pose, k,
                    n_kf_snapshot=k + 1, n_edges_snapshot=n_edges_snapshot,
                )
            self._nd()
        # ---- phase B: host-filter candidates; dispatch batched dense
        # verification (the fetch is owned by the poller)
        self._event_phase = "B"
        scan_f = (yield (scan,))[0]
        lc_cand: list = []
        lc_pose: dict = {}
        verify_res = cand_pyrs = None
        if scan_f is not None:
            with timer.region("loop_closure"):
                lc_cand, lc_pose = lc.select_host(scan_f)
                if lc_cand:
                    verify_res, cand_pyrs = lc.verify_dispatch(
                        self.map, state.pyramid, lc_cand, lc_pose, self._kf_pyr_cache, timer,
                    )
                    self._nd()
        # ---- phase C: gate, rescue yaw-aliased seeds, add accepted edges
        self._event_phase = "C"
        vf = (yield (verify_res,))[0]
        lcs = []
        failures = []
        if vf is not None:
            for i, kf in enumerate(lc_cand):
                res = D._result_item(vf, i)
                if lc.gates_ok(res, None):
                    lcs.append(lc.accept(res, kf, k))
                else:
                    failures.append((i, kf))
        # all failed candidates rescue in ONE phase: the fused coarse sweep,
        # device-side argmin and verify per candidate, one combined fetch
        if failures:
            res_rs = tuple(
                lc.rescue_fused_dispatch(state.pyramid, cand_pyrs[i], lc_pose[kf])
                for i, kf in failures
            )
            self._nd(len(failures))
            self._event_phase = "rescue"
            res_rs_f = yield res_rs
            for (i, kf), res_r in zip(failures, res_rs_f):
                if lc.gates_ok(res_r, None):
                    lcs.append(lc.accept(res_r, kf, k))
        for lc_ in lcs:
            self.map = self.map.add_edge(
                lc_.kf_from, lc_.kf_to, lc_.rel, lc_.info, sso=lc_.sso, is_loop=True,
                n_live=self._n_edges_host,
            )
            self._nd()
            self._n_edges_host += 1
        ev["loop_closures"] = ev.get("loop_closures", 0) + len(lcs)
        self.n_loop_closures += len(lcs)

        # ---- phase D: optimize on new loop closures; periodic partition
        # (the map is updated in place: the SSO the partition reads is
        # cloned at the yield, see `_apply_partition`)
        partition_due = (k + 1) % self.config.map.partition_every_n_kf == 0
        sso_f = None
        if lcs:
            g = self.config.graph
            n0 = self._n_kf_host  # keyframes the dispatched solve covers
            with graph_solve_region(timer, n0, g.dtype):
                poses, chi2, _ = optimize_pose_graph(
                    self.map.graph, g.max_iters, g.lm_lambda0, g.lm_step,
                    loop_mask=self.map.edge_is_lc if g.robust_lc else None,
                    dcs_phi=g.dcs_phi, dtype=g.dtype,
                )
            self._nd()
            self._event_phase = "D"
            if partition_due:  # one combined fetch
                chi2_f, sso_f = yield (chi2, self.map.sso.clone())
            else:
                chi2_f = (yield (chi2,))[0]
            # prefix-safe application: keyframes promoted while the solve
            # was in flight occupy later slots the solve never covered
            if self._n_kf_host > n0:
                poses = torch.cat([poses[:n0], self.map.opt_poses[n0:].to(poses.dtype)])
                self._nd()
            self.map = self.map.with_optimized(poses)
            self._opt_poses_host = None
            ev["chi2"] = float(chi2_f)
            ev["optimized"] = True
        elif partition_due:
            self._event_phase = "D"
            sso_f = (yield (self.map.sso.clone(),))[0]
        if partition_due:
            self._apply_partition(sso_f)
        ev["kf_dispatches"] = self._cur_counter[0]
        self.kf_event_dispatches.append(self._cur_counter[0])
