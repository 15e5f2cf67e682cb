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
frames; synchronous mode drains inline.  The event's generator keeps what
is this tracker's own (the scan's condition, pose and snapshots); its
verification, gate and rescue, graph update and partition are the steps
`KeyframeSLAM`'s event runs too (`odometry.MapTrackerBase`,
`LoopCloser.gate_and_rescue`).

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
from rgbd360_tpu_torch.registration.planes import PLANAR_ODOMETRY_3DOF
from rgbd360_tpu_torch.slam.graph import optimize_pose_graph
from rgbd360_tpu_torch.slam.loop_closure import LoopCloser
from rgbd360_tpu_torch.slam.odometry import MapTrackerBase, is_motion_continuous, traced_frame
from rgbd360_tpu_torch.utils.host import fetch


class PbMapGraphSLAM(MapTrackerBase):
    def __init__(
        self,
        builder: FrameBuilder,
        config: FrameworkConfig | None = None,
        track_depth: int = 5,
    ):
        super().__init__(builder, config)
        self.track_depth = track_depth
        self.loop_closer = LoopCloser(self.config)
        self.no_assoc = 0

    def _solve_graph(self):
        """The pose-graph solve: dense LM at the configuration's precision
        (`graph.dtype`); (poses, chi2, iterations) on the device."""
        g = self.config.graph
        return optimize_pose_graph(
            self.map.graph, g.max_iters, g.lm_lambda0, g.lm_step,
            loop_mask=self.map.edge_is_lc if g.robust_lc else None,
            dcs_phi=g.dcs_phi, dtype=g.dtype,
        )

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
            self._add_keyframe(state, np.eye(4), 0)
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
        # every keyframe joins area 0 until a partition moves it
        k = self._add_keyframe(state, pose, 0)
        sso = float(pb.area_matched) / max(area, 1e-6)
        self._add_edges([(ref_kf, k, pb.pose, pb.information, min(sso, 1.0), False)])
        ev.update(keyframe=True, tracked=True, ref_kf=ref_kf, matches=int(pb.n_matches))

        gen = self._kf_event_gen(state, k, np.asarray(pose), ev, n_edges_snapshot=self._n_edges_host)
        if self._post_keyframe(gen, k, ev):
            pose = self._opt_pose(k)
        self.trajectory.append(np.asarray(pose))
        self.events.append(ev)
        return ev

    def _kf_event_gen(self, state, k: int, kf_pose: np.ndarray, ev: dict,
                      n_edges_snapshot: int | None = None):
        """The SphereGraphSLAM keyframe event: LC scan -> verify -> gate and
        rescue, then the shared graph update (`_graph_update`: closure edges,
        optimize, partition), as a phased generator on the shared deferred
        engine (the reference's LC thread body, `LoopClosure360.h:108-366`,
        and the app's inline optimize).  The snapshot caps pin the scan to
        the map state the event was created against, so the deferred scan
        matches the synchronous one exactly (see `scan_dispatch`).  Its
        phases are named after `KeyframeSLAM`'s (A scan, B verify, C gate,
        rescue, D optimize and partition); its closures meet no photometric
        gate."""
        # ---- phase A: dispatch the LC candidate scan (device-side gate,
        # batched plane match, top-k select)
        scan = None
        # event-indexed condition (k is fixed at creation; _n_kf_host may
        # have advanced by the time a deferred generator body runs)
        if k + 1 > 3:  # the scan excludes the 2 most recent KFs
            with self.timer.region("loop_closure"):
                scan = self.loop_closer.scan_dispatch(
                    self.map, state.planes, kf_pose, k,
                    n_kf_snapshot=k + 1, n_edges_snapshot=n_edges_snapshot,
                )
            self._nd()
        # ---- phase B: host-filter candidates; dispatch batched dense
        # verification (the fetch is owned by the poller)
        self._event_phase = "B"
        scan_f = (yield (scan,))[0]
        lc_cand, lc_pose, verify_res, cand_pyrs = self._verify_closures(state, scan_f)
        # ---- phase C: gate, rescue yaw-aliased seeds in ONE phase
        self._event_phase = "C"
        vf = (yield (verify_res,))[0]
        self._event_phase = "rescue"
        lcs, n_rescues = yield from self.loop_closer.gate_and_rescue(
            vf, state.pyramid, lc_cand, lc_pose, cand_pyrs, k, None
        )
        self._nd(n_rescues)
        # ---- phase D: optimize on new loop closures; periodic partition
        yield from self._graph_update(k, ev, [], lcs)
