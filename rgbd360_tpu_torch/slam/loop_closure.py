"""Loop-closure detection over the keyframe map (twin of
`rgbd360_tpu/slam/loop_closure.py`).

For each new keyframe the candidate search is ONE batched computation: the
PbMap matcher runs over every keyframe of the map at once
(`registration.planes.match_against_keyframes`; the map's plane sets are
already stacked), distance- and area-gated with masks, and only the best few
survivors get the (expensive) dense verification.

The stages come in halves: a `*_dispatch` method enqueues device work and
returns tensors on the device without copying them to the host, so the
tracker's keyframe event can fetch them in a later phase; `search` is the
synchronous composition of the same halves.  (The dense solves read their
loop conditions on the host, so a dispatch half that solves does block
until its solve has converged.)
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import FrameworkConfig
from rgbd360_tpu_torch.ops import se3
from rgbd360_tpu_torch.ops.segmentation import PlaneSet
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, match_against_keyframes
from rgbd360_tpu_torch.slam.topological import (
    MAX_AREAS_DEVICE,
    _clamp_areas,
    area_adjacency_device,
    representative_mask_device,
)
from rgbd360_tpu_torch.utils.host import fetch


def top_k_stable(score: torch.Tensor, k: int):
    """(values, indices) of the k largest scores, the LOWER index first
    among equal scores (what XLA's `top_k` gives; `torch.topk` promises no
    order among ties): a stable descending sort."""
    values, idx = torch.sort(score, descending=True, stable=True)
    return values[:k], idx[:k]


def _gate_kernel(
    opt_poses, n_kf, area, n_areas, sso, edges_ij, emask,
    query_pose, query_kf, exclude_recent, radius, area_gating: bool,
):
    """Device-side candidate gate: distance + recency + area logic computed
    entirely on the device, so a keyframe event never pulls the O(capacity)
    pose array to the host."""
    n = opt_poses.shape[0]
    idx = torch.arange(n, device=opt_poses.device)
    live = idx < n_kf
    dist = torch.linalg.norm(opt_poses[:, :3, 3] - query_pose[:3, 3], dim=1)
    gate = live & (dist < radius) & (idx < query_kf - exclude_recent)
    if area_gating:
        cap = min(n, MAX_AREAS_DEVICE)
        q = torch.clamp(torch.minimum(torch.as_tensor(query_kf, device=idx.device), n_kf - 1), min=0)
        q_area = area[q.long()]
        neigh = area_adjacency_device(area, edges_ij, emask, n)
        is_rep = representative_mask_device(sso, area, n_kf)
        same_area = area == q_area
        non_neigh = ~neigh[_clamp_areas(q_area, cap)][_clamp_areas(area, cap)]
        # unpartitioned (n_areas <= 1): plain radius scan
        gate = gate & ((n_areas <= 1) | same_area | (non_neigh & is_rep))
    return gate


def candidate_gate(map360, query_pose, query_kf: int, exclude_recent: int, lc_cfg):
    """Boolean candidate mask for loop-closure search (padded length, on the
    map's device).

    Area-driven, mirroring the reference's loop-closure thread
    (`include/LoopClosure360.h:289-366`): keyframes of the query's OWN
    topological area within the search radius, plus the representative
    keyframe of every NON-neighbor area in radius.  Neighbor-area keyframes
    are covered by the tracker's connection search.  Until the map has been
    partitioned (one area), degrades to the plain radius scan."""
    return _gate_kernel(
        map360.opt_poses, map360.n_kf, map360.area, map360.n_areas, map360.sso,
        map360.graph.edges_ij, map360.graph.emask,
        torch.as_tensor(query_pose, dtype=torch.float32, device=map360.device),
        query_kf, exclude_recent, lc_cfg.search_radius,
        area_gating=bool(lc_cfg.area_gating),
    )


def _select_candidates(n_m, area, obs, pose, min_matches, min_area, k: int):
    """Device-side survivor selection: the top-k candidates by match count
    among those passing the LC gates (equal counts: the older keyframe
    first); only O(k) data crosses to the host."""
    ok = obs & (n_m >= min_matches) & (area > min_area)
    score = torch.where(ok, n_m, torch.full_like(n_m, -1))
    top_scores, top_idx = top_k_stable(score, k)
    return top_idx, top_scores > 0, pose[top_idx]


@dataclass
class LoopClosure:
    """One accepted loop closure."""

    kf_from: int
    kf_to: int
    rel: np.ndarray  # x_from = rel @ x_to
    info: np.ndarray
    sso: float
    depth_residual: float


class LoopCloser:
    def __init__(self, config: FrameworkConfig, mesh=None):
        """`mesh`: optional `parallel.sharded.Mesh`.  When given, the batch
        plane matcher runs keyframe-sharded over its ranks
        (`parallel.sharded.sharded_plane_scan`, the results gathered on
        every rank); the map's keyframe capacity must divide by the mesh
        size (Map360's power-of-two capacities stay divisible as the map
        grows)."""
        self.config = config
        self.mesh = mesh
        verify_cfg = (
            dataclasses.replace(
                config.dense,
                salient_pixels=config.lc.verify_salient_pixels,
                # polish is mandatory with thinned verify sweeps: without
                # it borderline closures fail the depth gate
                polish_iters=max(2, config.dense.polish_iters),
            )
            if config.lc.verify_salient_pixels > 0
            else config.dense
        )
        self._aligner = D.DenseAligner(verify_cfg)

    def _pyr(self, gray, depth):
        """The alignment pyramid of a stored sphere: no seam masks (the
        uniform seam columns are masked instead)."""
        return D.build_frame_pyramid(gray, depth, self.config.dense)

    def _scan_select_impl(
        self, query, map_planes, opt_poses, n_kf, area, n_areas, sso,
        edges_ij, emask, query_pose, query_kf, exclude_recent, radius,
        min_matches, min_area, area_gating: bool, k: int,
    ):
        """Gate + batch plane match + top-k survivor selection, all on the
        device: a keyframe event makes one O(k) fetch here."""
        gate = _gate_kernel(
            opt_poses, n_kf, area, n_areas, sso, edges_ij, emask,
            query_pose, query_kf, exclude_recent, radius, area_gating=area_gating,
        )
        n_m, area_m, pose, info, obs = self._batch_match_impl(query, map_planes, gate)
        return _select_candidates(n_m, area_m, obs, pose, min_matches, min_area, k)

    def _batch_match_impl(self, query: PlaneSet, map_planes: PlaneSet, gate):
        """The plane matcher over all keyframes; per keyframe (n_matches,
        matched_area, pose, info, observable)."""
        if self.mesh is not None:
            from rgbd360_tpu_torch.parallel.sharded import sharded_plane_scan

            return sharded_plane_scan(
                self.mesh, map_planes, query, gate, self.config.matcher, PLANAR_3DOF
            )
        return match_against_keyframes(map_planes, query, gate, self.config.matcher)

    def kf_pyramid(self, map360, k: int, cache: dict | None = None, timer=None):
        """Alignment pyramid of keyframe k, rebuilt from the map's bfloat16
        payload (no seam masks); memoized in `cache` (keyframe payloads do
        not change once added).  With a `timer` (`utils.trace.StageTimer`),
        a lookup counts as `kf_pyramid.hit` or `kf_pyramid.miss` and a
        rebuild is a `kf_pyramid` span."""
        hit = cache is not None and k in cache
        if timer is not None:
            timer.counts["kf_pyramid.hit" if hit else "kf_pyramid.miss"] += 1
        if hit:
            return cache[k]
        with contextlib.nullcontext() if timer is None else timer.region("kf_pyramid", kf=int(k)):
            pyr = self._pyr(map360.gray[k].to(torch.float32), map360.depth[k].to(torch.float32))
        if cache is not None:
            cache[k] = pyr
        return pyr

    # ----------------------------------------------------- deferred halves

    def scan_dispatch(
        self,
        map360,
        query_planes: PlaneSet,
        query_pose,
        query_kf: int,
        exclude_recent: int = 2,
        max_dense_checks: int | None = None,
        n_kf_snapshot: int | None = None,
        n_edges_snapshot: int | None = None,
    ):
        """Gate + batch plane match + top-k select; returns the (top_idx,
        top_ok, top_pose) tensors on the device without fetching.

        `n_kf_snapshot` / `n_edges_snapshot`: keyframe/edge counts at the
        EVENT's creation.  A deferred event's scan may run after later
        keyframes joined the map; recency gating already excludes them as
        candidates, but the representative-mask and area-adjacency helpers
        would otherwise see the larger set and diverge from the synchronous
        pipeline: the caps restore the snapshot the synchronous scan sees."""
        lc_cfg = self.config.lc
        if max_dense_checks is None:
            max_dense_checks = lc_cfg.max_dense_checks
        n_kf = map360.n_kf
        emask = map360.graph.emask
        if n_kf_snapshot is not None:
            n_kf = torch.clamp(n_kf, max=n_kf_snapshot)
        if n_edges_snapshot is not None:
            emask = emask & (torch.arange(emask.shape[0], device=emask.device) < n_edges_snapshot)
        return self._scan_select_impl(
            query_planes, map360.planes, map360.opt_poses, n_kf, map360.area,
            map360.n_areas, map360.sso, map360.graph.edges_ij, emask,
            torch.as_tensor(query_pose, dtype=torch.float32, device=map360.device),
            query_kf, exclude_recent, lc_cfg.search_radius, lc_cfg.min_matches,
            lc_cfg.min_area, area_gating=bool(lc_cfg.area_gating), k=max_dense_checks,
        )

    @staticmethod
    def select_host(fetched) -> tuple[list[int], dict]:
        """Host half of candidate selection: fetched (top_idx, top_ok,
        top_pose) -> (candidate kf list, {kf: seed pose})."""
        top_idx, top_ok, top_pose = (np.asarray(x) for x in fetched)
        cand = [int(i) for i, v in zip(top_idx, top_ok) if v]
        cand_pose = {int(i): p for i, v, p in zip(top_idx, top_ok, top_pose) if v}
        return cand, cand_pose

    def verify_dispatch(self, map360, q_pyr, cand, cand_pose, pyr_cache=None, timer=None):
        """The batched dense verification of all candidates; returns (the
        result batch on the device, candidate pyramids).  Seeds: the plane
        pose maps x_kf = T x_query and align(query, kf) optimizes exactly
        that T_kf<-query.  `timer`: see `kf_pyramid`."""
        cand_pyrs = [self.kf_pyramid(map360, int(k), pyr_cache, timer) for k in cand]
        res_b = D.batch_align_targets_dispatch(
            self._aligner, q_pyr, cand_pyrs, [cand_pose[int(k)] for k in cand]
        )
        return res_b, cand_pyrs

    def gates_ok(self, res, ref_photo: float | None) -> bool:
        """Acceptance gates on a FETCHED verify result (depth residual,
        reference `LoopClosure360.h:311-316`; the photometric gate is beyond
        the reference)."""
        lc_cfg = self.config.lc
        photo_ok = (
            lc_cfg.max_photo_ratio is None
            or ref_photo is None
            or float(res.av_photo_residual)
            < max(lc_cfg.max_photo_ratio * ref_photo, lc_cfg.photo_gate_floor)
        )
        return (
            float(res.av_depth_residual) < lc_cfg.max_depth_residual
            and photo_ok
            and not bool(res.ill_posed)
        )

    def _yaw_candidates(self, q_pyr, seed_pose):
        cands = se3.yaw_grid(16) @ np.asarray(seed_pose, np.float64)[None]
        return torch.as_tensor(cands, dtype=torch.float32, device=q_pyr.gray[0].device)

    def rescue_fused_dispatch(self, q_pyr, kf_pyr, seed_pose):
        """The heading rescue without a fetch in the middle: the 16-yaw
        coarse sweep, the device-side argmin over the post-refinement
        errors, and the full verify from the best hypothesis."""
        refined, errs = self._aligner.coarse_align(
            q_pyr, kf_pyr, self._yaw_candidates(q_pyr, seed_pose),
            method=D.PHOTO_DEPTH, iters=10,
        )
        best = torch.argmin(errs)
        return self._aligner.align(
            q_pyr, kf_pyr, torch.index_select(refined, 0, best.reshape(1))[0],
            method=D.PHOTO_DEPTH,
        )

    @staticmethod
    def accept(res, kf_from: int, query_kf: int) -> "LoopClosure":
        return LoopClosure(
            kf_from=int(kf_from),
            kf_to=int(query_kf),
            rel=np.asarray(res.pose),
            info=np.asarray(res.hessian),
            sso=float(res.sso),
            depth_residual=float(res.av_depth_residual),
        )

    def gate_and_rescue(self, verified, q_pyr, cand, cand_pose, cand_pyrs, query_kf: int,
                        ref_photo: float | None):
        """Gate the FETCHED verify batch `verified` of candidates `cand`
        (None: no candidates); every candidate that fails gets the heading
        rescue (`rescue_fused_dispatch`, from its plane seed in `cand_pose`
        against its pyramid in `cand_pyrs`), all of them yielded as ONE
        tuple to fetch, and the fetched results are gated in turn.  Returns
        (the accepted closures, the first pass's in candidate order and then
        the rescues' in failure order; the number of rescues dispatched).
        A generator: a tracker's keyframe event yields from it, `search`
        runs it at once."""
        if verified is None:
            return [], 0
        out: list[LoopClosure] = []
        failures = []
        for i, kf in enumerate(cand):
            res = D._result_item(verified, i)
            if self.gates_ok(res, ref_photo):
                out.append(self.accept(res, kf, query_kf))
            else:
                failures.append((i, kf))
        if failures:
            rescued = yield tuple(
                self.rescue_fused_dispatch(q_pyr, cand_pyrs[i], cand_pose[kf]) for i, kf in failures
            )
            for (i, kf), res in zip(failures, rescued):
                if self.gates_ok(res, ref_photo):
                    out.append(self.accept(res, kf, query_kf))
        return out, len(failures)

    def search(
        self,
        map360,
        query_planes: PlaneSet,
        query_gray: torch.Tensor,
        query_depth: torch.Tensor,
        query_pose,
        query_kf: int,
        exclude_recent: int = 2,
        max_dense_checks: int | None = None,
        pyr_cache: dict | None = None,
        ref_photo: float | None = None,
        q_pyr=None,
    ) -> list[LoopClosure]:
        """Find loop closures for a (new) keyframe: the area-driven
        candidate scan (see `candidate_gate`), then dense verification of
        the survivors with the depth and photometric gates and, for a
        candidate that fails them, the heading rescue.

        `ref_photo` is the tracker's current photometric residual; with
        `lc.max_photo_ratio` set, candidates whose verified photometric
        residual exceeds `max_photo_ratio * ref_photo` are rejected
        (geometry-only acceptance is blind to rotational aliasing in
        near-symmetric spaces).  `q_pyr`: the query's alignment pyramid when
        the caller already built it."""
        n_kf = int(map360.n_kf)
        if n_kf <= exclude_recent + 1:
            return []
        cand, cand_pose = self.select_host(
            fetch(
                self.scan_dispatch(
                    map360, query_planes, query_pose, query_kf,
                    exclude_recent, max_dense_checks,
                )
            )
        )
        if not cand:
            return []

        if q_pyr is None:
            q_pyr = self._pyr(query_gray, query_depth)
        res_b, cand_pyrs = self.verify_dispatch(map360, q_pyr, cand, cand_pose, pyr_cache)
        step = self.gate_and_rescue(
            fetch(res_b), q_pyr, cand, cand_pose, cand_pyrs, query_kf, ref_photo
        )
        try:  # a yield holds the rescues of the candidates that failed
            step.send(fetch(next(step)))
        except StopIteration as done:
            out, _ = done.value
        order = {int(k): n for n, k in enumerate(cand)}
        return sorted(out, key=lambda c: order[c.kf_from])
