"""Relocalization: find the current frame in the map after tracking loss
(twin of `rgbd360_tpu/slam/relocalizer.py`).

The reference brute-forces PbMap registration of the current frame against
all map keyframes newest-first, accepting at >=5 matched planes and matched
area > 10 (reference `include/Relocalizer360.h:78-93`).  Here the whole scan
is one batch over the stacked keyframe plane sets, and the newest-first
early exit becomes an argmax over a recency-weighted score."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import FrameworkConfig
from rgbd360_tpu_torch.ops.segmentation import PlaneSet
from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, match_against_keyframes
from rgbd360_tpu_torch.utils.host import fetch


@dataclass
class RelocalizationResult:
    success: bool
    kf: int
    pose: np.ndarray  # x_kf = pose @ x_query
    info: np.ndarray
    n_matches: int
    area_matched: float


class Relocalizer:
    def __init__(self, config: FrameworkConfig, mesh=None):
        """`mesh`: optional `parallel.sharded.Mesh`; the brute-force scan
        over all map keyframes then shards by keyframe index
        (`parallel.sharded.sharded_plane_scan`)."""
        self.config = config
        self.mesh = mesh

    def _batch_impl(self, map_planes: PlaneSet, query: PlaneSet, gate):
        if self.mesh is not None:
            from rgbd360_tpu_torch.parallel.sharded import sharded_plane_scan

            return sharded_plane_scan(
                self.mesh, map_planes, query, gate, self.config.matcher, PLANAR_3DOF
            )
        return match_against_keyframes(map_planes, query, gate, self.config.matcher)

    @staticmethod
    def _select(n_m, area, obs, pose, info, min_matches, min_area):
        """Device-side winner selection (newest first among acceptable
        hits); only the single winner's data crosses to the host.  The score
        is int32 arithmetic, as the reference's."""
        idx = torch.arange(n_m.shape[0], dtype=torch.int32, device=n_m.device)
        ok = obs & (n_m >= min_matches) & (area > min_area)
        score = torch.where(ok, n_m * 1000 + idx, torch.full_like(n_m, -1))
        k = torch.argmax(score).reshape(1)

        def at(x):
            return torch.index_select(x, 0, k)[0]

        return torch.any(ok), k[0], at(pose), at(info), at(n_m), at(area)

    def relocalize(self, map360, query_planes: PlaneSet) -> RelocalizationResult:
        n_kf = int(map360.n_kf)
        fail = RelocalizationResult(False, -1, np.eye(4), np.zeros((6, 6)), 0, 0.0)
        if n_kf == 0:
            return fail
        gate = torch.arange(map360.kf_capacity, device=map360.device) < n_kf
        n_m, area, pose, info, obs = self._batch_impl(map360.planes, query_planes, gate)
        rc = self.config.reloc
        any_ok, k, pose_k, info_k, n_k, area_k = fetch(
            self._select(n_m, area, obs, pose, info, rc.min_matches, rc.min_area)
        )
        if not bool(any_ok):
            return fail
        return RelocalizationResult(
            success=True,
            kf=int(k),
            pose=pose_k.numpy(),
            info=info_k.numpy(),
            n_matches=int(n_k),
            area_matched=float(area_k),
        )
