"""Keyframe map state (twin of `rgbd360_tpu/slam/map.py`): keyframe spheres,
trajectory and optimized poses, the edge set, the SSO co-visibility matrix
and the topological areas, as padded tensors of fixed capacity on one
device, so every map-scale operation (loop-closure search, relocalisation,
pose-graph optimisation) is one batched computation.

The reference's map is immutable and its updates return a new map.  Here
the tensors are preallocated and UPDATED IN PLACE (the updating methods
return the map itself, so `m = m.add_keyframe(...)` reads the same in both
packages); only `grow` allocates, and returns a new map.  What relies on a
snapshot therefore takes one: whoever keeps a tensor of the map across a
later update clones it (the keyframe event's SSO fetch does).

Keyframe payload kept per keyframe: the spherical gray/depth images in
bfloat16 (enough to rebuild the alignment pyramids for a loop closure's
dense verification) and the PlaneSet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import MapConfig
from rgbd360_tpu_torch.ops.segmentation import PlaneSet
from rgbd360_tpu_torch.slam.graph import PoseGraph


def tree_leaves(tree) -> list:
    """The tensors of a (nested) dataclass in field order: the order in
    which the reference flattens its map, so leaf i of one package is leaf
    i of the other."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]


def tree_unflatten(template, leaves):
    """A dataclass shaped like `template` holding `leaves` (an iterator in
    `tree_leaves` order)."""
    leaves = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(leaves)
        return type(t)(**{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})

    return build(template)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen to float32 (lossless)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


@dataclass
class Map360:
    """Fixed-capacity SLAM map.

    n_kf:     () int32, number of live keyframes
    poses:    (N, 4, 4) trajectory poses (world <- kf)
    opt_poses:(N, 4, 4) optimized poses
    gray:     (N, H, W) bfloat16 spherical gray
    depth:    (N, H, W) bfloat16 spherical radial depth
    planes:   PlaneSet with a leading (N,) axis
    graph:    PoseGraph over the keyframes
    n_edges:  () int32
    edge_is_lc: (E,) bool, loop-closure edges
    sso:      (N, N) float32 sensed-space-overlap matrix
    area:     (N,) int32 topological area id per keyframe
    n_areas:  () int32
    """

    n_kf: torch.Tensor
    poses: torch.Tensor
    opt_poses: torch.Tensor
    gray: torch.Tensor
    depth: torch.Tensor
    planes: PlaneSet
    graph: PoseGraph
    n_edges: torch.Tensor
    edge_is_lc: torch.Tensor
    sso: torch.Tensor
    area: torch.Tensor
    n_areas: torch.Tensor

    # ----------------------------------------------------------- creation

    @staticmethod
    def empty(
        cfg: MapConfig, sphere_h: int, sphere_w: int, max_planes: int, hull_dirs: int,
        device=None,
    ) -> "Map360":
        n, e = cfg.max_keyframes, cfg.max_edges

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        zero_planes = PlaneSet(
            normal=zeros(n, max_planes, 3),
            center=zeros(n, max_planes, 3),
            d=zeros(n, max_planes),
            curvature=zeros(n, max_planes),
            area=zeros(n, max_planes),
            elongation=torch.ones((n, max_planes), device=device),
            n_inliers=zeros(n, max_planes),
            hull=zeros(n, max_planes, hull_dirs, 3),
            hue_hist=zeros(n, max_planes, 37),
            main_color=zeros(n, max_planes, 3),
            valid=zeros(n, max_planes, dtype=torch.bool),
        )
        return Map360(
            n_kf=zeros(dtype=torch.int32),
            poses=torch.eye(4, device=device).repeat(n, 1, 1),
            opt_poses=torch.eye(4, device=device).repeat(n, 1, 1),
            gray=zeros(n, sphere_h, sphere_w, dtype=torch.bfloat16),
            depth=zeros(n, sphere_h, sphere_w, dtype=torch.bfloat16),
            planes=zero_planes,
            graph=PoseGraph.empty(n, e, device),
            n_edges=zeros(dtype=torch.int32),
            edge_is_lc=zeros(e, dtype=torch.bool),
            sso=zeros(n, n),
            area=zeros(n, dtype=torch.int32),
            n_areas=torch.ones((), dtype=torch.int32, device=device),
        )

    @property
    def device(self) -> torch.device:
        return self.poses.device

    @property
    def kf_capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.graph.edges_ij.shape[0]

    # ------------------------------------------------------------ updates

    def grow(
        self, kf_capacity: int | None = None, edge_capacity: int | None = None
    ) -> "Map360":
        """A NEW map with enlarged fixed capacities.  With no arguments both
        capacities double; passing only one grows only that axis (an
        edge-capacity bump must not double the much heavier keyframe
        payload).  Contents are preserved; new slots are the inert padding
        `empty` produces."""
        n_old, e_old = self.kf_capacity, self.edge_capacity
        if kf_capacity is None and edge_capacity is None:
            kf_capacity, edge_capacity = 2 * n_old, 2 * e_old
        n = max(kf_capacity or n_old, n_old)
        e = max(edge_capacity or e_old, e_old)
        if n == n_old and e == e_old:
            return self
        h, w = self.gray.shape[1:]
        fresh = Map360.empty(
            MapConfig(max_keyframes=n, max_edges=e), h, w,
            self.planes.d.shape[1], self.planes.hull.shape[2], self.device,
        )
        for new, old in zip(tree_leaves(fresh), tree_leaves(self)):
            if new is fresh.sso:
                new[:n_old, :n_old] = old
            elif new.ndim == 0:
                new.copy_(old)
            else:
                new[: old.shape[0]] = old
        return fresh

    def add_keyframe(
        self,
        pose: torch.Tensor,
        gray: torch.Tensor,
        depth: torch.Tensor,
        planes: PlaneSet,
        area_id: int | torch.Tensor | None = None,
        n_live: int | None = None,
    ) -> "Map360":
        """Append a keyframe (reference `Map360::addKeyframe:90`); doubles
        the keyframe capacity when it is exhausted.  `n_live`: the host's
        keyframe count; passing it skips the blocking `int(self.n_kf)` read
        (the tracker mirrors the count)."""
        k = int(self.n_kf) if n_live is None else n_live
        m = self.grow(kf_capacity=2 * self.kf_capacity) if k >= self.kf_capacity else self
        pose = torch.as_tensor(pose, dtype=torch.float32, device=m.device)
        m.n_kf += 1
        m.poses[k] = pose
        m.opt_poses[k] = pose
        m.gray[k] = gray.to(torch.bfloat16)  # rounds to nearest even, as XLA
        m.depth[k] = depth.to(torch.bfloat16)
        for tot, one in zip(tree_leaves(m.planes), tree_leaves(planes)):
            tot[k] = one.to(tot.dtype)
        m.graph.poses[k] = pose
        m.graph.vmask[k] = True
        m.area[k] = 0 if area_id is None else area_id
        return m

    def add_edge(
        self,
        i: int,
        j: int,
        rel: torch.Tensor,
        info: torch.Tensor,
        sso: float = 0.0,
        is_loop: bool = False,
        n_live: int | None = None,
    ) -> "Map360":
        """Record a connection (reference `mmConnectionKFs`, `Map360.h:60`).
        rel maps x_i = rel @ x_j (pose of KF j expressed in KF i's frame);
        is_loop marks loop-closure edges for robust (DCS) treatment;
        `n_live` is the host's edge count (see `add_keyframe`)."""
        n_live = int(self.n_edges) if n_live is None else n_live
        return self.add_edges(
            np.array([[i, j]], np.int32),
            torch.as_tensor(rel, dtype=torch.float32)[None],
            torch.as_tensor(info, dtype=torch.float32)[None],
            np.array([sso], np.float32),
            np.array([bool(is_loop)]),
            n_live=n_live,
        )

    def add_edges(self, ij, rels, infos, ssos, is_loop, n_live: int) -> "Map360":
        """Append a BATCH of E edges: `ij` (E, 2) host integers, the rest
        arrays or tensors with a leading E.  `n_live` is the host's edge
        count (capacity check and first slot).  Duplicate (i, j) pairs in
        one batch must carry the same `ssos` value (the dense and the PbMap
        promotion edge share a pair and do)."""
        ij = np.asarray(ij, np.int32).reshape(-1, 2)
        e_new = len(ij)
        if e_new == 0:
            return self
        m = self
        while n_live + e_new > m.edge_capacity:
            m = m.grow(edge_capacity=2 * m.edge_capacity)
        dev, g = m.device, m.graph
        sl = slice(n_live, n_live + e_new)
        g.edges_ij[sl] = torch.from_numpy(ij).to(dev)
        g.rel[sl] = torch.as_tensor(rels, dtype=g.rel.dtype).to(dev)
        g.info[sl] = torch.as_tensor(infos, dtype=g.info.dtype).to(dev)
        g.emask[sl] = True
        m.edge_is_lc[sl] = torch.as_tensor(is_loop, dtype=torch.bool).to(dev)
        m.n_edges += e_new
        s = torch.as_tensor(ssos, dtype=m.sso.dtype).to(dev)
        i, j = torch.from_numpy(ij.astype(np.int64)).to(dev).unbind(1)
        m.sso[i, j] = s
        m.sso[j, i] = s
        return m

    def with_optimized(self, poses: torch.Tensor) -> "Map360":
        """Take `poses` (N, 4, 4) as the optimized poses (copied in)."""
        self.opt_poses.copy_(poses)
        self.graph.poses.copy_(poses)
        return self

    # -------------------------------------------------------- persistence

    def to_numpy(self) -> list:
        """The map's leaves as numpy arrays on the host, in `tree_leaves`
        order (bfloat16 widened to float32)."""
        return [_to_numpy(x) for x in tree_leaves(self)]

    def save(self, path: str) -> None:
        """Serialize the map to an .npz archive (`leaf_i` keys in the
        reference's order, so either package loads the other's)."""
        np.savez_compressed(path, **{f"leaf_{i}": a for i, a in enumerate(self.to_numpy())})

    @staticmethod
    def from_numpy(arrays, template: "Map360") -> "Map360":
        """A map of `template`'s dtypes and device from host arrays in
        `tree_leaves` order (their capacities may differ from the
        template's)."""
        dev = template.device
        return tree_unflatten(template, (
            torch.from_numpy(np.array(a)).to(device=dev, dtype=t.dtype)
            for a, t in zip(arrays, tree_leaves(template))
        ))

    @staticmethod
    def load(path: str, template: "Map360") -> "Map360":
        data = np.load(path)
        n = len(tree_leaves(template))
        return Map360.from_numpy([data[f"leaf_{i}"] for i in range(n)], template)
