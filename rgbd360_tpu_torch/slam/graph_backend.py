"""Pluggable incremental pose-graph backend interface (twin of
`rgbd360_tpu/slam/graph_backend.py`).

Mirrors the reference's standalone `GraphOptimization/` subsystem (abstract
`GraphOptimizer` with `addVertex / addEdge / optimizeGraph / getPoses /
saveGraph`, reference `GraphOptimization/GraphOptimizer.h` and its MRPT/G2O
implementations): an incremental builder API over the batched solver:
the single-device LM (`backend="dense"`) or the edge-sharded LM over a mesh
of ranks (`backend="sharded"`, `parallel.sharded.distributed_pose_graph`;
the job's mesh when none is given, a world of one outside
`torch.distributed`).  The g2o text reader and writer are host numpy,
copied from the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.apps._common import rotation_to_quaternion
from rgbd360_tpu_torch.slam.graph import PoseGraph, optimize_pose_graph


class GraphOptimizerBackend:
    """Incremental vertex/edge builder + optimize, reference-style API.  The
    graph's tensors live on `device` (the card when None) and are written
    in place."""

    def __init__(
        self,
        max_vertices: int = 512,
        max_edges: int = 4096,
        backend: str = "dense",
        mesh=None,
        max_iters: int = 10,
        device=None,
    ):
        if backend not in ("dense", "sharded"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.mesh = mesh
        self.max_iters = max_iters
        self.graph = PoseGraph.empty(max_vertices, max_edges, resolve_device(device))
        self.n_vertices = 0
        self.n_edges = 0

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.graph.poses.device)

    def add_vertex(self, pose: np.ndarray) -> int:
        """First vertex is gauge-fixed, like the reference (`:105`)."""
        i = self.n_vertices
        self.graph.poses[i] = self._put(pose)
        self.graph.vmask[i] = True
        self.n_vertices += 1
        return i

    def add_edge(self, i: int, j: int, rel: np.ndarray, info: np.ndarray) -> int:
        e = self.n_edges
        self.graph.edges_ij[e, 0] = int(i)
        self.graph.edges_ij[e, 1] = int(j)
        self.graph.rel[e] = self._put(rel)
        self.graph.info[e] = self._put(info)
        self.graph.emask[e] = True
        self.n_edges += 1
        return e

    def optimize(self):
        """Run the configured solver; returns (chi2, iterations)."""
        if self.backend == "sharded":
            from rgbd360_tpu_torch.parallel.sharded import distributed_pose_graph, make_mesh

            mesh = self.mesh or make_mesh()
            poses, chi2, iters = distributed_pose_graph(mesh, self.graph, self.max_iters)
        else:
            poses, chi2, iters = optimize_pose_graph(self.graph, self.max_iters)
        self.graph.poses.copy_(poses)
        return float(chi2), int(iters)

    def get_poses(self) -> np.ndarray:
        return self.graph.poses[: self.n_vertices].cpu().numpy()

    def save_graph(self, path: str) -> None:
        """Write the REAL g2o text format (`VERTEX_SE3:QUAT` /
        `EDGE_SE3:QUAT`), the reference `GraphOptimizer::saveGraph:273`
        capability — it calls g2o's own `optimizer.save()`, so files from
        either side interchange (g2o_viewer opens ours; `load_graph` reads
        a g2o-optimized file back)."""
        g = self.graph
        write_g2o(
            path,
            g.poses[: self.n_vertices].cpu().numpy(),
            g.edges_ij[: self.n_edges].cpu().numpy(),
            g.rel[: self.n_edges].cpu().numpy(),
            g.info[: self.n_edges].cpu().numpy(),
            fixed=(0,) if self.n_vertices else (),
        )

    def load_graph(self, path: str) -> None:
        """Load a g2o text file into this builder (inverse of
        `save_graph`; also reads files produced by g2o itself)."""
        poses, edges, rels, infos, _ = read_g2o(path)
        n_cap, e_cap = self.graph.poses.shape[0], self.graph.rel.shape[0]
        if len(poses) > n_cap or len(edges) > e_cap:
            raise ValueError(
                f"graph ({len(poses)} vertices, {len(edges)} edges) exceeds "
                f"this builder's capacity"
            )
        self.graph = PoseGraph.empty(n_cap, e_cap, self.graph.poses.device)
        self.n_vertices = 0
        self.n_edges = 0
        for p_ in poses:
            self.add_vertex(p_)
        for (i, j), rel, info in zip(edges, rels, infos):
            self.add_edge(int(i), int(j), rel, info)


# --------------------------------------------------------- g2o text format


def _pose_to_quat_xyzw(rt: np.ndarray):
    q = rotation_to_quaternion(np.asarray(rt[:3, :3], np.float64))  # (w,x,y,z)
    return np.asarray(rt[:3, 3], np.float64), np.array([q[1], q[2], q[3], q[0]])


def _quat_xyzw_to_pose(t, qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    rt = np.eye(4)
    rt[:3, :3] = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    rt[:3, 3] = t
    return rt


def write_g2o(path, poses, edges_ij, rels, infos, fixed=()) -> None:
    """g2o SE3 text writer: `VERTEX_SE3:QUAT id x y z qx qy qz qw`,
    `FIX id`, and `EDGE_SE3:QUAT i j x y z qx qy qz qw <21 info>` where the
    21 values are the row-major upper triangle of the 6x6 information over
    [t, q] — g2o's `EdgeSE3::write` layout.  Edge measurement convention
    matches both g2o and this framework: Z = X_i^-1 X_j."""
    with open(path, "w") as f:
        for i, pose in enumerate(poses):
            t, q = _pose_to_quat_xyzw(np.asarray(pose))
            f.write(
                f"VERTEX_SE3:QUAT {i} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n"
            )
        for i in fixed:
            f.write(f"FIX {i}\n")
        for (i, j), rel, info in zip(edges_ij, rels, infos):
            t, q = _pose_to_quat_xyzw(np.asarray(rel))
            info = np.asarray(info, np.float64)
            upper = [
                f"{info[r, c]:.9g}" for r in range(6) for c in range(r, 6)
            ]
            f.write(
                f"EDGE_SE3:QUAT {int(i)} {int(j)} "
                f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                + " ".join(upper)
                + "\n"
            )


def read_g2o(path):
    """g2o SE3 text reader (VERTEX_SE3:QUAT / EDGE_SE3:QUAT / FIX rows;
    unknown row types raise — loud, like the MRPT codecs).  Returns
    (poses (N,4,4), edges (E,2), rels (E,4,4), infos (E,6,6), fixed ids)."""
    poses = {}
    edges, rels, infos, fixed = [], [], [], []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            parts = raw.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT":
                vid = int(parts[1])
                vals = [float(v) for v in parts[2:9]]
                poses[vid] = _quat_xyzw_to_pose(vals[:3], *vals[3:])
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = [float(v) for v in parts[3:10]]
                upper = [float(v) for v in parts[10:31]]
                if len(upper) != 21:
                    raise ValueError(
                        f"{path}:{ln}: EDGE_SE3:QUAT needs 21 information "
                        f"entries, found {len(upper)}"
                    )
                info = np.zeros((6, 6))
                k = 0
                for r in range(6):
                    for c in range(r, 6):
                        info[r, c] = info[c, r] = upper[k]
                        k += 1
                edges.append((i, j))
                rels.append(_quat_xyzw_to_pose(vals[:3], *vals[3:]))
                infos.append(info)
            elif tag == "FIX":
                fixed.extend(int(v) for v in parts[1:])
            else:
                raise ValueError(
                    f"{path}:{ln}: unsupported g2o row type {tag!r} (this "
                    "reader covers the SE3 pose-graph subset the reference "
                    "emits: VERTEX_SE3:QUAT, EDGE_SE3:QUAT, FIX)"
                )
    n = max(poses) + 1 if poses else 0
    pose_arr = np.stack([poses[i] for i in range(n)]) if n else np.zeros((0, 4, 4))
    return (
        pose_arr,
        np.asarray(edges, np.int64).reshape(-1, 2),
        np.stack(rels) if rels else np.zeros((0, 4, 4)),
        np.stack(infos) if infos else np.zeros((0, 6, 6)),
        tuple(fixed),
    )
