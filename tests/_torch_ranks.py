"""Rank functions of the port's multi-process tests.  Spawned ranks import
this module (and the port), never jax: each function takes the rank's mesh
and plain numpy inputs and returns tensors and numbers for the test to
hold against the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from rgbd360_tpu_torch import convert
from rgbd360_tpu_torch.config import DenseRegConfig, MatcherConfig
from rgbd360_tpu_torch.parallel import multihost as MH, sharded as S
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration.planes import ODOMETRY_6DOF
from rgbd360_tpu_torch.slam import graph as G
from rgbd360_tpu_torch.slam import plane_ba as B

ONE = S.Mesh(None, 0, 1)  # a world of one: the single-device counterpart


def _counted(fn):
    """fn() and the collectives it made."""
    before = sum(S.COLLECTIVES.values())
    out = fn()
    return out, sum(S.COLLECTIVES.values()) - before


def stages(mesh, inp: dict) -> dict:
    """Every function of `parallel/sharded.py` on this rank's mesh and, for
    each, its single-device counterpart on the same inputs."""
    out = {}
    ring = convert.pose_graph_from_numpy(inp["ring"])
    (out["graph"], out["graph_coll"]) = _counted(
        lambda: S.distributed_pose_graph(mesh, ring, max_iters=15))
    out["graph_single"] = G.optimize_pose_graph(ring, max_iters=15)
    cg = []
    (out["pcg"], out["pcg_coll"]) = _counted(
        lambda: S.distributed_pose_graph_pcg(mesh, ring, max_iters=15, cg_counts=cg))
    out["pcg_cg"] = list(cg)
    out["pcg_single"] = G.optimize_pose_graph_pcg(ring, max_iters=15)

    dcs = convert.pose_graph_from_numpy(inp["dcs"])
    lm = torch.from_numpy(inp["dcs_loop_mask"])
    out["dcs"] = S.distributed_pose_graph_pcg(mesh, dcs, max_iters=15, loop_mask=lm)
    out["dcs_single"] = G.optimize_pose_graph_pcg(dcs, max_iters=15, loop_mask=lm)

    prob = convert.plane_ba_problem_from_numpy(inp["ba"])
    (out["ba"], out["ba_coll"]) = _counted(lambda: S.distributed_plane_ba(mesh, prob, max_iters=12))
    out["ba_single"] = B.optimize_plane_ba(prob, max_iters=12)
    out["ba10"] = S.distributed_plane_ba(mesh, prob, max_iters=10)
    out["ba10_single"] = B.optimize_plane_ba(prob, max_iters=10)

    trg = convert.plane_set_from_numpy(inp["scan_trg"])
    n_kf = inp["scan_n_kf"]
    stacked = convert.plane_set_from_numpy(
        {k: np.broadcast_to(v, (n_kf,) + v.shape) for k, v in inp["scan_ref"].items()})
    gate = torch.from_numpy(inp["scan_gate"])
    (out["scan"], out["scan_coll"]) = _counted(
        lambda: S.sharded_plane_scan(mesh, stacked, trg, gate, MatcherConfig(), ODOMETRY_6DOF))
    out["scan_single"] = S.sharded_plane_scan(ONE, stacked, trg, gate, MatcherConfig(),
                                              ODOMETRY_6DOF)

    cfg = DenseRegConfig(pyramid_levels=1)
    pa = [torch.from_numpy(inp[k]) for k in ("pa_gray", "pa_depth", "pa_pack", "pa_poses")]
    (out["pair"], out["pair_coll"]) = _counted(
        lambda: S.sharded_pair_align(mesh, *pa, cfg, D.PHOTO_DEPTH))
    gray, pts, valid = D._flat_points(pa[1], pa[0], cfg)
    h, g, st = D._hess_grad_packed(gray, pts, valid, pa[2], pa[3], cfg, D.PHOTO_DEPTH)
    out["pair_single"] = (h, g, st["mean_err"])

    # the capacities' divisibility, as the reference's ValueErrors
    odd = convert.pose_graph_from_numpy([a[: mesh.size + 1] if i >= 2 else a
                                         for i, a in enumerate(inp["ring"])])
    raised = []
    for name, call in (
        ("pcg", lambda: S.distributed_pose_graph_pcg(mesh, odd, max_iters=1)),
        ("ba", lambda: S.distributed_plane_ba(mesh, B.PlaneBAProblem(
            prob.poses, prob.planes, prob.obs_kf[:-1], prob.obs_pl[:-1], prob.obs[:-1],
            prob.w[:-1]), max_iters=1)),
    ):
        try:
            call()
        except ValueError:
            raised.append(name)
    out["raised"] = raised
    return out


def multihost_helpers(mesh, _=None) -> dict:
    """The multi-process glue inside a process group: the global and the
    (host, device) meshes, the boundary converters, a hierarchical psum and
    the agreement check (agreeing, and disagreeing on purpose)."""
    gm = MH.global_mesh("kf")
    hm = MH.hosts_mesh()
    local = torch.arange(2, dtype=torch.float32) + 2 * gm.rank
    full = MH.host_local_to_global(gm, 0, local)
    back = MH.global_to_host_local(gm, 0, full)
    s = S.psum(hm["device"], local.sum())
    tot = S.psum(hm["host"], s)
    return {
        "initialized": MH.initialize(),
        "size": gm.size, "rank": gm.rank, "hosts_shape": hm.shape,
        "full": full, "back_equal": bool(torch.equal(back, local)), "total": float(tot),
        "agree": MH.all_hosts_agree(float(full.sum())),
        "disagree": MH.all_hosts_agree(float(gm.rank)),
    }


def register_sequence_rank(mesh, walk: str, calib_dir: str, sub: int, levels: int,
                           maps_state: dict, seeds: tuple, window: int) -> dict:
    """`apps.register_sequence.run` with the graph solved over this rank's
    mesh, on a builder holding the given stitch maps, its PbMap results
    replaced by `seeds` (as `chip_smoke.recorded_registration` does)."""
    import chip_smoke
    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.apps import register_sequence
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.calib import load_calibration
    from rgbd360_tpu_torch.io.dataset import SequenceDataset

    cfg = synthetic.config(sub, levels)
    calib = load_calibration(f"{calib_dir}/Extrinsics", None, rig=cfg.rig)
    builder = FrameBuilder(calib, cfg, device="cpu")
    builder.load_state_dict(maps_state, strict=False)
    with chip_smoke.recorded_registration(seeds):
        traj, labels = register_sequence.run(SequenceDataset(walk), builder, window=window,
                                             mesh=mesh)
    return {"traj": traj, "labels": labels}


def graph_backend_rank(mesh, poses: np.ndarray, edges: list, max_iters: int) -> dict:
    """`GraphOptimizerBackend(backend="sharded", mesh=...)` built through its
    vertex / edge API and optimized over this rank's mesh."""
    from rgbd360_tpu_torch.slam.graph_backend import GraphOptimizerBackend

    g = GraphOptimizerBackend(max_vertices=len(poses), max_edges=8 * ((len(edges) + 7) // 8),
                              backend="sharded", mesh=mesh, max_iters=max_iters, device="cpu")
    for p in poses:
        g.add_vertex(p)
    for i, j, rel, info in edges:
        g.add_edge(i, j, rel, info)
    chi2, iters = g.optimize()
    return {"chi2": chi2, "iters": iters, "poses": g.get_poses()}


def psum_worker(mesh, _=None) -> dict:
    """The reference's two-process psum: rank p owns the values 2p, 2p+1;
    the assembled global array sums to 0+1+2+3 on every rank."""
    local = torch.arange(2, dtype=torch.float32) + 2 * mesh.rank
    s = float(MH.host_local_to_global(mesh, 0, local).sum())
    return {"sum": s, "agree": MH.all_hosts_agree(s, mesh)}


def raise_before_collective(mesh) -> None:
    """Rank 1 raises before the all-reduce that rank 0 then waits in."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails before the collective")
    S.psum(mesh, torch.ones(2))


def tracker_rank(mesh, n_frames: int) -> dict:
    """The reference's TRACKER_WORKER: the production `KeyframeSLAM` with
    `mesh=` over n box-room frames at the dryrun's 32x192 configuration
    (every frame a keyframe, deferred events on the deterministic poll
    cadence), then the single-device tracker on the same frames."""
    import time

    from rgbd360_tpu_torch import entry
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

    cfg = entry.dryrun_config()
    builder = entry.dryrun_builder(cfg, "cpu")
    frames = [tuple(torch.from_numpy(a) for a in
                    entry._box_room_sphere(32, 192, np.array([0.04 * i, 0.0, 0.02 * i])))
              for i in range(n_frames)]
    sharded = KeyframeSLAM(builder, cfg, mesh=mesh)
    frame_ms, pending = [], []
    for g, d in frames:
        st = sharded.make_state_from_sphere(g, d)
        t0 = time.perf_counter()
        sharded.process_state(st)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        pending.append(len(sharded._pending))
    lost = sharded.lost
    sharded.flush()
    single = KeyframeSLAM(builder, cfg)
    for g, d in frames:
        single.process_state(single.make_state_from_sphere(g, d))
    single.flush()
    traj = np.stack(sharded.trajectory)
    return {
        "deterministic": sharded._deterministic_polls, "lost": lost,
        "pending_after": pending, "frame_ms": frame_ms,
        "traj": traj, "single_traj": np.stack(single.trajectory),
        "n_kf": int(sharded.map.n_kf), "single_n_kf": int(single.map.n_kf),
        "opt_poses": sharded.map.opt_poses[: int(sharded.map.n_kf)].numpy(),
        "agree_schedule": MH.all_hosts_agree(float(sum(pending)), mesh),
        "agree_traj": MH.all_hosts_agree(float(traj.sum()), mesh),
    }
