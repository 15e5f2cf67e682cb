"""Keyframe SLAM over a capture directory (twin of
`rgbd360_tpu/apps/kf_slam.py`; reference `SLAM/KFsphere_SLAM.cpp`, and with
`--pbmap` the PbMap-tracking `SLAM/SphereGraphSLAM.cpp`).

Usage:
    python -m rgbd360_tpu_torch.apps.kf_slam DATASET_DIR --calib CALIB_DIR
        [--out DIR] [--pbmap] [--plane-ba] [--gt FILE] [--salient K]
        [--lc-salient K] [--timing] [--device cpu]

It runs on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
    save_trajectory_txt,
)


def export_map(slam, outdir: Path, voxel: float = 0.05):
    """Write the map viewer's four view modes as files (reference
    `Map360_Visualizer` modes, `include/Map360_Visualizer.h:63-68`):

    1. `map.ply`            voxel-filtered global cloud (and `map.pcd`)
    2. `kf_XXX.ply`         per-keyframe overlapping clouds (world frame)
    3. `selected_kfs.ply`   representative keyframes only (one per area)
    4. `topology.ply`       keyframe graph: vertices colored by area + edges

    plus `trajectory.ply` / `trajectory_opt.ply` (tracked vs optimized
    poses, which the viewer overlays) and the checkpointable map state
    `map.npz`.  The map's gray and depth payload is bfloat16 on the device;
    it is widened to float32 before it reaches numpy."""
    from rgbd360_tpu_torch.io.pcd import write_pcd
    from rgbd360_tpu_torch.ops import camera, se3
    from rgbd360_tpu_torch.ops.filters import voxel_downsample
    from rgbd360_tpu_torch.utils.viz import (
        AREA_COLORS,
        save_graph_ply,
        save_ply,
        save_trajectory_ply,
    )

    slam.flush()  # apply any deferred keyframe-event work first
    m = slam.map
    n_kf = int(m.n_kf)
    area = m.area[:n_kf].cpu().numpy()
    pts_all, col_all = [], []
    kf_clouds = []
    for k in range(n_kf):
        d = m.depth[k].float()
        pts_w = se3.transform_points(m.opt_poses[k], camera.sphere_backproject(d).reshape(-1, 3))
        mask = d.reshape(-1).cpu().numpy() > 0
        p = pts_w.cpu().numpy()[mask][::4]
        g = m.gray[k].float().cpu().numpy().reshape(-1)[mask][::4]
        c = np.stack([g * 255] * 3, axis=1)
        pts_all.append(p)
        col_all.append(c)
        kf_clouds.append((p, c))
    pts = np.vstack(pts_all)
    cols = np.vstack(col_all)

    # mode 1: voxelized global map (.ply + PCL .pcd interchange)
    pts_v, cols_v = voxel_downsample(pts, voxel, cols)
    n = save_ply(outdir / "map.ply", pts_v, cols_v)
    write_pcd(outdir / "map.pcd", pts_v, cols_v)
    # mode 2: overlapping per-keyframe clouds
    for k, (p, c) in enumerate(kf_clouds):
        save_ply(outdir / f"kf_{k:03d}.ply", p[::4], c[::4])
    # mode 3: representative keyframes only (first KF of each area: the
    # viewer's vSelectedKFs view)
    sel = [int(np.argmax(area == a)) for a in np.unique(area)]
    if sel:
        save_ply(
            outdir / "selected_kfs.ply",
            np.vstack([kf_clouds[k][0] for k in sel]),
            np.vstack([kf_clouds[k][1] for k in sel]),
        )
    # mode 4: keyframe topology (vertices colored by area, graph edges)
    opt = m.opt_poses[:n_kf].cpu().numpy()
    edges = m.graph.edges_ij.cpu().numpy()[m.graph.emask.cpu().numpy()]
    edges = edges[(edges[:, 0] < n_kf) & (edges[:, 1] < n_kf)]
    save_graph_ply(outdir / "topology.ply", opt[:, :3, 3], edges,
                   AREA_COLORS[area % len(AREA_COLORS)])

    save_trajectory_ply(outdir / "trajectory.ply", np.stack(slam.trajectory))
    save_trajectory_ply(outdir / "trajectory_opt.ply", opt)
    m.save(str(outdir / "map.npz"))
    print(
        f"map: {n} voxelized points -> {outdir}/map.ply; {n_kf} KF clouds, "
        f"{len(sel)} selected, topology + trajectories; state -> map.npz"
    )


def plane_ba(slam) -> dict:
    """The final joint refinement of the keyframe poses and global plane
    landmarks (`slam/plane_ba.py`); writes the refined poses into the map.
    Returns the problem and the solve's poses, chi2 and LM iterations."""
    from rgbd360_tpu_torch.slam.plane_ba import associate_planes, optimize_plane_ba

    m = slam.map
    n_kf = int(m.n_kf)
    sets = [m.planes.map(lambda name, a, k=k: a[k]) for k in range(n_kf)]
    prob = associate_planes([m.opt_poses[k] for k in range(n_kf)], sets, max_planes=64)
    poses, planes, chi2, iters = optimize_plane_ba(prob)
    m.with_optimized(torch.cat([poses, m.opt_poses[n_kf:]]))
    n_lm = int(torch.sum(torch.linalg.norm(prob.planes[:, :3], dim=1) > 0.5))
    print(
        f"plane BA: {n_lm} landmarks, {int(prob.obs.shape[0])} observations, "
        f"chi2={float(chi2):.4f} in {iters} LM iters"
    )
    return {"problem": prob, "poses": poses, "planes": planes, "chi2": float(chi2),
            "iters": iters}


def make_tracker(builder, pbmap: bool = False):
    """The tracker `run` drives: `KeyframeSLAM` on the builder's
    configuration, or with `pbmap` `PbMapGraphSLAM` with its pose graph
    solved in float64, as the reference's `SphereGraphSLAM` solves it in
    g2o's double (on plane-tracked graphs, whose wall-only edges leave the
    vertical to the priors, a float32 LM stops short of that optimum;
    `GraphConfig.dtype`)."""
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM
    from rgbd360_tpu_torch.slam.pbmap_slam import PbMapGraphSLAM

    if not pbmap:
        return KeyframeSLAM(builder)
    cfg = builder.config
    return PbMapGraphSLAM(builder, cfg.replace(graph=dataclasses.replace(cfg.graph,
                                                                         dtype="float64")))


def run(ds, builder, pbmap: bool = False, plane_ba_: bool = False, gt=None,
        timing: bool = False, out=None):
    """Keyframe SLAM (`make_tracker`: `KeyframeSLAM`, or `PbMapGraphSLAM`
    when `pbmap`) over every frame of the dataset `ds` on the builder's
    device, then the optional planar BA, the ATE / RPE against the
    ground-truth file `gt`, the stage times and the map export into `out`.
    Returns (tracker, the planar BA's result or None)."""
    slam = make_tracker(builder, pbmap)
    if timing:
        slam.timer.enable()
    for i, raw in enumerate(ds):
        ev = slam.process(raw)
        pose = slam.trajectory[-1]
        # with deferred keyframe events, an event dict's loop-closure count
        # is filled in on later frames: log the tracker's running total
        print(
            f"frame {ds.indices[i]}: kf={ev.get('keyframe')} "
            f"lc_total={slam.n_loop_closures} t={np.round(pose[:3, 3], 3).tolist()}"
        )

    slam.flush()  # apply any deferred keyframe-event work
    n_kf = int(slam.map.n_kf)
    print(
        f"done: {n_kf} keyframes, {int(slam.map.n_edges)} edges, "
        f"{int(slam.map.n_areas)} areas"
    )
    ba = plane_ba(slam) if plane_ba_ and n_kf >= 2 else None
    if gt:
        from rgbd360_tpu_torch.utils.metrics import ate_rmse, rpe, trajectory_length

        gt_poses = np.loadtxt(gt).reshape(-1, 4, 4)
        est = np.stack(slam.trajectory)
        n = min(len(gt_poses), len(est))
        ate = ate_rmse(est[:n], gt_poses[:n])
        rpe_t, rpe_r = rpe(est[:n], gt_poses[:n])
        print(
            f"ATE {ate:.4f} m over {n} frames "
            f"(path {trajectory_length(gt_poses[:n]):.2f} m); "
            f"RPE {rpe_t:.4f} m / {rpe_r:.4f} rad per frame"
        )
        if hasattr(slam, "optimized_trajectory"):
            opt = slam.optimized_trajectory()[:n]
            print(
                f"ATE (optimized, frames re-anchored to corrected keyframes) "
                f"{ate_rmse(opt, gt_poses[:n]):.4f} m"
            )
    if timing:
        print(slam.timer.report())
    if out:
        outdir = Path(out)
        outdir.mkdir(parents=True, exist_ok=True)
        save_trajectory_txt(outdir / "trajectory.txt", np.stack(slam.trajectory))
        export_map(slam, outdir)
    return slam, ba


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset")
    p.add_argument("--out", default=None)
    p.add_argument("--pbmap", action="store_true",
                   help="PbMap-tracking graph SLAM (reference SphereGraphSLAM), its pose "
                   "graph solved in float64 as the reference's g2o solves it")
    p.add_argument("--timing", action="store_true",
                   help="record the tracker's spans and print host ms by span name, "
                   "total and self time (less the spans inside), and the counters; "
                   "host times: the card runs asynchronously, so a span holds its "
                   "launches and the waits made inside it")
    p.add_argument("--plane-ba", action="store_true",
                   help="final joint refinement of keyframe poses + global "
                   "plane landmarks (Schur-complement planar BA)")
    p.add_argument("--gt", default=None, metavar="FILE",
                   help="ground-truth poses (N x 16 rows, flattened 4x4 — the "
                   "grabber synth gt_poses.txt format); prints ATE/RPE after "
                   "the run")
    p.add_argument("--salient", type=int, default=0, metavar="K",
                   help="track with K stratified-salient pixels at the finest "
                   "level instead of dense sweeps (the reference's "
                   "bUseSalientPixels)")
    p.add_argument("--lc-salient", type=int, default=None, metavar="K",
                   help="thin the loop-closure VERIFY sweeps to K salient "
                   "pixels (+2 mandatory dense polish iterations; "
                   "LoopClosureConfig.verify_salient_pixels; pass 0 for full "
                   "sweeps)")
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.config import default_config
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.dataset import SequenceDataset

    config = frame_config(args, default_config())
    if args.salient:
        # polish_iters=2: dense finishing sweeps keep salient tracking at
        # dense-grade accuracy (see DenseRegConfig.polish_iters)
        config = config.replace(dense=dataclasses.replace(
            config.dense, salient_pixels=args.salient, polish_iters=2))
    if args.lc_salient is not None:
        config = config.replace(lc=dataclasses.replace(
            config.lc, verify_salient_pixels=args.lc_salient))
    builder = FrameBuilder(load_calib(args), config, device=args.device)
    ds = SequenceDataset(args.dataset)
    if len(ds) == 0:
        raise SystemExit(f"no sphere_images_*.bin found in {args.dataset}")
    return run(ds, builder, pbmap=args.pbmap, plane_ba_=args.plane_ba, gt=args.gt,
               timing=args.timing, out=args.out)[0]


if __name__ == "__main__":
    main()
