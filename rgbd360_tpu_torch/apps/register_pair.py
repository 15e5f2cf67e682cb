"""Register a pair of rig captures (twin of
`rgbd360_tpu/apps/register_pair.py`; reference
`Registration/RegisterPairRGBD360.cpp`).

PbMap plane registration (PLANAR_3DoF) followed by GICP refinement (the
reference refines with PCL GICP; here the plane-to-plane covariance metric
runs as projective ICP on the spherical grids); prints the matches and both
poses, with `--dense` a dense photo+depth solve seeded by the plane pose,
and with `--out` exports the poses, the two spheres and the aligned clouds.

Usage:
    python -m rgbd360_tpu_torch.apps.register_pair F1.bin F2.bin --calib CALIB_DIR
        [--out DIR] [--dense [--bilinear]] [--device cpu]

It runs on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
    matcher_config,
)
from rgbd360_tpu_torch.config import MatcherConfig
from rgbd360_tpu_torch.ops.pyramid import build_depth_pyramid


def run(builder, raw1, raw2, dense: bool = False, bilinear: bool = False, out=None,
        matcher: MatcherConfig | None = None) -> dict:
    """Register capture `raw2` to `raw1` (two `RawRigFrame`s) on the
    builder's device: the PbMap pose, its GICP refinement and, with
    `dense`, the dense solve (`bilinear` sampling optionally).  Returns the
    `poses.json` record (poses T_1<-2 as nested lists) and writes it, the
    two spheres and `aligned_pair.ply` into `out` when given."""
    from rgbd360_tpu_torch.registration import dense as D
    from rgbd360_tpu_torch.registration.icp import GICP, ICPAligner
    from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration

    f1 = builder.build_from_raw(raw1)
    f2 = builder.build_from_raw(raw2)
    ps1 = builder.segment_planes(f1)
    ps2 = builder.segment_planes(f2)

    res = PlaneRegistration(matcher or MatcherConfig()).register(ps1, ps2, mode=PLANAR_3DOF)
    pose_pb = res.pose.cpu().numpy()
    print(f"PbMap: success={bool(res.success)} matches={int(res.n_matches)} "
          f"areaMatched={float(res.area_matched):.1f}")
    print(f"  t = {np.round(pose_pb[:3, 3], 4).tolist()}  "
          f"|t| = {np.linalg.norm(pose_pb[:3, 3]):.4f} m")

    # GICP refinement seeded by the plane pose (x_1 = T x_2: align(2, 1)),
    # the reference's plane-to-plane metric
    icp = ICPAligner(builder.config.dense, variant=GICP)
    pyr1 = build_depth_pyramid(f1.sphere_depth, 4)
    pyr2 = build_depth_pyramid(f2.sphere_depth, 4)
    pose_icp, _, err, n = icp.align(pyr2, pyr1, res.pose)
    pose_icp = pose_icp.cpu().numpy()
    print(f"GICP refine: rms={float(err):.4f} over {int(n)} correspondences")
    print(f"  t = {np.round(pose_icp[:3, 3], 4).tolist()}  "
          f"|t| = {np.linalg.norm(pose_icp[:3, 3]):.4f} m")

    record = {"pbmap": pose_pb.tolist(), "icp": pose_icp.tolist(),
              "pbmap_info": res.information.cpu().numpy().tolist(),
              "matches": int(res.n_matches), "icp_rms": float(err)}

    if dense:
        cfg = dataclasses.replace(builder.config.dense, bilinear=bilinear)
        p1 = D.build_frame_pyramid(f1.sphere_gray, f1.sphere_depth, cfg, builder.seam_levels)
        p2 = D.build_frame_pyramid(f2.sphere_gray, f2.sphere_depth, cfg, builder.seam_levels)
        # align(src=2, trg=1) -> T_1<-2, comparable with the PbMap pose
        dres = D.DenseAligner(cfg).align(p2, p1, res.pose)
        pose_d = dres.pose.cpu().numpy()
        print(f"Dense: avPhoto={float(dres.av_photo_residual):.4f} "
              f"avDepth={float(dres.av_depth_residual):.4f} sso={float(dres.sso):.3f}")
        print(f"  t = {np.round(pose_d[:3, 3], 4).tolist()}  "
              f"|t| = {np.linalg.norm(pose_d[:3, 3]):.4f} m")
        record["dense"] = pose_d.tolist()

    if out:
        export_pair(Path(out), record, f1, f2, pose_icp)
    return record


def export_pair(outdir: Path, record: dict, f1, f2, pose_icp: np.ndarray) -> None:
    """`poses.json`, the two spheres as PNG and both clouds in frame 1's
    coordinates (frame 2 moved by the GICP pose) as `aligned_pair.ply`."""
    from rgbd360_tpu_torch.ops import camera
    from rgbd360_tpu_torch.utils.viz import bgr_to_rgb, save_ply, save_png

    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir / "poses.json", "w") as fh:
        json.dump(record, fh, indent=1)
    save_png(outdir / "sphere1.png", bgr_to_rgb(f1.sphere_rgb.cpu().numpy()))
    save_png(outdir / "sphere2.png", bgr_to_rgb(f2.sphere_rgb.cpu().numpy()))
    pts1 = camera.sphere_backproject(f1.sphere_depth).cpu().numpy().reshape(-1, 3)
    pts2 = camera.sphere_backproject(f2.sphere_depth).cpu().numpy().reshape(-1, 3)
    pts2_in_1 = pts2 @ pose_icp[:3, :3].T.astype(np.float32) + pose_icp[:3, 3]
    cols = [f.sphere_rgb.cpu().numpy().reshape(-1, 3)[:, ::-1] for f in (f1, f2)]
    valid = np.concatenate([f.sphere_depth.cpu().numpy().reshape(-1) > 0 for f in (f1, f2)])
    n_pts = save_ply(outdir / "aligned_pair.ply", np.vstack([pts1, pts2_in_1]),
                     np.vstack(cols), valid)
    print(f"exported {n_pts} points to {outdir}/aligned_pair.ply")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frame1")
    p.add_argument("frame2")
    p.add_argument("--out", default=None, help="export directory")
    p.add_argument("--dense", action="store_true", help="also run dense photo+depth")
    p.add_argument(
        "--bilinear",
        action="store_true",
        help="validity-weighted bilinear target sampling for the dense stage "
        "(sub-pixel warp; beyond the reference's nearest rounding)",
    )
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame

    builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    return run(builder, read_rig_frame(args.frame1), read_rig_frame(args.frame2),
               dense=args.dense, bilinear=args.bilinear, out=args.out,
               matcher=matcher_config(args))


if __name__ == "__main__":
    main()
