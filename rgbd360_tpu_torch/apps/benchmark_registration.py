"""Compare registration methods on a capture pair (twin of
`rgbd360_tpu/apps/benchmark_registration.py`; reference
`Registration/MethodsRegisterRGBD360.cpp`).

Runs PbMap, dense photo, dense depth, dense photo+depth, dense bilinear,
ICP point-to-point, point-to-plane and GICP on the same pair of spheres,
and the joint rig aligner on the raw per-sensor images, reporting each
method's pose, time and agreement with dense photo+depth.  Each method is
timed over `--repeats` calls after one warm-up call, the device
synchronized before the clock is read.

Usage:
    python -m rgbd360_tpu_torch.apps.benchmark_registration F1.bin F2.bin \\
        --calib CALIB_DIR [--repeats 3] [--device cpu]

It runs on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(builder, raw1, raw2, repeats: int = 3) -> dict:
    """Every method on capture `raw2` against `raw1` on the builder's
    device: {name: (pose T_1<-2 (4, 4) numpy, ms per call, note)}, and
    PbMap's information matrix as a fourth item of its entry."""
    from rgbd360_tpu_torch.core.frame import RigFrame
    from rgbd360_tpu_torch.ops.pyramid import build_depth_pyramid
    from rgbd360_tpu_torch.ops.stitch import rgb_to_gray
    from rgbd360_tpu_torch.registration import dense as D
    from rgbd360_tpu_torch.registration.icp import (
        GICP,
        ICPAligner,
        POINT_TO_PLANE,
        POINT_TO_POINT,
    )
    from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration
    from rgbd360_tpu_torch.registration.rig_dense import RigDenseAligner, build_rig_pyramid

    device = builder.sensor.device
    f1 = builder.build_from_raw(raw1)
    f2 = builder.build_from_raw(raw2)
    ps1, ps2 = builder.segment_planes(f1), builder.segment_planes(f2)
    cfg = builder.config.dense
    p1 = D.build_frame_pyramid(f1.sphere_gray, f1.sphere_depth, cfg, builder.seam_levels)
    p2 = D.build_frame_pyramid(f2.sphere_gray, f2.sphere_depth, cfg, builder.seam_levels)
    dp1 = build_depth_pyramid(f1.sphere_depth, 4)
    dp2 = build_depth_pyramid(f2.sphere_depth, 4)

    results = {}

    def bench(fn):
        out = fn()  # warm-up
        _synchronize(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        _synchronize(device)
        return out, (time.perf_counter() - t0) / repeats * 1000

    reg = PlaneRegistration(builder.config.matcher)
    res, ms = bench(lambda: reg.register(ps1, ps2, mode=PLANAR_3DOF))
    results["pbmap"] = (res.pose.cpu().numpy(), ms, f"matches={int(res.n_matches)}",
                        res.information.cpu().numpy())

    def dense_note(res):
        return f"avd={float(res.av_depth_residual):.2f} sso={float(res.sso):.2f}"

    al = D.DenseAligner(cfg)
    for name, method in [
        ("dense_photo", D.PHOTO_CONSISTENCY),
        ("dense_depth", D.DEPTH_CONSISTENCY),
        ("dense_both", D.PHOTO_DEPTH),
    ]:
        res, ms = bench(lambda m=method: al.align(p2, p1, method=m))
        results[name] = (res.pose.cpu().numpy(), ms, dense_note(res))

    # the sub-pixel variant; the pyramids do not depend on the flag
    al_bl = D.DenseAligner(dataclasses.replace(cfg, bilinear=True))
    res, ms = bench(lambda: al_bl.align(p2, p1, method=D.PHOTO_DEPTH))
    results["dense_bilerp"] = (res.pose.cpu().numpy(), ms, dense_note(res))

    for name, var in [
        ("icp_point", POINT_TO_POINT),
        ("icp_plane", POINT_TO_PLANE),
        ("gicp", GICP),
    ]:
        icp = ICPAligner(cfg, variant=var)
        (pose, _, err, n), ms = bench(lambda i=icp: i.align(dp2, dp1))
        results[name] = (pose.cpu().numpy(), ms, f"rms={float(err):.3f} n={int(n)}")

    # joint robot-frame alignment from the RAW per-sensor images (no
    # sphere stitch; reference RegisterDensePhotoICP, RegisterRGBD360.h:344)
    rig_pyrs = []
    for raw in (raw1, raw2):
        rig = builder.undistort(RigFrame.from_raw(raw, device))
        rig_pyrs.append(build_rig_pyramid(rgb_to_gray(rig.rgb), rig.depth, cfg))
    rig_al = RigDenseAligner(builder.k, builder.rt, cfg)
    res, ms = bench(lambda: rig_al.align(rig_pyrs[1], rig_pyrs[0]))
    results["rig_joint"] = (res.pose.cpu().numpy(), ms,
                            f"sso={float(res.sso):.2f} (raw sensors)")

    print(f"{'method':<14} {'|t| m':<8} {'t':<30} {'ms':<8} notes")
    ref_t = results["dense_both"][0][:3, 3]
    for name, (pose, ms, note, *_) in results.items():
        t = pose[:3, 3]
        agree = np.linalg.norm(t - ref_t)
        print(
            f"{name:<14} {np.linalg.norm(t):<8.4f} "
            f"{np.round(t, 3).tolist()!s:<30} {ms:<8.1f} {note}  "
            f"(vs dense: {agree:.3f} m)"
        )
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frame1")
    p.add_argument("frame2")
    p.add_argument("--repeats", type=int, default=3)
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame

    builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    return run(builder, read_rig_frame(args.frame1), read_rig_frame(args.frame2),
               repeats=args.repeats)


if __name__ == "__main__":
    main()
