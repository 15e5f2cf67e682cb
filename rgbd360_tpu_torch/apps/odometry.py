"""Frame-to-frame spherical odometry over a capture directory (twin of
`rgbd360_tpu/apps/odometry.py`; reference `Registration/OdometryRGBD360.cpp`
and `OdometryKeyFrame360.cpp`; `--online` is the live-capture variant,
`OnlineOdometryRGBD360.cpp:80-117`, consuming frames as a grabber process
writes them).

Usage:
    python -m rgbd360_tpu_torch.apps.odometry DATASET_DIR --calib CALIB_DIR
        [--out DIR] [--keyframe] [--online [--idle-timeout S]] [--device cpu]

It runs on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
    save_trajectory_txt,
)


def run(ds, builder, keyframe: bool = False, out=None):
    """Track every frame of `ds` (a `SequenceDataset` or `StreamingDataset`)
    with `FrameToFrameOdometry`, or `KeyframeSLAM` when `keyframe`, on the
    builder's device; print one line per frame and write `trajectory.txt`
    and `trajectory.ply` into `out` when given.  Returns (tracker,
    trajectory (N, 4, 4))."""
    from rgbd360_tpu_torch.slam.odometry import FrameToFrameOdometry, KeyframeSLAM

    tracker = KeyframeSLAM(builder) if keyframe else FrameToFrameOdometry(builder)
    for i, raw in enumerate(ds):
        ev = tracker.process(raw)
        pose = tracker.trajectory[-1]
        extra = f" kf={ev.get('keyframe')}" if keyframe else ""
        print(
            f"frame {ds.indices[i]}: t={np.round(pose[:3, 3], 3).tolist()} "
            f"res={ev.get('av_depth_residual', 0):.3f}{extra}"
        )

    traj = np.stack(tracker.trajectory)
    length = float(np.sum(np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=1)))
    print(f"trajectory: {len(traj)} frames, path length {length:.3f} m")
    if out:
        from rgbd360_tpu_torch.utils.viz import save_trajectory_ply

        outdir = Path(out)
        outdir.mkdir(parents=True, exist_ok=True)
        save_trajectory_txt(outdir / "trajectory.txt", traj)
        save_trajectory_ply(outdir / "trajectory.ply", traj)
        print(f"saved trajectory to {outdir}")
    return tracker, traj


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", help="directory with sphere_images_*.bin")
    p.add_argument("--out", default=None)
    p.add_argument(
        "--keyframe",
        action="store_true",
        help="keyframe odometry (track against the last keyframe instead of "
        "the previous frame, reference OdometryKeyFrame360)",
    )
    p.add_argument(
        "--online",
        action="store_true",
        help="consume frames live as a grabber writes them into DATASET_DIR "
        "(reference OnlineOdometryRGBD360); stream ends on a 'capture_done' "
        "marker file or after --idle-timeout seconds without a new frame",
    )
    p.add_argument("--idle-timeout", type=float, default=10.0)
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.dataset import SequenceDataset, StreamingDataset

    builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    if args.online:
        ds = StreamingDataset(args.dataset, idle_timeout=args.idle_timeout)
    else:
        ds = SequenceDataset(args.dataset)
        if len(ds) == 0:
            raise SystemExit(f"no sphere_images_*.bin found in {args.dataset}")
    return run(ds, builder, keyframe=args.keyframe, out=args.out)[1]


if __name__ == "__main__":
    main()
