"""Rawlog ingest app (twin of `rgbd360_tpu/apps/load_rawlog.py`; reference
`Visualization/LoadRawlog.cpp`).

Streams an MRPT rawlog of per-camera `CObservation3DRangeScan` observations
(labels ``RGBD1..N``), assembles rig frames with the reference's sensor
arrangement and sync logic, and either

* exports stitched sphere RGB/depth images (reference modes 1-2,
  `LoadRawlog.cpp:303-322`),
* builds and saves the spherical point cloud (modes 3-5, `:324-349`), or
* converts the rawlog to `sphere_images_*.bin` rig captures (``--to-bin``),
  the framework's canonical ingest format (host only: no frame is built).

Color images ride in a rawlog as JPEG, which needs OpenCV (`cv2`); a
rawlog of gray images does not.

Usage:
    python -m rgbd360_tpu_torch.apps.load_rawlog LOG.rawlog --calib C --out DIR
        [--cloud] [--device cpu]
    python -m rgbd360_tpu_torch.apps.load_rawlog LOG.rawlog --calib C --out DIR --to-bin

Frames are built on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from rgbd360_tpu_torch.apps._common import add_calib_args, add_device_arg, frame_config, load_calib


def main(argv=None, builder=None):
    """Parse `argv` and ingest; returns the number of rig frames written or
    rendered.  `builder` replaces the one made from `--calib` (a test's
    small rig)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("rawlog")
    p.add_argument("--out", required=True)
    p.add_argument("--to-bin", action="store_true",
                   help="convert to sphere_images_*.bin instead of rendering")
    p.add_argument("--cloud", action="store_true",
                   help="also export the spherical point cloud (PLY)")
    p.add_argument("--decimation", type=int, default=1,
                   help="keep every Nth rig frame (reference `decimation`)")
    p.add_argument("--num-cameras", type=int, default=None,
                   help="rig camera count (default: inferred from labels)")
    p.add_argument("--arrangement", default=None,
                   help="comma-separated slot->camera permutation "
                        "(reference SensorArrangement)")
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.io.rawlog import assemble_rig_frames, read_rawlog

    arrangement = (
        tuple(int(x) for x in args.arrangement.split(","))
        if args.arrangement
        else None
    )
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    frames = assemble_rig_frames(
        read_rawlog(args.rawlog),
        num_cameras=args.num_cameras,
        arrangement=arrangement,
    )

    if args.to_bin:
        from rgbd360_tpu_torch.io.bin_format import write_rig_frame

        n = 0
        for i, raw in enumerate(frames):
            if i % args.decimation:
                continue
            write_rig_frame(outdir / f"sphere_images_{i + 1}.bin", raw)
            n += 1
        print(f"wrote {n} rig captures to {outdir}")
        return n

    from rgbd360_tpu_torch.apps.view_frame import export_frame
    from rgbd360_tpu_torch.core.frame import FrameBuilder

    if builder is None:
        builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    n = 0
    for i, raw in enumerate(frames):
        if i % args.decimation:
            continue
        export_frame(builder, raw, outdir, f"rawlog_{i:04d}", cloud=args.cloud)
        n += 1
    print(f"rendered {n} rig frames from {args.rawlog}")
    return n


if __name__ == "__main__":
    main()
