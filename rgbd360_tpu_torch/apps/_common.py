"""Shared CLI plumbing for the application entry points (a copy of
`rgbd360_tpu/apps/_common.py`, plus the port's `--device`).

`--calib` names the calibration directory; unlike the reference's, it has
no default (the reference defaults to a path of its own host).
`--parallax-refine` sets `sphere.parallax_refine` (the two-pass stitch)."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

def add_calib_args(p: argparse.ArgumentParser):
    p.add_argument(
        "--calib",
        required=True,
        help="calibration root containing Extrinsics/ and Intrinsics/",
    )
    p.add_argument(
        "--no-intrinsics",
        action="store_true",
        help="skip CLAMS depth undistortion models",
    )
    p.add_argument(
        "--matcher-ini",
        default=None,
        help="reference-format configLocaliser INI with the plane-matcher "
        "thresholds (reference config_files/configLocaliser_*.ini)",
    )
    p.add_argument(
        "--parallax-refine",
        action="store_true",
        help="two-pass parallax-corrected stitch: exact rig-centered radial "
        "depth (beyond-reference accuracy; ~one extra gather per frame)",
    )


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the CUDA device; the app "
        "raises where there is none; pass cpu to run on the CPU)",
    )


def frame_config(args, config=None):
    """FrameworkConfig with the frame-build CLI flags applied."""
    import dataclasses

    from rgbd360_tpu_torch.config import default_config

    config = config or default_config()
    if getattr(args, "parallax_refine", False):
        config = dataclasses.replace(
            config,
            sphere=dataclasses.replace(config.sphere, parallax_refine=True),
        )
    return config


def matcher_config(args):
    """MatcherConfig from --matcher-ini when given, else the baked defaults
    (which equal configLocaliser_sphericalOdometry.ini)."""
    from rgbd360_tpu_torch.config import MatcherConfig

    if getattr(args, "matcher_ini", None):
        return MatcherConfig.from_ini(args.matcher_ini)
    return MatcherConfig()


def load_calib(args):
    from rgbd360_tpu_torch.io.calib import load_calibration

    root = Path(args.calib)
    intr = None if args.no_intrinsics else root / "Intrinsics"
    if intr is not None and not intr.exists():
        intr = None
    return load_calibration(root / "Extrinsics", intr)


def rotation_to_quaternion(r: np.ndarray) -> np.ndarray:
    """(qw, qx, qy, qz) via Shepperd's method — stable for all rotations,
    including the ~180-degree headings routine in 360-degree trajectories."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
        q = np.empty(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    return q / np.linalg.norm(q)


def save_trajectory_txt(path, poses):
    """TUM-style trajectory: idx tx ty tz qw qx qy qz."""
    rows = []
    for i, t in enumerate(np.asarray(poses)):
        q = rotation_to_quaternion(t[:3, :3])
        rows.append([i, *t[:3, 3], *q])
    np.savetxt(path, np.asarray(rows), fmt="%.6f")
