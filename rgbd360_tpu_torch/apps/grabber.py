"""Capture serialization tool (twin of `rgbd360_tpu/apps/grabber.py`,
reference `Grabber/RGBD360_Grabber.cpp`).

`synth_capture` renders one 8-sensor RGB-D capture of a textured virtual
room (a cylinder, or an octagonal prism with ten real planes) from a rig
pose, and `synth_trajectory_poses` gives the ground-truth poses of a walk
or a closed loop.  Both are copies of the reference's functions and give
the same bytes from the same seed.  `main` writes such captures as
`sphere_images_*.bin` files (`synth`, with `gt_poses.txt`), or re-serializes
and verifies an existing capture directory (`repack`).  It runs on the host
only (numpy), so it takes no device.

Usage:
    python -m rgbd360_tpu_torch.apps.grabber repack  SRC_DIR DST_DIR
    python -m rgbd360_tpu_torch.apps.grabber synth   DST_DIR --frames 5 [--seed 0]
        [--trajectory loop --path-radius 0.8]   # closed loop + gt_poses.txt
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.calibration.spec import construction_spec_rt
from rgbd360_tpu_torch.io.bin_format import RawRigFrame, read_rig_frame, write_rig_frame


def _octagon_hit(o: np.ndarray, d: np.ndarray, inradius: float,
                 half_height: float = 1.7) -> np.ndarray:
    """Sensor z-depth of the first hit on an octagonal prism room viewed
    from inside: 8 vertical walls at distance `inradius` from the x axis
    plus floor/ceiling caps at x = -/+ `half_height`.  `o` (3,) ray origin,
    `d` (..., 3) ray directions parameterized by sensor z-depth."""
    phis = (np.arange(8) + 0.5) * (np.pi / 4)  # wall normals off sensor axes
    normals = np.stack(
        [np.zeros(8), np.sin(phis), np.cos(phis)], axis=-1
    )  # (8, 3), outward
    den = d @ normals.T  # (..., 8)
    num = inradius - o @ normals.T  # (8,)
    t_wall = np.where(den > 1e-9, num / np.maximum(den, 1e-9), np.inf)
    dx = d[..., 0]
    t_up = np.where(dx > 1e-9, (half_height - o[0]) / np.maximum(dx, 1e-9), np.inf)
    t_dn = np.where(dx < -1e-9, (-half_height - o[0]) / np.minimum(dx, -1e-9), np.inf)
    return np.minimum(t_wall.min(axis=-1), np.minimum(t_up, t_dn))


def synth_capture(
    frame_idx: int,
    seed: int = 0,
    step: float = 0.1,
    radius: float = 3.0,
    rt: np.ndarray | None = None,
    pose: np.ndarray | None = None,
    room: str = "cylinder",
) -> RawRigFrame:
    """Synthesize one rig capture of a textured virtual room.

    Geometrically consistent: the room is either a cylinder of the given
    radius about the world's vertical (x) axis, or (`room="octagon"`) an
    octagonal prism of inradius `radius` with floor/ceiling caps — ten real
    planes, so plane segmentation, PbMap matching, and plane-gated loop
    closure all engage.  Texture is painted as a function of axial position
    and azimuth.  The rig sits at `pose` (4x4 world_T_rig; rotation +
    translation both honored), or — when `pose` is None — at the legacy
    straight walk t = (step * frame_idx, 0, 0).  Sequences carry real
    parallax and exact ground-truth motion, exercising the full
    stitch+track pipeline.
    """
    rng = np.random.default_rng(seed)
    h, w = 240, 320
    fx = fy = 262.5
    cx, cy = 159.5, 119.5
    if rt is None:  # sensor poses: real calibration wins over the spec
        rt = construction_spec_rt()
    if pose is None:
        pose = np.eye(4)
        pose[0, 3] = step * frame_idx
    pose = np.asarray(pose, np.float64)
    rgb = np.zeros((8, h, w, 3), np.uint8)
    depth = np.zeros((8, h, w), np.uint16)
    u = (np.arange(w) - cx) / fx
    v = (np.arange(h) - cy) / fy
    uu, vv = np.meshgrid(u, v)
    for s in range(8):
        # sensor -> world: world_T_rig @ rig_T_sensor
        g = pose @ rt[s]
        r3 = g[:3, :3]
        t3 = g[:3, 3]
        # ray per pixel in the rig frame, parameterized by sensor z-depth
        d_sensor = np.stack([uu, vv, np.ones_like(uu)], axis=-1)
        d_rig = d_sensor @ r3.T  # (h, w, 3)
        if room == "octagon":
            z = _octagon_hit(t3, d_rig, radius)
        else:
            # intersect o + z*d with cylinder y^2 + z^2 = radius^2 (x axis)
            oy, oz = t3[1], t3[2]
            dy, dz = d_rig[..., 1], d_rig[..., 2]
            a = dy * dy + dz * dz
            b = 2 * (oy * dy + oz * dz)
            c = oy * oy + oz * oz - radius * radius
            disc = np.maximum(b * b - 4 * a * c, 0.0)
            z = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-9)  # sensor z-depth
        hit = t3 + z[..., None] * d_rig
        axial = hit[..., 0]
        azim = np.arctan2(hit[..., 1], hit[..., 2])
        depth[s] = np.clip(z * 1000, 0, 65535).astype(np.uint16)
        # incommensurate frequencies: a texture periodic in azimuth (e.g.
        # sin(4*azim) alone) photometrically near-aliases under yaw, which
        # breaks salient/dense tracking on rotating trajectories in ways no
        # real scene does
        tex = (
            128
            + 55 * np.sin(4 * azim) * np.cos(5.0 * axial)
            + 35 * np.sin(11 * azim + 2.0 * axial)
            + 30 * np.sin(7.31 * azim - 3.17 * axial + 1.7)
            + 20 * np.cos(13.73 * azim + 5.91 * axial)
        )
        tex = np.clip(tex + rng.normal(0, 2, tex.shape), 0, 255).astype(np.uint8)
        rgb[s] = np.stack(
            [tex, tex, np.clip(tex * 0.9, 0, 255).astype(np.uint8)], -1
        )
    return RawRigFrame(rgb=rgb, depth_mm=depth, timestamp=1000000 + frame_idx)


def synth_trajectory_poses(
    kind: str, n: int, step: float = 0.1, radius: float = 0.8
) -> np.ndarray:
    """(n, 4, 4) ground-truth world_T_rig poses for a synthetic capture.

    `walk`: straight line along the room axis (legacy behavior).
    `loop`: closed circle of the given radius in the horizontal (y, z)
    plane, heading tangent to the path (yaw about the vertical x axis), the
    last frame closing back onto the first — a loop-closure scenario.
    """
    poses = np.tile(np.eye(4), (n, 1, 1))
    if kind == "walk":
        poses[:, 0, 3] = step * np.arange(n)
        return poses
    theta = 2 * np.pi * np.arange(n) / n
    poses[:, 1, 3] = radius * np.sin(theta)
    poses[:, 2, 3] = radius * (np.cos(theta) - 1.0)
    c, s = np.cos(theta), np.sin(theta)
    # yaw about the vertical x axis: rotates the horizontal (y, z) plane
    poses[:, 1, 1] = c
    poses[:, 1, 2] = -s
    poses[:, 2, 1] = s
    poses[:, 2, 2] = c
    return poses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("repack")
    pr.add_argument("src")
    pr.add_argument("dst")
    ps = sub.add_parser("synth")
    ps.add_argument("dst")
    ps.add_argument("--frames", type=int, default=5)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--calib", default=None,
                    help="calibration root; when given, synthesize with its "
                    "extrinsics so the frames stitch consistently")
    ps.add_argument("--trajectory", choices=["walk", "loop"], default="walk",
                    help="walk: straight line along the room axis; loop: a "
                    "closed circle in the horizontal plane with tangent "
                    "heading, returning to the start (exercises loop closure)")
    ps.add_argument("--path-radius", type=float, default=0.8,
                    help="loop trajectory radius in metres")
    ps.add_argument("--step", type=float, default=0.1,
                    help="walk step per frame in metres")
    ps.add_argument("--room", choices=["cylinder", "octagon"], default="cylinder",
                    help="octagon: octagonal prism with floor/ceiling — ten "
                    "real planes, enabling PbMap matching and plane-gated "
                    "loop closure on the synthetic data")
    args = p.parse_args(argv)

    dst = Path(args.dst)
    dst.mkdir(parents=True, exist_ok=True)
    if args.cmd == "repack":
        from rgbd360_tpu_torch.io.dataset import SequenceDataset

        ds = SequenceDataset(args.src)
        for idx, raw in zip(ds.indices, ds):
            out = dst / f"sphere_images_{idx}.bin"
            write_rig_frame(out, raw)
            back = read_rig_frame(out)
            if not (np.array_equal(back.rgb, raw.rgb) and np.array_equal(back.depth_mm, raw.depth_mm)):
                raise RuntimeError(f"{out}: the written capture does not read back equal")
            print(f"repacked {out} ({out.stat().st_size} B, verified)")
        return
    rt = None
    if args.calib:
        from rgbd360_tpu_torch.io.calib import load_extrinsics

        rt = load_extrinsics(Path(args.calib) / "Extrinsics").astype(np.float64)
    poses = synth_trajectory_poses(
        args.trajectory, args.frames, step=args.step, radius=args.path_radius
    )
    for i in range(args.frames):
        raw = synth_capture(
            i, args.seed, step=args.step, rt=rt, pose=poses[i], room=args.room
        )
        out = dst / f"sphere_images_{i + 1}.bin"
        write_rig_frame(out, raw)
        print(f"wrote {out}")
    np.savetxt(dst / "gt_poses.txt", poses.reshape(args.frames, 16), fmt="%.9f")
    print(f"wrote ground-truth poses to {dst / 'gt_poses.txt'}")


if __name__ == "__main__":
    main()
