"""The synthetic rig sequence the port is checked on.

A construction-spec rig with the rig's pinhole intrinsics and a seeded
CLAMS model, capturing the textured octagon room along a straight walk of
0.1 m per frame (`apps.grabber.synth_capture`, always with an explicit
`rt=`, with fresh sensor noise in every frame).  `subsample=s` keeps every
s-th sensor pixel, and scales the intrinsics, sphere and CLAMS grid with
it, so the same scene runs at a reduced size with exact geometry.  `chip_smoke.py`, the JAX golden
(`tools/torch_port_golden.py`) and the CPU tests all take their inputs from
here, so they see the very same frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rgbd360_tpu_torch.apps.grabber import synth_capture, synth_trajectory_poses
from rgbd360_tpu_torch.config import FrameworkConfig, RigConfig, default_config
from rgbd360_tpu_torch.io.calib import Calibration, pinhole_k
from rgbd360_tpu_torch.calibration.spec import construction_spec_rt

# synth_capture renders 240x320 QVGA sensors with these intrinsics
_FULL = RigConfig()
# The salient-pixel budget of the batched tracking path: the reference's
# batch-4 pipeline bench (`bench.py:919`).
BATCH_SALIENT_PIXELS = 16384
# Octagon inradius.  In synth_capture's default 3 m room the reference's
# dense aligner, started from identity, recovers only ~0.03 m of the first
# 0.1 m step (measured at full size; see PERF.md); in a 5 m room it
# recovers ~0.096 m, so the walk's ground truth can gate the slice.
ROOM_RADIUS = 5.0


def config(subsample: int = 1, pyramid_levels: int = 5) -> FrameworkConfig:
    """The default configuration, cut to a rig subsampled by `subsample`."""
    cfg = default_config()
    s = subsample
    rig = dataclasses.replace(
        cfg.rig,
        width=_FULL.width // s, height=_FULL.height // s,
        fx=_FULL.fx / s, fy=_FULL.fy / s, cx=_FULL.cx / s, cy=_FULL.cy / s,
    )
    sphere = dataclasses.replace(
        cfg.sphere, width=cfg.sphere.width // s, height=cfg.sphere.height // s
    )
    dense = dataclasses.replace(cfg.dense, pyramid_levels=pyramid_levels)
    return cfg.replace(rig=rig, sphere=sphere, dense=dense)


def synthetic_clams(
    num_sensors: int,
    h: int,
    w: int,
    bin_width: int = 4,
    bin_height: int = 3,
    nbins: int = 5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(multipliers, counts), each (S, nby, nbx, nbins) float32 as in
    `io/calib.Calibration`.  The multipliers are a smooth radial pattern
    that grows with depth, at most ~0.5% from 1 (like a real CLAMS model,
    and small enough that the undistorted synthetic depth stays trackable),
    plus 0.05% noise; counts sit above the CLAMS minimum of 50 except in
    ~5% of the bins, so both the interpolating and the nearest-bin branches
    of the undistortion run."""
    rng = np.random.default_rng(seed)
    nby, nbx = -(-h // bin_height), -(-w // bin_width)
    shape = (num_sensors, nby, nbx, nbins)
    yy = np.linspace(-1.0, 1.0, nby)[:, None]
    xx = np.linspace(-1.0, 1.0, nbx)[None, :]
    r2 = (xx * xx + yy * yy) / 2.0  # 0 at the centre, 1 at the corners
    amp = rng.uniform(0.5, 1.0, num_sensors)[:, None, None, None]
    ramp = np.linspace(0.0, 1.0, nbins)
    mult = 1.0 + 0.005 * amp * r2[None, :, :, None] * ramp
    mult = mult + 0.0005 * rng.uniform(-1.0, 1.0, shape)
    counts = rng.uniform(60.0, 1000.0, shape)
    counts[rng.uniform(size=shape) < 0.05] = 10.0
    return mult.astype(np.float32), counts.astype(np.float32)


def calibration(rig: RigConfig) -> Calibration:
    """Construction-spec extrinsics, the rig's intrinsics and a CLAMS
    model with 4x3-pixel frustums and 2 m depth bins (0-10 m)."""
    rt = construction_spec_rt(rig.num_sensors)
    mult, counts = synthetic_clams(rig.num_sensors, rig.height, rig.width)
    return Calibration(
        rt=rt.astype(np.float32),
        rt_inv=np.linalg.inv(rt).astype(np.float32),
        k=pinhole_k(rig),
        clams_multipliers=mult,
        clams_counts=counts,
        clams_bin_width=4,
        clams_bin_height=3,
        clams_bin_depth=2.0,
    )


def captures(n_frames: int, subsample: int = 1) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(rgb (8, H, W, 3) u8 BGR, depth (8, H, W) u16 mm)] of the octagon
    room along the walk; consecutive frames are 0.1 m apart on the rig's
    x axis."""
    rt = construction_spec_rt()
    poses = synth_trajectory_poses("walk", n_frames)
    out = []
    for i in range(n_frames):
        raw = synth_capture(
            i, seed=i, radius=ROOM_RADIUS, rt=rt, pose=poses[i], room="octagon"
        )
        s = subsample
        out.append(
            (
                np.ascontiguousarray(raw.rgb[:, ::s, ::s]),
                np.ascontiguousarray(raw.depth_mm[:, ::s, ::s]),
            )
        )
    return out


def loop_poses(n_frames: int, radius: float = 0.8) -> np.ndarray:
    """(n, 4, 4) ground-truth world_T_rig poses of a closed circle of
    `radius` metres in the horizontal plane, heading tangent to the path;
    the frame after the last closes back onto the first."""
    return synth_trajectory_poses("loop", n_frames, radius=radius)


def loop_captures(
    n_frames: int, subsample: int = 1, frames=None, room_radius: float = ROOM_RADIUS
) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(rgb, depth)] as `captures` gives them, of the octagon room from
    the poses `loop_poses(n_frames)`: all of them, or only those at the
    indices `frames` (a kidnapped rig skips part of the loop)."""
    rt = construction_spec_rt()
    poses = loop_poses(n_frames)
    s = subsample
    out = []
    for i in range(n_frames) if frames is None else frames:
        raw = synth_capture(i, seed=i, radius=room_radius, rt=rt, pose=poses[i], room="octagon")
        out.append(
            (
                np.ascontiguousarray(raw.rgb[:, ::s, ::s]),
                np.ascontiguousarray(raw.depth_mm[:, ::s, ::s]),
            )
        )
    return out


# A kidnapped rig: frames 0-9 of the 24-frame loop, one blind capture (the
# rig covered while it is carried: no depth, black images), then frames
# 18-21.  The blind capture is what makes the tracker declare itself lost:
# in the eightfold-symmetric octagon room the bare teleport 9 -> 18 does
# not (the reference's seed chain finds a motion-continuous alias whose
# depth residual, 5.7-6.1, passes its lost gate of 8; see PERF.md).
KIDNAP_LOOP_FRAMES = 24
KIDNAP_ORDER = list(range(10)) + [None] + list(range(18, 22))


def kidnap_captures(loop_caps, order=KIDNAP_ORDER) -> list[tuple[np.ndarray, np.ndarray]]:
    """The kidnapped rig's captures from those of the whole loop
    (`loop_captures(KIDNAP_LOOP_FRAMES, ...)`); None in `order` is a blind
    capture."""
    blind = (np.zeros_like(loop_caps[0][0]), np.zeros_like(loop_caps[0][1]))
    return [blind if i is None else loop_caps[i] for i in order]


def kidnap_poses(loop_gt: np.ndarray, order=KIDNAP_ORDER) -> np.ndarray:
    """Ground truth of the kidnapped rig's captures (a blind one keeps the
    pose before it)."""
    idx = [i if i is not None else order[n - 1] for n, i in enumerate(order)]
    return np.asarray(loop_gt)[idx]


def walk_seeds(offsets) -> np.ndarray:
    """(n, 4, 4) float32 poses translated by `offsets` metres along the
    walk (the rig's x axis): the seeds of the batched alignments."""
    seeds = np.tile(np.eye(4, dtype=np.float32), (len(offsets), 1, 1))
    seeds[:, 0, 3] = offsets
    return seeds


def ring_graph(n_live: int, capacity: int, edge_capacity: int, seed: int = 0,
               closures: int = 3, wrong: bool = True):
    """A seeded pose graph for the solvers: `n_live` poses on a circle of
    2 m radius, noisy odometry edges around it (1 cm / 0.01 rad), `closures`
    accurate closures across the ring and (with `wrong`) one closure that
    claims two distant vertices coincide, which a robust solve must switch
    off; the vertex poses are dead-reckoned from the noisy odometry.
    Returns (leaves, loop_mask, ground truth): the leaves are a PoseGraph's
    fields in order (poses, vmask, edges_ij, rel, info, emask) as numpy
    arrays padded to the capacities, for `convert.pose_graph_from_numpy`."""
    rng = np.random.default_rng(seed)
    gt = synth_trajectory_poses("loop", n_live, radius=2.0)

    def twist_exp(xi):  # small-angle SE(3) exponential, float64
        v, w = xi[:3], xi[3:]
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        a = np.sin(th) / th
        b = (1 - np.cos(th)) / th**2
        c = (th - np.sin(th)) / th**3
        t = np.eye(4)
        t[:3, :3] = np.eye(3) + a * k + b * k @ k
        t[:3, 3] = (np.eye(3) + b * k + c * k @ k) @ v
        return t

    def measured(i, j, sigma):
        return twist_exp(rng.normal(0, sigma, 6)) @ np.linalg.inv(gt[i]) @ gt[j]

    edges, rels, lc = [], [], []
    for i in range(n_live - 1):
        edges.append((i, i + 1)), rels.append(measured(i, i + 1, 0.01)), lc.append(False)
    for c in range(closures):
        i, j = c, n_live - 1 - c
        edges.append((i, j)), rels.append(measured(i, j, 0.002)), lc.append(True)
    if wrong:
        edges.append((1, n_live // 2)), rels.append(np.eye(4)), lc.append(True)
    poses = np.tile(np.eye(4), (capacity, 1, 1))
    for i in range(n_live - 1):
        poses[i + 1] = poses[i] @ rels[i]
    e = len(edges)
    edges_ij = np.full((edge_capacity, 2), -1, np.int32)
    edges_ij[:e] = edges
    rel = np.tile(np.eye(4), (edge_capacity, 1, 1))
    rel[:e] = rels
    info = np.tile(np.eye(6), (edge_capacity, 1, 1))
    info[:e] = np.diag([400.0, 400, 400, 900, 900, 900]) * rng.uniform(0.8, 1.2, (e, 1, 1))
    loop_mask = np.zeros(edge_capacity, bool)
    loop_mask[:e] = lc
    leaves = [poses.astype(np.float32), np.arange(capacity) < n_live, edges_ij,
              rel.astype(np.float32), info.astype(np.float32), np.arange(edge_capacity) < e]
    return leaves, loop_mask, gt
