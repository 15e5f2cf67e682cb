"""Control-plane correspondences for extrinsic rig calibration (twin of
`rgbd360_tpu/calibration/control_planes.py`).

The reference's `ControlPlanes` (reference `include/Calibrator.h:42-173`)
accumulates matched plane observations between sensor pairs from live or
recorded data (`Calibration/GetControlPlanes.cpp` does the matching with a
RANSAC alignment fit, `:129-243`).  Here a correspondence store is a padded
array per sensor pair, and collection from recorded frames matches each
adjacent pair's locally-segmented planes under the current extrinsic guess,
with a consensus (RANSAC-like) inlier filter.

Conventions: planes are (n, d) with n . x + d = 0 in the sensor frame; for
x_rig = R_s x_s + t_s the rig-frame plane is
n_rig = R_s n_s, d_rig = d_s - (R_s n_s) . t_s.

The planes are segmented on a torch device by the port's batched
per-sensor segmentation (the call `FrameBuilder.segment_planes` makes,
all sensors in one call); the matching and the store are host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.config import SegmentationConfig
from rgbd360_tpu_torch.ops import segmentation as seg_ops


@dataclass
class ControlPlanes:
    """Correspondence store for an S-sensor rig.

    For each sensor pair key (a, b): arrays
      n_a, n_b: (C, 3) plane normals in each sensor's own frame
      d_a, d_b: (C,) plane offsets
      w:        (C,) confidence weights (min inlier count)
    """

    num_sensors: int
    pairs: dict = field(default_factory=dict)

    def add(self, a: int, b: int, n_a, d_a, n_b, d_b, w=None):
        key = (a, b)
        n_a = np.atleast_2d(np.asarray(n_a, np.float64))
        n_b = np.atleast_2d(np.asarray(n_b, np.float64))
        d_a = np.atleast_1d(np.asarray(d_a, np.float64))
        d_b = np.atleast_1d(np.asarray(d_b, np.float64))
        w = np.ones(len(d_a)) if w is None else np.atleast_1d(np.asarray(w, np.float64))
        if key not in self.pairs:
            self.pairs[key] = dict(
                n_a=np.zeros((0, 3)), d_a=np.zeros(0),
                n_b=np.zeros((0, 3)), d_b=np.zeros(0), w=np.zeros(0),
            )
        p = self.pairs[key]
        p["n_a"] = np.vstack([p["n_a"], n_a])
        p["n_b"] = np.vstack([p["n_b"], n_b])
        p["d_a"] = np.concatenate([p["d_a"], d_a])
        p["d_b"] = np.concatenate([p["d_b"], d_b])
        p["w"] = np.concatenate([p["w"], w])

    def count(self, a: int, b: int) -> int:
        return len(self.pairs.get((a, b), {"w": []})["w"])

    # ------------------------------------------------------------ file IO

    def save(self, path: str) -> None:
        """Text format compatible in spirit with the reference's
        `correspondences_*.txt` (one row per correspondence:
        a b nax nay naz da nbx nby nbz db w)."""
        rows = []
        for (a, b), p in sorted(self.pairs.items()):
            for k in range(len(p["w"])):
                rows.append(
                    [a, b, *p["n_a"][k], p["d_a"][k], *p["n_b"][k], p["d_b"][k], p["w"][k]]
                )
        np.savetxt(path, np.asarray(rows))

    @staticmethod
    def load(path: str, num_sensors: int = 8) -> "ControlPlanes":
        cp = ControlPlanes(num_sensors)
        rows = np.atleast_2d(np.loadtxt(path))
        if rows.size == 0:
            return cp
        for r in rows:
            cp.add(int(r[0]), int(r[1]), r[2:5], r[5], r[6:9], r[9], r[10])
        return cp

    @staticmethod
    def load_reference_dir(dirpath: str, num_sensors: int = 8) -> "ControlPlanes":
        """Load the reference's recorded per-pair correspondence files
        (`Calibration/ControlPlanes/correspondences_<a>_<b>.txt`, one row =
        [n_a (3), d_a, n_b (3), d_b, weight, conditioning] as written by
        `ControlPlanes::savePlaneCorrespondences`, reference
        `include/Calibrator.h:65`)."""
        import glob
        import re

        cp = ControlPlanes(num_sensors)
        for f in sorted(glob.glob(str(dirpath) + "/correspondences_*_*.txt")):
            m = re.search(r"correspondences_(\d)_(\d)\.txt$", f)
            if not m:
                continue
            a, b = int(m.group(1)), int(m.group(2))
            if a >= num_sensors or b >= num_sensors:
                continue
            rows = np.atleast_2d(np.loadtxt(f))
            for r in rows:
                cp.add(a, b, r[0:3], r[3], r[4:7], r[7], r[8])
        return cp


def _match_pair_planes(
    ps_a: seg_ops.PlaneSet,
    ps_b: seg_ops.PlaneSet,
    rel_guess: np.ndarray,
    angle_tol: float = 0.15,
    dist_tol: float = 0.12,
):
    """Match planes of sensor b to sensor a under the extrinsic guess
    x_a = rel_guess @ x_b; returns index pairs passing both gates."""
    va = np.asarray(ps_a.valid)
    vb = np.asarray(ps_b.valid)
    na = np.asarray(ps_a.normal)
    nb = np.asarray(ps_b.normal)
    da = np.asarray(ps_a.d)
    db = np.asarray(ps_b.d)
    r = rel_guess[:3, :3]
    t = rel_guess[:3, 3]
    nb_in_a = nb @ r.T
    db_in_a = db - nb_in_a @ t
    cos = na @ nb_in_a.T
    dd = np.abs(da[:, None] - db_in_a[None, :])
    ok = (cos > np.cos(angle_tol)) & (dd < dist_tol) & va[:, None] & vb[None, :]
    out = []
    used_b = set()
    # greedy best-cos assignment
    for _ in range(min(va.sum(), vb.sum())):
        if not ok.any():
            break
        i, j = np.unravel_index(np.argmax(np.where(ok, cos, -2)), cos.shape)
        if not ok[i, j]:
            break
        out.append((int(i), int(j)))
        ok[i, :] = False
        ok[:, j] = False
    return out


def _consensus_filter(n_a, d_a, n_b, d_b, w, min_inliers=3, angle_tol=0.04):
    """RANSAC-like consensus on the pair rotation: fit rotation on all
    correspondences, keep those whose normal residual is small, iterate
    (the `trimOutliersRANSAC` analogue, `GetControlPlanes.cpp:243`)."""
    from rgbd360_tpu_torch.calibration.solver import calibrate_pair_rotation

    keep = np.ones(len(w), bool)
    for _ in range(3):
        if keep.sum() < min_inliers:
            break
        r = calibrate_pair_rotation(n_a[keep], n_b[keep], w[keep])
        resid = 1.0 - np.sum(n_a * (n_b @ np.asarray(r).T), axis=1)
        new_keep = resid < (1.0 - np.cos(angle_tol))
        if (new_keep == keep).all():
            break
        keep = new_keep
    return keep


def make_plane_segmenter(seg_cfg: SegmentationConfig = SegmentationConfig()):
    """Per-sensor plane segmenter for calibration: (local_xyz (S, H, W, 3),
    rgb (S, H, W, 3), valid (S, H, W)) tensors -> the S sensors' plane
    sets as one PlaneSet with a leading sensor axis, in one batched call
    (the reference's OpenMP fan-out; `FrameBuilder.segment_planes`' own
    call, before its rig transform and merge)."""
    return lambda x, c, v: seg_ops.segment_planes_sensor(x, c, v, seg_cfg)


def sensor_sets(per_sensor: seg_ops.PlaneSet) -> list:
    """The per-sensor sets of a batched PlaneSet as host (numpy) PlaneSets,
    fetched in one copy per field."""
    host = per_sensor.map(lambda _, a: a.cpu().numpy())
    return [host.map(lambda _, a, s=s: a[s]) for s in range(host.valid.shape[0])]


def pair_list_for(num_sensors: int, adjacent_only: bool = True):
    return (
        [(s, (s + 1) % num_sensors) for s in range(num_sensors)]
        if adjacent_only
        else [(a, b) for a in range(num_sensors) for b in range(a + 1, num_sensors)]
    )


def add_frame_correspondences(
    cp: ControlPlanes, sets, rt_guess: np.ndarray, pair_list
) -> int:
    """Match planes across sensor couples for ONE frame and accumulate the
    correspondences (the per-grab body of the reference's online loop,
    `Calibration/OnlineCalibration.cpp:403-555`).  Returns matches added."""
    added = 0
    for a, b in pair_list:
        rel = np.linalg.inv(rt_guess[a]) @ rt_guess[b]
        matches = _match_pair_planes(sets[a], sets[b], rel)
        if not matches:
            continue
        ia = [m[0] for m in matches]
        ib = [m[1] for m in matches]
        w = np.minimum(
            np.asarray(sets[a].n_inliers)[ia], np.asarray(sets[b].n_inliers)[ib]
        )
        cp.add(
            a,
            b,
            np.asarray(sets[a].normal)[ia],
            np.asarray(sets[a].d)[ia],
            np.asarray(sets[b].normal)[ib],
            np.asarray(sets[b].d)[ib],
            w,
        )
        added += len(ia)
    return added


def consensus_trim(cp: ControlPlanes) -> None:
    """Apply the RANSAC-like consensus filter to every pair in place."""
    for key, p in list(cp.pairs.items()):
        if len(p["w"]) >= 3:
            keep = _consensus_filter(p["n_a"], p["d_a"], p["n_b"], p["d_b"], p["w"])
            for f in ("n_a", "d_a", "n_b", "d_b", "w"):
                p[f] = p[f][keep]


def collect_control_planes(
    rig_frames,
    rt_guess: np.ndarray,
    seg_cfg: SegmentationConfig = SegmentationConfig(),
    adjacent_only: bool = True,
    device=None,
) -> ControlPlanes:
    """Extract control planes from recorded frames.

    rig_frames: iterable of (local_xyz (S,H,W,3), rgb (S,H,W,3),
    valid (S,H,W)) per-sensor organized clouds in SENSOR frames (numpy
    arrays or tensors), segmented on `device` (the card when None);
    rt_guess: (S, 4, 4) current extrinsic estimates.
    """
    device = resolve_device(device)
    num_sensors = rt_guess.shape[0]
    cp = ControlPlanes(num_sensors)
    seg = make_plane_segmenter(seg_cfg)
    pairs = pair_list_for(num_sensors, adjacent_only)
    for local_xyz, rgb, valid in rig_frames:
        per_sensor = seg(*(torch.as_tensor(a, device=device) for a in (local_xyz, rgb, valid)))
        add_frame_correspondences(cp, sensor_sets(per_sensor), rt_guess, pairs)
    consensus_trim(cp)
    return cp
