"""Extrinsic rig calibration suite (twin of `rgbd360_tpu/apps/calibrate.py`;
reference `Calibration/` apps: GetControlPlanes, Calibrator,
PairCalibrator, EvalCalibration, OnlineCalibration, OnlinePairCalibrator).

Subcommands:
  collect   — extract control planes from a capture directory
  solve     — joint 8-sensor calibration from control planes
  pair      — pairwise calibration for one sensor pair
  eval      — evaluate a calibration (residuals, conditioning) and compare
              against another (e.g. the shipped Rt files)
  online    — incremental calibration while frames stream in (reference
              `OnlineCalibration.cpp:403-677`): accumulate correspondences
              per sensor couple, track per-couple conditioning, solve as
              soon as every couple is well conditioned (threshold 8000,
              `Miscellaneous.h:76`), keep refining as data arrives.
              `--sensors A B` restricts to one couple (OnlinePairCalibrator);
              `--live` consumes a directory being written by a grabber.
  tof       — ToF/Kinect cross-calibration from a rawlog of paired 3D
              observations (reference `ToFCalibrator.cpp`): RANSAC dominant
              plane per cloud per frame, accumulate plane correspondences,
              solve the pair extrinsic.
  laser     — 2D-laser <-> rig calibration (reference `LaserCalibrator.cpp`).
  fim       — Fisher-information eigenvalues vs correspondence count (the
              reference's `FIM_eigen_vs_numCorresp.m` observability analysis).
  viz       — a calibration rendered on a rig capture.

Usage:
    python -m rgbd360_tpu_torch.apps.calibrate collect DATASET_DIR --calib C --out cp.txt
    python -m rgbd360_tpu_torch.apps.calibrate solve cp.txt --calib C --out DIR [--from-spec]
    python -m rgbd360_tpu_torch.apps.calibrate pair cp.txt --calib C --sensors 0 1
    python -m rgbd360_tpu_torch.apps.calibrate eval cp.txt --calib C
    python -m rgbd360_tpu_torch.apps.calibrate online DATASET_DIR --calib C [--live]
        [--sensors A B] [--out DIR] [--solve-every N]
    python -m rgbd360_tpu_torch.apps.calibrate tof LOG.rawlog [--out rt.txt]
    python -m rgbd360_tpu_torch.apps.calibrate laser LOG.rawlog --calib C
        (--planes planes.json | --frames DATASET_DIR) [--guess rt.txt]

Frames are built and segmented, RANSAC runs and the rotation solves run on
the CUDA device unless `--device` names another; the closed forms, the
translation solves and the laser solver run on the host, as in the
reference.  Each sub-command is `cmd_<name>(args, builder=None)`; a
`builder` given to `main` replaces the one made from `--calib` (a test's
small rig).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.apps._common import add_calib_args, add_device_arg, frame_config, load_calib


def _builder(args, builder=None):
    """The FrameBuilder of the sub-command: `builder` when given, else one
    from `--calib` on `--device` (the card when unset)."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder

    if builder is not None:
        return builder
    return FrameBuilder(load_calib(args), frame_config(args), device=args.device)


def _builder_rt(builder) -> np.ndarray:
    """The builder's extrinsics (S, 4, 4) as float64 numpy."""
    return builder.rt.cpu().numpy().astype(np.float64)


def cmd_collect(args, builder=None):
    from rgbd360_tpu_torch.calibration import collect_control_planes
    from rgbd360_tpu_torch.io.dataset import SequenceDataset

    builder = _builder(args, builder)
    ds = SequenceDataset(args.dataset)
    frames = []
    for raw in ds:
        f = builder.build_from_raw(raw)
        frames.append((f.local_xyz, f.cloud_rgb, f.cloud_valid))
    cp = collect_control_planes(frames, _builder_rt(builder), builder.config.seg,
                                device=builder.sensor.device)
    total = sum(cp.count(a, b) for (a, b) in cp.pairs)
    for (a, b) in sorted(cp.pairs):
        print(f"pair ({a},{b}): {cp.count(a, b)} correspondences")
    cp.save(args.out)
    print(f"saved {total} control planes to {args.out}")
    return cp


def cmd_solve(args, builder=None):
    from rgbd360_tpu_torch.calibration import RigCalibrator
    from rgbd360_tpu_torch.calibration.control_planes import ControlPlanes

    cp = ControlPlanes.load(args.control_planes)
    rt0 = None
    if not args.from_spec:
        calib = load_calib(args)
        rt0 = np.asarray(calib.rt, np.float64)
    rt, diag = RigCalibrator(device=args.device).calibrate(cp, rt0, prior_weight=args.prior)
    print(f"conditioning={diag['conditioning']:.1f} "
          f"(ok={diag['well_conditioned']}), rot_error={diag['rot_error']:.5f}, "
          f"n={diag['n_correspondences']}")
    if args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        for s in range(rt.shape[0]):
            np.savetxt(outdir / f"Rt_0{s + 1}.txt", rt[s], fmt="%9.6f")
        print(f"wrote Rt_0*.txt to {outdir}")
    return rt


def _resolve_pair(cp, a: int, b: int):
    """Look up the (a, b) couple in either stored order."""
    key = (a, b) if (a, b) in cp.pairs else (b, a)
    if key not in cp.pairs:
        raise SystemExit(f"no correspondences for pair {a},{b}")
    return key, cp.pairs[key]


def cmd_pair(args, builder=None):
    from rgbd360_tpu_torch.calibration import PairCalibrator
    from rgbd360_tpu_torch.calibration.control_planes import ControlPlanes

    cp = ControlPlanes.load(args.control_planes)
    key, p = _resolve_pair(cp, *args.sensors)
    rt, diag = PairCalibrator(device=args.device).calibrate(
        p["n_a"], p["d_a"], p["n_b"], p["d_b"], p["w"])
    print(f"pair {key}: conditioning={diag['conditioning']:.1f} "
          f"rot_error={diag['rot_error']:.6f}")
    print(np.round(rt, 5))
    return rt


def cmd_eval(args, builder=None):
    """Per pair: correspondences, conditioning and the residuals of the
    calibration; returns {(a, b): (n, conditioning, rot, trans)}."""
    from rgbd360_tpu_torch.calibration.control_planes import ControlPlanes
    from rgbd360_tpu_torch.calibration.solver import conditioning

    cp = ControlPlanes.load(args.control_planes)
    calib = load_calib(args)
    rt = np.asarray(calib.rt, np.float64)
    rows = {}
    print("pair  n   conditioning  rot_residual  trans_residual")
    for (a, b), p in sorted(cp.pairs.items()):
        rel = np.linalg.inv(rt[a]) @ rt[b]
        nb_in_a = p["n_b"] @ rel[:3, :3].T
        rot_res = float(np.mean(1.0 - np.sum(p["n_a"] * nb_in_a, axis=1)))
        # offset residual: n_a.t = d_b' - d_a with d_b' = d_b - nb_in_a.t ...
        db_in_a = p["d_b"] - nb_in_a @ rel[:3, 3]
        t_res = float(np.mean(np.abs(p["d_a"] - db_in_a)))
        rows[(a, b)] = (len(p["w"]), conditioning(p["n_a"]), rot_res, t_res)
        print(f"({a},{b})  {len(p['w']):3d}  {conditioning(p['n_a']):10.1f}  "
              f"{rot_res:.6f}      {t_res:.4f}")
    return rows


def cmd_viz(args, builder=None):
    """Visualize a calibration on a rig capture (reference
    `Calibration/VisualizeCalibration.cpp`): per-sensor clouds transformed
    by the extrinsics into the rig frame, colored by sensor id, written as
    a PLY; plus the stitched panorama with sensor seams overlaid — seam
    discontinuities or doubled surfaces in either output mean the
    calibration is off."""
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame
    from rgbd360_tpu_torch.ops import stitch as stitch_ops
    from rgbd360_tpu_torch.utils.viz import AREA_COLORS, bgr_to_rgb, save_ply, save_png

    builder = _builder(args, builder)
    f = builder.build_from_raw(read_rig_frame(args.frame))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # per-sensor clouds in the rig frame, colored by sensor
    xyz = f.cloud_xyz.cpu().numpy()  # (S, h, w, 3)
    ok = f.cloud_valid.cpu().numpy()
    pts, cols = [], []
    for s in range(xyz.shape[0]):
        p = xyz[s][ok[s]]
        pts.append(p)
        cols.append(np.broadcast_to(AREA_COLORS[s % len(AREA_COLORS)], p.shape))
    n = save_ply(out / "rig_by_sensor.ply", np.vstack(pts), np.vstack(cols))

    # stitched panorama with seam columns marked
    img = bgr_to_rgb(f.sphere_rgb.cpu().numpy()).copy()
    seam = ~stitch_ops.seam_mask_from_maps(builder.maps, 1).cpu().numpy()
    img[seam] = (img[seam] * 0.3 + np.array([255, 0, 0]) * 0.7).astype(img.dtype)
    save_png(out / "stitch_seams.png", img)
    print(
        f"{n} rig points (colored by sensor) -> {out / 'rig_by_sensor.ply'}; "
        f"seam-overlaid panorama -> {out / 'stitch_seams.png'}"
    )
    return n


def cmd_online(args, builder=None):
    """Incremental calibration loop (reference `OnlineCalibration::run` —
    grab, segment, match couples, update conditioning, calibrate when every
    couple is observable; `Calibration/OnlineCalibration.cpp:403-677`)."""
    from rgbd360_tpu_torch.calibration import RigCalibrator, PairCalibrator
    from rgbd360_tpu_torch.calibration.control_planes import (
        ControlPlanes,
        add_frame_correspondences,
        consensus_trim,
        make_plane_segmenter,
        pair_list_for,
        sensor_sets,
    )
    from rgbd360_tpu_torch.calibration.solver import conditioning
    from rgbd360_tpu_torch.io.dataset import SequenceDataset, StreamingDataset

    builder = _builder(args, builder)
    device = builder.sensor.device
    rt_guess = _builder_rt(builder)
    num_sensors = rt_guess.shape[0]
    pair_only = tuple(args.sensors) if args.sensors else None
    pairs = (
        [pair_only] if pair_only else pair_list_for(num_sensors, adjacent_only=True)
    )
    threshold = args.threshold_conditioning
    cp = ControlPlanes(num_sensors)
    seg = make_plane_segmenter(builder.config.seg)
    ds = (
        StreamingDataset(args.dataset, idle_timeout=args.idle_timeout)
        if args.live
        else SequenceDataset(args.dataset)
    )

    rt = rt_guess.copy()
    solved = False
    for i, raw in enumerate(ds):
        f = builder.build_from_raw(raw)
        sets = sensor_sets(seg(f.local_xyz, f.cloud_rgb, f.cloud_valid))
        added = add_frame_correspondences(cp, sets, rt_guess, pairs)
        conds = {
            (a, b): (conditioning(cp.pairs[(a, b)]["n_a"])
                     if (a, b) in cp.pairs and cp.count(a, b) >= 3 else np.inf)
            for (a, b) in pairs
        }
        worst = max(conds.values())
        print(
            f"frame {i}: +{added} matches, total "
            f"{sum(cp.count(a, b) for a, b in cp.pairs)}, "
            f"worst conditioning {worst:.1f}"
            + ("" if worst < threshold else f" (> {threshold:.0f}, keep moving)")
        )
        ready = worst < threshold
        if ready and (not solved or (i + 1) % args.solve_every == 0):
            consensus_trim(cp)
            if pair_only:
                a, b = pair_only
                key = (a, b) if (a, b) in cp.pairs else (b, a)
                pdata = cp.pairs[key]
                rel0 = np.linalg.inv(rt_guess[key[0]]) @ rt_guess[key[1]]
                rel, diag = PairCalibrator(threshold, device).calibrate(
                    pdata["n_a"], pdata["d_a"], pdata["n_b"], pdata["d_b"],
                    pdata["w"], r0=rel0[:3, :3],
                )
                print(f"  pair {key} solved: conditioning="
                      f"{diag['conditioning']:.1f} rot_error={diag['rot_error']:.6f}")
                rt = rt_guess.copy()
                rt[key[1]] = rt[key[0]] @ np.asarray(rel)
            else:
                rt, diag = RigCalibrator(
                    num_sensors, threshold, device
                ).calibrate(cp, rt_guess)
                print(f"  rig solved: conditioning={diag['conditioning']:.1f} "
                      f"rot_error={diag['rot_error']:.5f} "
                      f"n={diag['n_correspondences']}")
            solved = True
    if not solved:
        print("never reached conditioning threshold — gather more varied views")
    elif args.out:
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        for s in range(rt.shape[0]):
            np.savetxt(outdir / f"Rt_0{s + 1}.txt", rt[s], fmt="%9.6f")
        cp.save(str(outdir / "control_planes.txt"))
        print(f"wrote Rt_0*.txt + control_planes.txt to {outdir}")
    return rt if solved else None


def cmd_fim(args, builder=None):
    """Observability analysis: Fisher-information eigenvalues as a function
    of the number of accumulated correspondences (the reference's
    `FIM_eigen_vs_numCorresp.m` analysis artifact, which plots
    sqrt(eig(FIM_rot)) and 1/sqrt(min eig) against correspondence count from
    a dumped FIM table).  Writes a CSV with, per prefix length n: the three
    rotation-FIM eigenvalues, the three translation-FIM eigenvalues, and the
    1-sigma uncertainty proxy 1/sqrt(min eig)."""
    from rgbd360_tpu_torch.calibration.control_planes import ControlPlanes

    cp = ControlPlanes.load(args.control_planes)
    key, p = _resolve_pair(cp, *args.sensors)
    calib = load_calib(args)
    rt = np.asarray(calib.rt, np.float64)
    rel = np.linalg.inv(rt[key[0]]) @ rt[key[1]]
    n_total = len(p["w"])
    # The FIM is additive per correspondence, so all prefix FIMs come from
    # ONE cumulative sum of per-correspondence contributions (solver.py
    # fim_rotation/fim_translation semantics):
    #   rotation:     w * skew(Rn) skew(Rn)^T = w * (|Rn|^2 I - Rn Rn^T)
    #   translation:  w * n n^T
    w = np.asarray(p["w"], np.float64)[:, None, None]
    rn = np.asarray(p["n_b"], np.float64) @ rel[:3, :3].T
    sq = np.einsum("ki,ki->k", rn, rn)[:, None, None]
    c_rot = w * (sq * np.eye(3) - np.einsum("ki,kj->kij", rn, rn))
    n_a = np.asarray(p["n_a"], np.float64)
    c_tr = w * np.einsum("ki,kj->kij", n_a, n_a)
    er = np.linalg.eigvalsh(np.cumsum(c_rot, axis=0))  # (N, 3) ascending
    et = np.linalg.eigvalsh(np.cumsum(c_tr, axis=0))
    rows = np.column_stack([np.arange(1, n_total + 1), er, et])
    unc_rot = 1.0 / np.sqrt(np.maximum(rows[:, 1], 1e-12))
    unc_trans = 1.0 / np.sqrt(np.maximum(rows[:, 4], 1e-12))
    table = np.column_stack([rows, unc_rot, unc_trans])
    header = ("n,rot_eig0,rot_eig1,rot_eig2,trans_eig0,trans_eig1,trans_eig2,"
              "rot_sigma,trans_sigma")
    if args.out:
        np.savetxt(args.out, table, fmt="%.6g", delimiter=",",
                   header=header, comments="")
        print(f"wrote {len(table)} rows to {args.out}")
    last = table[-1]
    print(f"pair {key}: n={n_total}  rot eigs {last[1]:.3g}/{last[2]:.3g}/"
          f"{last[3]:.3g}  trans eigs {last[4]:.3g}/{last[5]:.3g}/{last[6]:.3g}")
    print(f"1-sigma (worst axis): rotation {last[7]:.4f} rad, "
          f"translation {last[8]:.4f} m")
    return table


def cmd_laser(args, builder=None):
    """Laser(2D scanner)/ToF <-> rig extrinsic calibration from a rawlog of
    scans + rig-observed planes (reference `Calibration/LaserCalibrator.cpp`
    / `ToFCalibrator.cpp`): associate scan points to the rig's planes under
    the current guess, solve point-on-plane SE(3) GN, re-associate, repeat."""
    import json

    from rgbd360_tpu_torch.calibration.laser import LaserCalibrator
    from rgbd360_tpu_torch.io.rawlog import Obs2DRangeScan, read_rawlog

    # scan points in the laser frame (2D scans: z = 0)
    pts = []
    for obs in read_rawlog(args.rawlog):
        if not isinstance(obs, Obs2DRangeScan):
            continue
        n = len(obs.ranges)
        if n == 0:
            continue
        ang = -obs.aperture / 2 + np.arange(n) * (obs.aperture / max(n - 1, 1))
        if not obs.right_to_left:
            ang = ang[::-1]
        ok = (np.asarray(obs.validity) > 0) & (obs.ranges > 0.1) & (
            obs.ranges < obs.max_range
        )
        r = np.asarray(obs.ranges)[ok]
        a = ang[ok]
        pts.append(np.stack([r * np.cos(a), r * np.sin(a), np.zeros(len(r))], -1))
    if not pts:
        raise SystemExit("no 2D range scans in rawlog")
    scan = np.concatenate(pts).astype(np.float64)

    # rig planes: from a JSON file or segmented from a capture frame
    if args.planes:
        data = json.load(open(args.planes))
        normals = np.asarray([p["n"] for p in data], np.float64)
        ds = np.asarray([p["d"] for p in data], np.float64)
    else:
        from rgbd360_tpu_torch.io.dataset import SequenceDataset

        builder = _builder(args, builder)
        dset = SequenceDataset(args.frames)
        f = builder.build_from_raw(dset[0])
        ps = builder.segment_planes(f)
        valid = ps.valid.cpu().numpy()
        normals = ps.normal.cpu().numpy()[valid].astype(np.float64)
        ds = ps.d.cpu().numpy()[valid].astype(np.float64)
    print(f"{len(scan)} scan points, {len(normals)} rig planes")

    rt = np.asarray(np.loadtxt(args.guess) if args.guess else np.eye(4), np.float64)
    for it in range(args.iters):
        # associate each point to its nearest plane under the current guess
        q = scan @ rt[:3, :3].T + rt[:3, 3]
        dist = np.abs(q @ normals.T + ds[None, :])
        idx = np.argmin(dist, axis=1)
        best = dist[np.arange(len(scan)), idx]
        keep = best < args.assoc_tol
        if keep.sum() < 10:
            raise SystemExit(
                f"only {keep.sum()} points associate within {args.assoc_tol} m "
                "— provide a better --guess"
            )
        rt_new, diag = LaserCalibrator().calibrate(
            normals, ds, scan[keep], idx[keep], rt0=rt
        )
        rt = np.asarray(rt_new, np.float64)
        print(
            f"iter {it}: {int(keep.sum())} assoc, rms {diag['rms']:.4f} m, "
            f"conditioning {diag['conditioning']:.1f}"
        )
    if args.out:
        np.savetxt(args.out, rt, fmt="%9.6f")
        print(f"wrote laser->rig extrinsic to {args.out}")
    return rt


def cmd_tof(args, builder=None):
    """ToF/Kinect cross-calibration (reference `ToFCalibrator.cpp:162-284`):
    pair the two labeled 3D observations per frame, RANSAC the dominant
    plane of each cloud, save the correspondence matrix, solve the pair."""
    from rgbd360_tpu_torch.calibration.tof import calibrate_tof, collect_tof_correspondences

    def load_k(path):
        return None if path is None else np.loadtxt(path).reshape(3, 3)

    corresp = collect_tof_correspondences(
        args.rawlog,
        labels=tuple(args.labels),
        k_a=load_k(args.k_a),
        k_b=load_k(args.k_b),
        dist_threshold=args.dist_threshold,
        device=args.device,
    )
    print(f"{len(corresp)} plane correspondences from {args.rawlog}")
    if args.corresp_out:
        np.savetxt(args.corresp_out, corresp)
        print(f"wrote correspondence matrix to {args.corresp_out}")
    if len(corresp) < 3:
        raise SystemExit("not enough correspondences to solve (need >= 3)")
    rt, diag = calibrate_tof(corresp, device=args.device)
    np.set_printoptions(precision=6, suppress=True)
    print(f"conditioning {diag['conditioning']:.1f} "
          f"({'ok' if diag['well_conditioned'] else 'ILL-CONDITIONED'}), "
          f"rot residual {diag['rot_error']:.2e}")
    print(f"{args.labels[1]} -> {args.labels[0]} extrinsic:\n{rt}")
    if args.out:
        np.savetxt(args.out, rt, fmt="%9.6f")
        print(f"wrote extrinsic to {args.out}")
    return rt


def main(argv=None, builder=None):
    """Parse `argv` and run the sub-command; returns its result.  `builder`
    replaces the one made from `--calib` (a test's small rig)."""
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("collect")
    pc.add_argument("dataset")
    pc.add_argument("--out", required=True)
    add_calib_args(pc)
    pc.set_defaults(fn=cmd_collect)

    ps = sub.add_parser("solve")
    ps.add_argument("control_planes")
    ps.add_argument("--out", default=None)
    ps.add_argument("--from-spec", action="store_true",
                    help="seed from the construction spec instead of Rt files")
    ps.add_argument("--prior", type=float, default=0.0,
                    help="quadratic prior weight anchoring to the seed "
                    "(use >0 to refine an existing calibration from sparse data)")
    add_calib_args(ps)
    ps.set_defaults(fn=cmd_solve)

    pp = sub.add_parser("pair")
    pp.add_argument("control_planes")
    pp.add_argument("--sensors", type=int, nargs=2, required=True)
    add_calib_args(pp)
    pp.set_defaults(fn=cmd_pair)

    pe = sub.add_parser("eval")
    pe.add_argument("control_planes")
    add_calib_args(pe)
    pe.set_defaults(fn=cmd_eval)

    pv = sub.add_parser("viz", help="render a calibration on a rig capture")
    pv.add_argument("frame", help=".bin rig capture")
    pv.add_argument("--out", required=True)
    add_calib_args(pv)
    pv.set_defaults(fn=cmd_viz)

    po = sub.add_parser("online")
    po.add_argument("dataset")
    po.add_argument("--live", action="store_true",
                    help="stream a directory as a grabber writes it")
    po.add_argument("--idle-timeout", type=float, default=10.0)
    po.add_argument("--sensors", type=int, nargs=2, default=None,
                    help="calibrate only this couple (OnlinePairCalibrator)")
    po.add_argument("--solve-every", type=int, default=5,
                    help="re-solve every N frames once conditioned")
    po.add_argument("--threshold-conditioning", type=float, default=8000.0)
    po.add_argument("--out", default=None)
    add_calib_args(po)
    po.set_defaults(fn=cmd_online)

    pf = sub.add_parser("fim")
    pf.add_argument("control_planes")
    pf.add_argument("--sensors", type=int, nargs=2, required=True)
    pf.add_argument("--out", default=None, help="CSV output path")
    add_calib_args(pf)
    pf.set_defaults(fn=cmd_fim)

    pt = sub.add_parser("tof")
    pt.add_argument("rawlog", help="rawlog with paired CObservation3DRangeScan")
    pt.add_argument("--labels", nargs=2, default=["KINECT", "CAM3D"],
                    help="sensor labels of the pair (ToFCalibrator.cpp:191-198)")
    pt.add_argument("--k-a", default=None, help="3x3 intrinsics file for label A "
                    "(default: VGA-scaled 525 focal, centered)")
    pt.add_argument("--k-b", default=None, help="3x3 intrinsics file for label B")
    pt.add_argument("--dist-threshold", type=float, default=0.03,
                    help="RANSAC inlier distance (PCL default in the reference)")
    pt.add_argument("--corresp-out", default=None,
                    help="save the (C, 8) correspondence matrix (correspondences.txt)")
    pt.add_argument("--out", default=None, help="save the solved 4x4 extrinsic")
    pt.set_defaults(fn=cmd_tof)

    pl = sub.add_parser("laser")
    pl.add_argument("rawlog", help="rawlog containing CObservation2DRangeScan")
    pl.add_argument("--planes", default=None,
                    help="JSON [{'n': [x,y,z], 'd': d}, ...] rig planes; "
                    "default: segment from --frames capture")
    pl.add_argument("--frames", default=None,
                    help="capture dir to segment rig planes from")
    pl.add_argument("--guess", default=None, help="initial laser->rig Rt file")
    pl.add_argument("--iters", type=int, default=3)
    pl.add_argument("--assoc-tol", type=float, default=0.15)
    pl.add_argument("--out", default=None)
    add_calib_args(pl)
    pl.set_defaults(fn=cmd_laser)

    for sp in (pc, ps, pp, pe, pv, po, pf, pt, pl):
        add_device_arg(sp)
    args = p.parse_args(argv)
    return args.fn(args, builder)


if __name__ == "__main__":
    main()
