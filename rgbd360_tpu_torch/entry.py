"""The port's top-level entry points (twin of `__graft_entry__.py`).

  * `entry()`: the flagship forward step (an alignment pyramid for each of
    two frames, then the dense photo+depth GN alignment) at 320x1920 with
    `DenseRegConfig(pyramid_levels=3)`: two pyramids are 2 K1 + 4 K2
    launches on the card.
  * `dryrun_multichip(n, backend, device)`: spawns n ranks and runs on them
    what the reference's `dryrun_multichip` runs on its mesh: the
    production `KeyframeSLAM` with `mesh=` (keyframe-sharded scans,
    distributed LM-PCG) beside the single-device tracker on the same
    frames, gated on the track error and on sharded == single, then each
    sharded stage on small inputs.

    python -m rgbd360_tpu_torch.entry                 # entry() on the card
    python -m rgbd360_tpu_torch.entry --dryrun 2 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.config import DenseRegConfig, MatcherConfig, default_config
from rgbd360_tpu_torch.ops import hopper_kernels as HK, se3
from rgbd360_tpu_torch.registration import dense as D

ENTRY_SHAPE = (320, 1920)
TRACK_ERR_GATE_M = 0.06  # the reference's dryrun bound against the ground truth
SHARDED_VS_SINGLE_GATE_M = 0.01  # the reference's dryrun bound, sharded against single


def _synthetic_pair(h, w, seed=0):
    """Small synthetic spherical frame pair with a known relative motion (a
    copy of `__graft_entry__._synthetic_pair`, in numpy float32)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    # texture strong enough to pass the saliency gates
    gray = (
        0.5
        + 0.25 * np.sin(xx * 0.35)
        + 0.2 * np.cos(yy * 0.45 + 1.0)
        + 0.1 * np.sin((xx + yy) * 0.2)
    )
    depth = 3.0 + 0.8 * np.sin(xx * 0.25) + 0.5 * np.cos(yy * 0.3)
    gray2 = np.roll(gray, 2, axis=1) + rng.normal(0, 0.002, (h, w))
    depth2 = np.roll(depth, 2, axis=1)
    return tuple(np.asarray(a, np.float32) for a in (gray, depth, gray2, depth2))


def entry(height: int = ENTRY_SHAPE[0], width: int = ENTRY_SHAPE[1], device=None):
    """(fwd, example_args): the forward step of the flagship pipeline,
    spherical pyramid construction + dense photo+depth GN alignment, and
    `_synthetic_pair`'s frames with an identity seed on `device` (the card
    when None).  `fwd` returns the `AlignResult`, whose `pose`, `hessian`
    and `error` are the reference's fwd's three outputs."""
    cfg = DenseRegConfig(pyramid_levels=3)
    aligner = D.DenseAligner(cfg)

    def fwd(gray1, depth1, gray2, depth2, init_pose):
        p1 = D.build_frame_pyramid(gray1, depth1, cfg)
        p2 = D.build_frame_pyramid(gray2, depth2, cfg)
        return aligner.align(p1, p2, init_pose, D.PHOTO_DEPTH)

    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev) for a in _synthetic_pair(height, width))
    return fwd, args + (torch.eye(4, device=dev),)


def _box_room_sphere(h, w, origin, half_extents=(3.0, 1.4, 4.0)):
    """Spherical gray + depth of an axis-aligned box room seen from
    `origin`, with a world-locked texture (a copy of
    `__graft_entry__._box_room_sphere`, in numpy float32)."""
    rows = np.arange(h)
    cols = np.arange(w)
    phi = (h / 2 - 0.5 - rows) * (2 * np.pi / w)
    theta = cols * (2 * np.pi / w)
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    st, ct = np.sin(theta)[None, :], np.cos(theta)[None, :]
    v = np.stack([np.broadcast_to(sp, (h, w)), -cp * st, -cp * ct], axis=-1)
    t_best = np.full((h, w), np.inf)
    for ax in range(3):
        for sign in (-1.0, 1.0):
            denom = v[..., ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * half_extents[ax] - origin[ax]) / denom
            t = np.where((t > 1e-3) & np.isfinite(t), t, np.inf)
            t_best = np.minimum(t_best, t)
    hit = origin[None, None, :] + t_best[..., None] * v
    gray = (
        0.5
        + 0.2 * np.sin(2.7 * hit[..., 0])
        + 0.18 * np.cos(3.1 * hit[..., 1] + 1.0)
        + 0.15 * np.sin(2.3 * hit[..., 2] + 0.5)
    )
    return np.asarray(gray, np.float32), np.asarray(t_best, np.float32)


def dryrun_config():
    """The dryrun tracker's configuration (the reference's): an 8x24x32
    rig, a 32x192 sphere, 2 levels, a 16-keyframe map, and every frame a
    keyframe, so each step runs the whole per-keyframe map work."""
    cfg = default_config()
    return cfg.replace(
        rig=dataclasses.replace(cfg.rig, width=32, height=24, fx=26.0, fy=26.0, cx=15.5, cy=11.5),
        sphere=dataclasses.replace(cfg.sphere, width=192, height=32),
        dense=dataclasses.replace(cfg.dense, pyramid_levels=2),
        seg=dataclasses.replace(cfg.seg, min_inliers=40),
        map=dataclasses.replace(cfg.map, max_keyframes=16, max_edges=32),
        kf=dataclasses.replace(cfg.kf, select_kf_icp_dist=1e-6, min_dist_keyframes=1e-6),
    )


def dryrun_builder(cfg, device):
    """The dryrun's frame builder: the construction-spec rig at the cut
    intrinsics."""
    from rgbd360_tpu_torch.calibration.spec import construction_spec_rt
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.calib import Calibration

    rt = np.asarray(construction_spec_rt(8), np.float64)
    calib = Calibration(
        rt=rt.astype(np.float32),
        rt_inv=np.linalg.inv(rt).astype(np.float32),
        k=np.array([[26.0, 0, 15.5], [0, 26.0, 11.5], [0, 0, 1]], np.float32),
    )
    return FrameBuilder(calib, cfg, device=device)


def _dryrun_production_tracker(mesh, device, n_frames: int = 5) -> dict:
    """N steps of the ACTUAL KeyframeSLAM with `mesh=` (keyframe-sharded
    scans, distributed LM-PCG) and of the single-device tracker on the same
    box-room frames, gated on the track error against the ground truth and
    on sharded against single."""
    from rgbd360_tpu_torch.parallel.multihost import all_hosts_agree
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM

    cfg = dryrun_config()
    builder = dryrun_builder(cfg, device)
    slam = KeyframeSLAM(builder, cfg, mesh=mesh)
    slam_ref = KeyframeSLAM(builder, cfg)
    gt = [np.array([0.04 * i, 0.0, 0.02 * i]) for i in range(n_frames)]
    pending = []
    for origin in gt:
        g, d = (torch.from_numpy(a).to(device) for a in _box_room_sphere(32, 192, origin))
        slam.process_state(slam.make_state_from_sphere(g, d))
        pending.append(len(slam._pending))
        slam_ref.process_state(slam_ref.make_state_from_sphere(g, d))
    slam.flush()
    slam_ref.flush()
    n_kf = int(slam.map.n_kf)
    if n_kf < n_frames - 1 or slam.lost:
        raise AssertionError(f"sharded production tracker: {n_kf} keyframes, lost {slam.lost}")
    opt = slam.map.opt_poses[:n_kf].cpu().numpy()
    if not np.isfinite(opt).all():
        raise AssertionError("the distributed optimizer gave non-finite poses")
    est = np.stack(slam.trajectory)[:, :3, 3]
    err = float(np.abs(est - np.stack(gt)).max())
    if not err < TRACK_ERR_GATE_M:
        raise AssertionError(f"sharded production tracker drifted {err:.3f} m")
    dev = float(np.abs(est - np.stack(slam_ref.trajectory)[:, :3, 3]).max())
    if not dev < SHARDED_VS_SINGLE_GATE_M:
        raise AssertionError(f"sharded tracker deviates {dev:.4f} m from single-device")
    agree = all_hosts_agree(float(np.stack(slam.trajectory).sum()), mesh)
    if not (agree and all_hosts_agree(float(sum(pending)), mesh)):
        raise AssertionError("the ranks' trajectories or event schedules diverged")
    return {"n_kf": n_kf, "n_edges": int(slam.map.n_edges), "track_err": err,
            "sharded_vs_single_dev_m": dev, "pending_after": pending}


def _dryrun_stages(mesh, device) -> dict:
    """Each sharded stage on small inputs: the pair-sharded GN assembly
    with a psum-reduced global step, the keyframe-sharded plane scan, the
    edge-sharded pose-graph LM and the observation-sharded planar BA."""
    from rgbd360_tpu_torch.ops.segmentation import PlaneSet
    from rgbd360_tpu_torch.parallel import sharded as S
    from rgbd360_tpu_torch.slam.graph import PoseGraph
    from rgbd360_tpu_torch.slam.plane_ba import PlaneBAProblem, predict_plane

    w_ = mesh.size
    cfg = DenseRegConfig(pyramid_levels=1)
    b, h, w = 2 * w_, 16, 128
    g1, d1, g2, d2 = (torch.from_numpy(a).to(device) for a in _synthetic_pair(h, w))
    tpyr = D.build_frame_pyramid(g2, d2, cfg)
    tpack = D._pack_target({k: getattr(tpyr, k)[0] for k in D._CHANNELS})
    hess, grad, err = S.sharded_pair_align(
        mesh, g1.expand(b, h, w), d1.expand(b, h, w), tpack.expand((b,) + tpack.shape),
        torch.eye(4, device=device).expand(b, 4, 4), cfg, D.PHOTO_DEPTH,
    )
    lo, hi = mesh.block(b)
    tot = S.psum(mesh, torch.cat([hess[lo:hi].sum(0).reshape(-1), grad[lo:hi].sum(0),
                                  err[lo:hi].sum().reshape(1)]))
    eye6 = torch.eye(6, device=device)
    global_upd = -torch.linalg.solve(tot[:36].reshape(6, 6) + 1e-3 * eye6, tot[36:42])
    if hess.shape != (b, 6, 6) or not bool(torch.isfinite(global_upd).all()):
        raise AssertionError("pair-sharded GN assembly: bad shape or non-finite step")

    n_v = 2 * w_
    graph = PoseGraph.empty(n_v, 2 * w_, device)
    rel = se3.se3_exp(torch.tensor([0.1, 0, 0, 0, 0.05, 0], device=device))
    graph.vmask[:] = True
    graph.edges_ij[: n_v - 1] = torch.stack(
        [torch.arange(n_v - 1), torch.arange(1, n_v)], 1).to(device=device, dtype=torch.int32)
    graph.rel[: n_v - 1] = rel
    graph.emask[: n_v - 1] = True
    opt_poses, chi2, _ = S.distributed_pose_graph(mesh, graph, max_iters=5)
    if not bool(torch.isfinite(opt_poses).all()):
        raise AssertionError("distributed_pose_graph: non-finite poses")

    rng = np.random.default_rng(0)
    k = 32
    normals = rng.normal(size=(k, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    hist = np.abs(rng.normal(size=(k, 37)))
    hist /= hist.sum(1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    query = PlaneSet(
        normal=t(normals), center=t(rng.uniform(-2, 2, (k, 3))), d=t(rng.uniform(0.5, 3, k)),
        curvature=t(np.full(k, 1e-4)), area=t(rng.uniform(0.5, 3, k)),
        elongation=t(np.full(k, 1.5)), n_inliers=t(np.full(k, 300.0)),
        hull=t(np.zeros((k, 16, 3))), hue_hist=t(hist), main_color=t(np.full((k, 3), 0.5)),
        valid=torch.ones(k, dtype=torch.bool, device=device),
    )
    map_planes = dataclasses.replace(query, **{
        f.name: getattr(query, f.name).expand((2 * w_,) + getattr(query, f.name).shape)
        for f in dataclasses.fields(query)})
    n_m, *_ = S.sharded_plane_scan(
        mesh, map_planes, query, torch.ones(2 * w_, dtype=torch.bool, device=device),
        MatcherConfig())
    if int(n_m[0]) < 3:
        raise AssertionError(f"sharded_plane_scan: {int(n_m[0])} matches of a set with itself")

    walls = t([[1, 0, 0, 3], [-1, 0, 0, 3], [0, 1, 0, 1.5],
               [0, -1, 0, 1.5], [0, 0, 1, 4], [0, 0, -1, 4]])
    steps = torch.arange(w_, dtype=torch.float32, device=device)[:, None]
    gt_poses = se3.se3_exp(t([0.2, 0, 0.05, 0, 0.03, 0]) * steps)
    oi = np.repeat(np.arange(w_), 6)
    ok = np.tile(np.arange(6), w_)
    wobble = 0.03 * torch.sin(torch.arange(6, device=device)[None] + steps)
    prob = PlaneBAProblem(
        poses=gt_poses @ se3.se3_exp(wobble),
        planes=walls,
        obs_kf=t(oi, torch.int64), obs_pl=t(ok, torch.int64),
        obs=predict_plane(gt_poses[t(oi, torch.int64)], walls[t(ok, torch.int64)]),
        w=torch.ones(len(oi), device=device),
    )
    ba_poses, _, ba_chi2, _ = S.distributed_plane_ba(mesh, prob, max_iters=6)
    if not bool(torch.isfinite(ba_poses).all()):
        raise AssertionError("distributed_plane_ba: non-finite poses")
    return {"batch": b, "total_err": float(tot[-1]), "graph_chi2": float(chi2),
            "plane_matches": int(n_m[0]), "plane_ba_chi2": float(ba_chi2)}


def _dryrun_rank(mesh) -> dict:
    HK.fused_gradients.launches = 0
    HK.fused_pyr_down.launches = 0
    prod = _dryrun_production_tracker(mesh, mesh.device)
    stages = _dryrun_stages(mesh, mesh.device)
    return {"production": prod, "stages": stages,
            "launches": {"fused_gradients": HK.fused_gradients.launches,
                         "fused_pyr_down": HK.fused_pyr_down.launches}}


def dryrun_multichip(n_devices: int, backend: str = "nccl", device: str = "cuda",
                     timeout: float = 900.0) -> list:
    """Run the multi-rank SLAM programs on `n_devices` spawned ranks of a
    `backend` process group on `device` (see `parallel.spawn.run_ranks`
    for the device naming: "cuda" puts rank r on card r, "cuda:0" every
    rank on card 0, which needs gloo).  Every rank runs the production
    tracker sharded and single on the same frames and the stage checks;
    any failed gate fails the call.  Returns the ranks' results (their
    gates' numbers and kernel launch counts)."""
    from rgbd360_tpu_torch.parallel.spawn import run_ranks

    if torch.device(device).type == "cuda":
        from rgbd360_tpu_torch.ops import _build

        _build.load()  # build once here, not in every rank
    results = run_ranks(_dryrun_rank, n_devices, backend, device, timeout=timeout,
                        threads=1 if torch.device(device).type == "cpu" else None)
    p, s = results[0]["production"], results[0]["stages"]
    print(f"dryrun_multichip ok: {n_devices} ranks ({backend}, {device}), production "
          f"tracker {p['n_kf']} KFs / {p['n_edges']} edges / track err {p['track_err']:.4f} m "
          f"/ sharded-vs-single {p['sharded_vs_single_dev_m']:.4f} m; stage checks: batch "
          f"{s['batch']}, total err {s['total_err']:.4f}, graph chi2 {s['graph_chi2']:.4f}, "
          f"plane matches {s['plane_matches']}, plane-BA chi2 {s['plane_ba_chi2']:.5f}; "
          f"launches per rank {[r['launches'] for r in results]}")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="run dryrun_multichip on N ranks instead of entry()")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--device", default=None,
                   help="entry(): the device (default the card); --dryrun: the ranks' "
                   "device rule (default cuda: rank r on card r)")
    args = p.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.backend, args.device or "cuda")
        return
    fn, fargs = entry(device=args.device)
    res = fn(*fargs)
    print("entry ok:", [tuple(o.shape) for o in (res.pose, res.hessian, res.error)])


if __name__ == "__main__":
    main()
