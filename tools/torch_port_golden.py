"""Write the JAX goldens that `chip_smoke.py` holds the port against.

Runs the reference package (`rgbd360_tpu`) on the CPU over the synthetic
sequence of `rgbd360_tpu_torch.synthetic` at full size (8x240x320 rig,
320x1920 sphere, 5 levels), so the card machine, which has no jax, needs
only the files in `rgbd360_tpu_torch/data/`:

* `smoke_golden.npz`, the slice: `FrameBuilder.build_with_pyramid` per
  frame and `DenseAligner.align` (`DenseRegConfig()`) per consecutive pair
  with a constant-velocity seed.  Per-pair poses, Hessians, errors,
  iteration counts, SSO and ill-posed flags.
* `batch_golden.npz`, the batched tracking path exactly as the reference's
  `pipeline_batch4` bench runs it (`bench.py:84-94`):
  `_build_gray_depth_batch_impl` -> `build_frame_pyramid_batch` ->
  `jax.vmap(aligner._align_impl)` with `DenseRegConfig(salient_pixels=
  16384)`, frames 1-4 against keyframe 0, each seeded one 0.1 m step short
  of its offset (the keyframe tracker's motion-model seed); on the same
  frames, `batch_align_targets` of frame 4 against frames 0-3, and
  `coarse_errors` / `coarse_align` of frame 1 against frame 0 over a yaw
  grid (the tracker rescue of `slam/odometry.py:379`).
  The reference's salient solve has several solutions within reach of
  rounding: seeds moved by a micrometre end up to a centimetre away
  (PERF.md, Findings).  So every batch golden is also written for jittered
  seeds (the `*_branch_*` keys; branch 0 unjittered, see `jitters`), and
  the port on the card must land on one of those solutions.
* `odometry_golden.npz`, the reference `FrameToFrameOdometry` (default
  config: bilateral on, dense sweeps) over the 6 captures, each through
  `process(raw)`: per tracked frame the output (`rel`, `tracked`,
  `pb_matches`, `av_depth_residual`, `sso`), the PbMap result (`pb_success`,
  `pb_pose`, `pb_pairs`), the seeds the seed chain tried (`seeds`, cut by
  `seed_counts`), and per frame the plane set (`planes_*`).  The seeds and
  the PbMap result are recorded by wrapping the tracker's `aligner.align`
  and `plane_reg.register` here; the reference package is not edited.
* `keyframe_golden.npz`, the reference `KeyframeSLAM` (default config, map
  capacity 64 / 512) over a closed loop of LOOP_FRAMES raw captures in the
  octagon room (`synthetic.loop_captures`), each through `process(raw)`,
  then `flush()`: once with the deferred keyframe events (`loop_async_*`,
  the default) and once with synchronous ones (`loop_sync_*`); per run the
  per-frame flags, the sorted edge list with the edges' measured poses, the
  areas, both trajectories, the final chi2 and the per-keyframe event
  counts (`keyframe_record`).  The
  kidnap run (`kidnap_*`): `synthetic.kidnap_captures` of the same loop
  (frames 0-9, a blind capture, frames 18-21), with the frames at which the
  yaw rescue ran (recorded by wrapping the tracker's `aligner.coarse_align`;
  the reference package is not edited).  The solvers alone (`ring64_*`,
  `ring256_*`): `synthetic.ring_graph` at capacity 64 through
  `optimize_pose_graph` and at 256 through `optimize_pose_graph_pcg`, both
  with DCS.  The loop closures' verifications (`lc_verify_*`): the
  synchronous run's accepted closures, each verified again from seeds moved
  by micrometres (`jitters()[:LC_VERIFY_JITTERS]`; the verification is the
  salient solve, see `batch_golden.npz`), their inputs recorded by wrapping
  the tracker's `loop_closer.verify_dispatch`.
* `reference_stitch_maps.npz`, the reference builder's stitch maps, which
  the batch phases load into the port's builder
  (`convert.stitch_maps_state_dict`): the two packages' maps differ on the
  sensor-tie columns and by ulps in `scale`, and the salient sweeps turn
  that into centimetres, so the batch goldens are compared on the same
  maps.

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py \
        [--batch-only | --odometry-only | --keyframe-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rgbd360_tpu.core.frame import RigFrame  # noqa: E402
from rgbd360_tpu.ops import se3  # noqa: E402
from rgbd360_tpu.ops import stitch as stitch_ops  # noqa: E402
from rgbd360_tpu.io.bin_format import RawRigFrame  # noqa: E402
from rgbd360_tpu.registration import dense as D  # noqa: E402
from rgbd360_tpu.slam.odometry import FrameToFrameOdometry  # noqa: E402
from rgbd360_tpu_torch import synthetic  # noqa: E402
from _reference import reference_builder  # noqa: E402

DATA = ROOT / "rgbd360_tpu_torch" / "data"
BATCH_FRAMES = 5  # keyframe 0 and a batch of 4
YAW_HYPOTHESES = 8
JITTER_M = (1e-6, 1e-5)  # along each axis
RANDOM_JITTERS = 160  # and in seeded random directions, JITTER_M[0] long
# golden key -> AlignResult field
_FIELDS = {"poses": "pose", "hessians": "hessian", "errors": "error",
           "iters": "iters", "ill_posed": "ill_posed", "sso": "sso"}
walk_seeds = synthetic.walk_seeds


def track_pairs_jax(n_frames: int, subsample: int = 1, pyramid_levels: int = 5) -> dict:
    """The reference's run of the smoke's slice (see the module doc)."""
    builder = reference_builder(synthetic.config(subsample, pyramid_levels))
    aligner = D.DenseAligner(builder.config.dense)
    pyrs = [
        builder.build_with_pyramid(RigFrame(jnp.asarray(rgb), jnp.asarray(d)))[1]
        for rgb, d in synthetic.captures(n_frames, subsample)
    ]
    seed = jnp.eye(4)
    out = {k: [] for k in _FIELDS}
    for i in range(1, n_frames):
        res = jax.device_get(
            aligner.align(pyrs[i], pyrs[i - 1], seed, method=D.PHOTO_DEPTH)
        )
        seed = jnp.asarray(res.pose)
        for k, f in _FIELDS.items():
            out[k].append(getattr(res, f))
    return {k: np.asarray(v) for k, v in out.items()}


def _result(res, prefix: str) -> dict:
    res = jax.device_get(res)
    return {f"{prefix}_{k}": np.asarray(getattr(res, f)) for k, f in _FIELDS.items()}


def jitters() -> np.ndarray:
    """(P, 3) seed translations of the golden's branches: none, +-JITTER_M
    along each axis, then RANDOM_JITTERS seeded random directions.  Some
    solutions are rare (one in 40 random micrometre jitters reached the
    one the H100 took for target 1), hence the many samples."""
    out = [np.zeros(3)]
    for eps in JITTER_M:
        for axis in range(3):
            for sign in (1.0, -1.0):
                out.append(np.eye(3)[axis] * sign * eps)
    rnd = np.random.default_rng(0).normal(size=(RANDOM_JITTERS, 3))
    out.extend(rnd / np.linalg.norm(rnd, axis=1, keepdims=True) * JITTER_M[0])
    return np.stack(out).astype(np.float32)


def _jittered(poses: np.ndarray, j: np.ndarray) -> np.ndarray:
    poses = np.array(poses, np.float32)
    poses[:, :3, 3] += j
    return poses


def _branches(run, prefix: str, jittered: bool, keys=("poses", "iters")) -> dict:
    """The branch-0 results under `prefix`, and every branch's `keys` under
    `prefix_branch_*` (branch 0 only unless `jittered`); run(j) returns one
    result dict for jitter j."""
    runs = [run(j) for j in (jitters() if jittered else jitters()[:1])]
    out = dict(runs[0])
    for k in keys:
        out[f"{prefix}_branch_{k}"] = np.stack([r[f"{prefix}_{k}"] for r in runs])
    return out


def batch_jax(subsample: int = 1, pyramid_levels: int = 5,
              salient_pixels: int = synthetic.BATCH_SALIENT_PIXELS,
              jittered: bool = True) -> dict:
    """The reference's run of the batch phase (see the module doc); without
    `jittered`, the branch keys hold branch 0 only."""
    builder = reference_builder(synthetic.config(subsample, pyramid_levels))
    cfg = builder.config
    aligner = D.DenseAligner(dataclasses.replace(cfg.dense, salient_pixels=salient_pixels))
    caps = synthetic.captures(BATCH_FRAMES, subsample)
    pyrs = [
        builder.build_with_pyramid(RigFrame(jnp.asarray(rgb), jnp.asarray(d)))[1]
        for rgb, d in caps
    ]
    seam_levels = D.seam_masks_per_level(
        stitch_ops.seam_mask_from_maps(builder.maps, 1), cfg.dense.pyramid_levels
    )
    rgbs = jnp.asarray(np.stack([rgb for rgb, _ in caps[1:]]))
    depths = jnp.asarray(np.stack([d for _, d in caps[1:]]))
    n = len(caps) - 1

    @jax.jit
    def pipeline(params, rgbs, depths, trg, seeds):
        sg_b, sd_b = builder._build_gray_depth_batch_impl(params, rgbs, depths)
        pyr_b = D.build_frame_pyramid_batch(sg_b, sd_b, cfg.dense, seam_levels)
        return jax.vmap(
            lambda p, s: aligner._align_impl(p, trg, s, D.PHOTO_DEPTH)
        )(pyr_b, seeds)

    seeds = walk_seeds(0.1 * np.arange(n))
    out = _branches(lambda j: _result(pipeline(
        builder._params, rgbs, depths, pyrs[0], jnp.asarray(_jittered(seeds, j))
    ), "batch"), "batch", jittered)
    # frame 4 against frames 0-3, each seeded one step short
    seeds = walk_seeds(0.1 * np.arange(n - 1, -1, -1))
    out.update(_branches(lambda j: _result(D.batch_align_targets(
        aligner, pyrs[n], pyrs[:n], list(_jittered(seeds, j))
    ), "targets"), "targets", jittered))
    cands = se3.yaw_grid(YAW_HYPOTHESES).astype(np.float32)
    out["coarse_candidates"] = cands
    out["coarse_static_errors"] = np.asarray(
        aligner.coarse_errors(pyrs[1], pyrs[0], jnp.asarray(cands))
    )

    def coarse(j):
        poses, errs = aligner.coarse_align(pyrs[1], pyrs[0], jnp.asarray(_jittered(cands, j)))
        return {"coarse_poses": np.asarray(poses), "coarse_errors": np.asarray(errs)}

    out.update(_branches(coarse, "coarse", jittered, ("poses", "errors")))
    return out


def odometry_jax(n_frames: int = 6, subsample: int = 1, pyramid_levels: int = 5,
                 config=None) -> dict:
    """The reference's run of the smoke's odometry phase (see the module
    doc); `config` replaces the synthetic configuration (e.g. a low
    `fallback_error`, which drives the seed chain to the yaw rescue); both
    are the port's `FrameworkConfig`."""
    cfg = config or synthetic.config(subsample, pyramid_levels)
    tracker = FrameToFrameOdometry(reference_builder(cfg))
    seeds, pbs = [], []
    align, register = tracker.aligner.align, tracker.plane_reg.register

    def record_align(src, trg, init_pose=None, *args, **kw):
        seeds[-1].append(np.asarray(init_pose, np.float32))
        return align(src, trg, init_pose, *args, **kw)

    def record_register(*args, **kw):
        pbs.append(jax.device_get(register(*args, **kw)))
        return pbs[-1]

    tracker.aligner.align = record_align
    tracker.plane_reg.register = record_register
    planes = []
    for rgb, d in synthetic.captures(n_frames, subsample):
        seeds.append([])
        tracker.process(RawRigFrame(rgb=rgb, depth_mm=d))
        planes.append(jax.device_get(tracker.prev.planes))
    stats = tracker.stats
    out = {
        "rel": np.stack([i["rel"] for i in stats]).astype(np.float32),
        "tracked": np.array([i["tracked"] for i in stats]),
        "pb_matches": np.array([i["pb_matches"] for i in stats]),
        "av_depth_residual": np.array([i["av_depth_residual"] for i in stats]),
        "sso": np.array([i["sso"] for i in stats]),
        "pb_success": np.array([bool(p.success) for p in pbs]),
        "pb_pose": np.stack([np.asarray(p.pose) for p in pbs]),
        "pb_pairs": np.stack([np.asarray(p.pairs) for p in pbs]),
        "seed_counts": np.array([len(s) for s in seeds[1:]]),
        "seeds": np.stack([x for s in seeds[1:] for x in s]),
    }
    for f in ("normal", "center", "area", "valid"):
        out[f"planes_{f}"] = np.stack([np.asarray(getattr(p, f)) for p in planes])
    return out


LOOP_FRAMES = synthetic.KIDNAP_LOOP_FRAMES  # the kidnap run shares the loop's captures


def keyframe_record(slam, gt=None) -> dict:
    """What a finished `KeyframeSLAM` run is compared on (call after
    `flush()`): the keys of `chip_smoke.keyframe_record`."""
    from rgbd360_tpu.slam.graph import graph_chi2

    ev = slam.events
    n_kf, n_e = int(slam.map.n_kf), int(slam.map.n_edges)
    edges = np.concatenate(
        [np.asarray(slam.map.graph.edges_ij)[:n_e],
         np.asarray(slam.map.edge_is_lc)[:n_e, None].astype(np.int32)], axis=1)
    kf_ev = [e for e in ev if e["keyframe"]]
    order = np.lexsort(edges.T[::-1])  # stable: equal (i, j, is_lc) keep their order
    out = {
        "keyframe": np.array([e["keyframe"] for e in ev]),
        "lost": np.array([bool(e.get("lost", False)) for e in ev]),
        "relocalized": np.array([bool(e["relocalized"]) for e in ev]),
        "edges": edges[order],
        "edge_rel": np.asarray(slam.map.graph.rel)[:n_e][order],
        "n_loop_closures": np.int64(slam.n_loop_closures),
        "area": np.asarray(slam.map.area)[:n_kf],
        "n_areas": np.int64(int(slam.map.n_areas)),
        "trajectory": np.stack(slam.trajectory).astype(np.float32),
        "optimized_trajectory": slam.optimized_trajectory().astype(np.float32),
        "opt_poses": np.asarray(slam.map.opt_poses)[:n_kf],
        "chi2": np.float32(graph_chi2(slam.map.graph)),
        "fused_track": np.int64(slam.timer.counts.get("fused_track", 0)),
        "connections": np.array([e.get("connections", 0) for e in kf_ev]),
        "loop_closures": np.array([e.get("loop_closures", 0) for e in kf_ev]),
        "optimized": np.array([bool(e.get("optimized", False)) for e in kf_ev]),
        "av_depth_residual": np.array([e.get("av_depth_residual", np.nan) for e in ev]),
    }
    if gt is not None:
        out["gt"] = np.asarray(gt, np.float32)
    return out


LC_VERIFY_JITTERS = 53  # unjittered, +-JITTER_M along each axis, 40 random directions


def record_lc_verifies(slam, calls: list) -> None:
    """Keep the inputs of every dense loop-closure verification of a run
    with SYNCHRONOUS events by wrapping the tracker's
    `loop_closer.verify_dispatch`: `calls` receives, as the tracker runs,
    (query keyframe, query pyramid, candidates, their seeds, their
    pyramids)."""
    verify = slam.loop_closer.verify_dispatch

    def record(map360, q_pyr, cand, cand_pose, pyr_cache=None):
        res_b, cand_pyrs = verify(map360, q_pyr, cand, cand_pose, pyr_cache)
        # synchronous events: the event's keyframe is the current one
        calls.append((slam.current_kf, q_pyr, list(cand), dict(cand_pose), cand_pyrs))
        return res_b, cand_pyrs

    slam.loop_closer.verify_dispatch = record


def lc_verify_branches(slam, calls: list, n_jitters: int = LC_VERIFY_JITTERS) -> dict:
    """The solves behind the run's accepted closures again, from seeds moved
    by `jitters()[:n_jitters]`: the verification as `verify_dispatch` ran it
    (the whole candidate batch) or, where that failed the gates and the
    heading rescue was accepted, `rescue_fused_dispatch`.
    `lc_verify_edges` (n, 2) the closures (keyframe from, to),
    `lc_verify_branch_poses` (P, n, 4, 4) their poses per jitter (branch 0,
    unjittered, IS the edge's pose), `lc_verify_rescued` (n,) which of the
    two solves gave it."""
    closer = slam.loop_closer
    n_e = int(slam.map.n_edges)
    ij = np.asarray(slam.map.graph.edges_ij)[:n_e]
    rel = np.asarray(slam.map.graph.rel)[:n_e]
    closures = {(int(i), int(j)): r
                for (i, j), r, lc in zip(ij, rel, np.asarray(slam.map.edge_is_lc)[:n_e]) if lc}
    edges, poses, rescued = [], [], []
    for k, q_pyr, cand, cand_pose, cand_pyrs in calls:
        seeds = np.stack([np.asarray(cand_pose[int(kf)]) for kf in cand])
        verified = None
        for n, kf in enumerate(cand):
            edge = (int(kf), int(k))
            if edge not in closures:
                continue
            if verified is None:
                verified = np.stack([
                    np.asarray(D.batch_align_targets(
                        closer._aligner, q_pyr, cand_pyrs, list(_jittered(seeds, j))).pose)
                    for j in jitters()[:n_jitters]
                ])
            branch = verified[:, n]
            by_rescue = not np.array_equal(branch[0], closures[edge])
            if by_rescue:
                branch = np.stack([
                    np.asarray(closer.rescue_fused_dispatch(
                        q_pyr, cand_pyrs[n], _jittered(seeds[n : n + 1], j)[0]).pose)
                    for j in jitters()[:n_jitters]
                ])
            if not np.array_equal(branch[0], closures[edge]):
                raise AssertionError(f"closure {edge}: neither solve reproduces its edge")
            edges.append(edge)
            poses.append(branch)
            rescued.append(by_rescue)
    return {"lc_verify_edges": np.asarray(edges, np.int32).reshape(-1, 2),
            "lc_verify_branch_poses": np.stack(poses, axis=1).astype(np.float32)
            if poses else np.zeros((n_jitters, 0, 4, 4), np.float32),
            "lc_verify_rescued": np.asarray(rescued, bool)}


def _keyframe_config(subsample, pyramid_levels, config, async_events):
    cfg = config or synthetic.config(subsample, pyramid_levels)
    return cfg.replace(kf=dataclasses.replace(cfg.kf, async_kf_events=async_events))


def keyframe_run_jax(caps, async_events: bool = True, subsample: int = 1,
                     pyramid_levels: int = 5, config=None, gt=None, hook=None):
    """The reference `KeyframeSLAM` over the captures `caps`, each through
    `process`, then `flush()`: (tracker, record).  `hook(tracker)` runs
    before the first frame (to wrap methods)."""
    from rgbd360_tpu.slam.odometry import KeyframeSLAM

    cfg = _keyframe_config(subsample, pyramid_levels, config, async_events)
    slam = KeyframeSLAM(reference_builder(cfg))
    if hook is not None:
        hook(slam)
    for rgb, d in caps:
        slam.process(RawRigFrame(rgb=rgb, depth_mm=d))
    slam.flush()
    return slam, keyframe_record(slam, gt)


def solvers_jax() -> dict:
    """The reference's solvers on `synthetic.ring_graph` at the capacities a
    long run reaches: dense LM at 64 keyframes, LM-PCG at 256, with DCS."""
    from rgbd360_tpu.slam import graph as G

    out = {}
    for name, n_live, cap, e_cap, solve in (
        ("ring64", 48, 64, 512, G.optimize_pose_graph),
        ("ring256", 200, 256, 512, G.optimize_pose_graph_pcg),
    ):
        leaves, loop_mask, _ = synthetic.ring_graph(n_live, cap, e_cap)
        g = G.PoseGraph(*(jnp.asarray(a) for a in leaves))
        lm = jnp.asarray(loop_mask)
        poses, chi2, iters = solve(g, 10, loop_mask=lm)
        out.update({
            f"{name}_poses": np.asarray(poses), f"{name}_chi2": np.float32(chi2),
            f"{name}_iters": np.int64(iters),
            f"{name}_switches": np.asarray(G.loop_closure_switches(g, poses, lm)),
            f"{name}_chi2_start": np.float32(G.graph_chi2(g)),
        })
    return out


def kidnap_run_jax(caps, subsample: int = 1, pyramid_levels: int = 5, config=None,
                   gt=None, async_events: bool = True) -> dict:
    """The reference tracker over a kidnapped rig's captures: the record,
    and `coarse_frames`, the frames at which the yaw rescue ran."""
    rescued = []

    def hook(slam):
        coarse = slam.aligner.coarse_align

        def record_coarse(*a, **kw):
            rescued.append(len(slam.events))
            return coarse(*a, **kw)

        slam.aligner.coarse_align = record_coarse

    _, rec = keyframe_run_jax(caps, async_events, subsample, pyramid_levels, config, gt, hook)
    rec["coarse_frames"] = np.asarray(rescued, np.int64)
    return rec


def keyframe_jax(subsample: int = 1, pyramid_levels: int = 5, config=None,
                 n_frames: int = LOOP_FRAMES, solvers: bool = True) -> dict:
    """The reference's run of the smoke's Keyframe SLAM phase (see the
    module doc)."""
    gt = synthetic.loop_poses(n_frames)
    caps = synthetic.loop_captures(n_frames, subsample)
    out = {}
    for mode, name in ((True, "loop_async"), (False, "loop_sync")):
        calls: list = []
        hook = None if mode else (lambda slam: record_lc_verifies(slam, calls))
        slam, rec = keyframe_run_jax(caps, mode, subsample, pyramid_levels, config, gt, hook)
        out.update({f"{name}_{k}": v for k, v in rec.items()})
        if not mode:
            out.update(lc_verify_branches(slam, calls))
    rec = kidnap_run_jax(synthetic.kidnap_captures(caps), subsample, pyramid_levels, config,
                         synthetic.kidnap_poses(gt))
    out.update({f"kidnap_{k}": v for k, v in rec.items()})
    if solvers:
        out.update(solvers_jax())
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=6, help="frames of the slice")
    p.add_argument("--out-dir", default=str(DATA))
    only = p.add_mutually_exclusive_group()
    only.add_argument("--batch-only", action="store_true",
                      help="write only batch_golden.npz and the stitch maps")
    only.add_argument("--odometry-only", action="store_true",
                      help="write only odometry_golden.npz")
    only.add_argument("--keyframe-only", action="store_true",
                      help="write only keyframe_golden.npz")
    args = p.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    if not (args.batch_only or args.odometry_only):
        res = keyframe_jax()
        np.savez_compressed(out_dir / "keyframe_golden.npz", **res)
        print(f"wrote {out_dir / 'keyframe_golden.npz'}")
        for name in ("loop_async", "loop_sync", "kidnap"):
            print(f"{name}: keyframes at frames "
                  f"{np.flatnonzero(res[f'{name}_keyframe']).tolist()}, lost "
                  f"{np.flatnonzero(res[f'{name}_lost']).tolist()}, relocalized "
                  f"{np.flatnonzero(res[f'{name}_relocalized']).tolist()}, edges (i, j, lc) "
                  f"{res[f'{name}_edges'].tolist()}, closures {int(res[f'{name}_n_loop_closures'])}, "
                  f"areas {res[f'{name}_area'].tolist()}, connections "
                  f"{res[f'{name}_connections'].tolist()}, optimized "
                  f"{res[f'{name}_optimized'].tolist()}, chi2 {float(res[f'{name}_chi2']):.4f}")
        print("kidnap: coarse_align (yaw rescue) called at frames",
              res["kidnap_coarse_frames"].tolist())
        branch = res["lc_verify_branch_poses"]
        print("closures solved again from", len(branch), "jittered seeds:",
              res["lc_verify_edges"].tolist(), "accepted through the rescue",
              res["lc_verify_rescued"].tolist(), "spread (m)",
              np.linalg.norm(branch[:, :, :3, 3] - branch[:1, :, :3, 3], axis=2).max(axis=0).tolist())
        print("solvers: ring64 chi2", float(res["ring64_chi2_start"]), "->",
              float(res["ring64_chi2"]), "in", int(res["ring64_iters"]), "LM iterations; ring256",
              float(res["ring256_chi2_start"]), "->", float(res["ring256_chi2"]), "in",
              int(res["ring256_iters"]))
    if args.keyframe_only:
        return
    if not args.batch_only:
        res = odometry_jax(args.frames)
        np.savez(out_dir / "odometry_golden.npz", **res)
        print(f"wrote {out_dir / 'odometry_golden.npz'}")
        print("odometry axial steps (m):", res["rel"][:, 0, 3].tolist())
        print("PbMap matches:", res["pb_matches"].tolist(), "seeds tried:",
              res["seed_counts"].tolist(), "valid planes:",
              res["planes_valid"].sum(axis=1).tolist())
    if args.odometry_only:
        return
    if not args.batch_only:
        res = track_pairs_jax(args.frames)
        np.savez(out_dir / "smoke_golden.npz", **res)
        print(f"wrote {out_dir / 'smoke_golden.npz'}")
        print("axial steps (m):", res["poses"][:, 0, 3].tolist())
        print("iterations per level:", res["iters"].tolist())
    maps = reference_builder(synthetic.config())._params
    np.savez_compressed(
        out_dir / "reference_stitch_maps.npz",
        sensor=np.asarray(maps["sensor"]).astype(np.int8),
        u=np.asarray(maps["u"]).astype(np.int16),
        v=np.asarray(maps["v"]).astype(np.int16),
        scale=np.asarray(maps["scale"]),
        valid=np.asarray(maps["valid"]),
    )
    res = batch_jax()
    np.savez(out_dir / "batch_golden.npz", **res)
    print(f"wrote {out_dir / 'batch_golden.npz'}")
    print("batch axial offsets (m):", res["batch_poses"][:, 0, 3].tolist())
    print("batch iterations per level:", res["batch_iters"].tolist())
    print("targets axial offsets (m):", res["targets_poses"][:, 0, 3].tolist())
    print("coarse errors, static -> refined:", res["coarse_static_errors"].tolist(),
          res["coarse_errors"].tolist())


if __name__ == "__main__":
    main()
