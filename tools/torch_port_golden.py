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

* `apps_golden.npz` (`--apps-only`), the reference's apps
  (`apps.odometry.main`, `apps.kf_slam.main`) over capture files written by
  `synthetic.write_app_inputs` (the files the smoke's phase j writes: the calibration
  directory, the closed loop with `gt_poses.txt`, the walk), with
  `--no-intrinsics`: the odometry's trajectories (`odometry_*`, plain and
  `--keyframe`), `KeyframeSLAM`'s record with its tracked solves solved
  again from jittered seeds (`kf_slam_*`, `kf_slam_track_verify_*`) and
  the `--pbmap --plane-ba` run's record with its planar BA (`pbmap_*`,
  `pbmap_ba_*`), both with synchronous keyframe events (with deferred ones
  the closures an event verifies depend on when it runs); and the long-map runs of phase k (`long_*`):
  `KeyframeSLAM` and `PbMapGraphSLAM` over the loop at
  `synthetic.long_config` (capacities 4 keyframes / 8 edges, LM-PCG from 4 keyframes, a partition
  every 2), with synchronous and deferred events; a run that raises is
  recorded as `long_*_raised`.

* `registration_golden.npz` (`--registration-only`), the reference's
  registration apps over the calibration directory and the walk's 6
  captures (`synthetic.write_app_inputs`, `--no-intrinsics`), the files
  the smoke's phase l writes: `register_pair --dense --out` and `--dense
  --bilinear` on captures REG_PAIR (`pair_*`, `pair_bilinear_*`),
  `benchmark_registration` on REG_BENCH_PAIR (`bench_*`) and
  `register_sequence --window 2 --out` (`seq_*`, with the graph it solved
  and its solve, recorded by wrapping `optimize_pose_graph`), every PbMap
  result and every dense solve recorded by wrapping the classes' methods
  (`recorded_solves`), each dense solve again from REG_JITTERS jittered
  seeds (`*_branch_poses`); and beside the apps (`extra_*`) the occlusion
  modes 1 and 2 on the walk's REG_EXTRA_PAIR and a pinhole solve on sensor
  0's raw pair.

* `extras_golden.npz` (`--extras-only`), the extras of phase m over the
  files it writes (`synthetic.write_app_inputs`, `--no-intrinsics`): the
  reference's plain and parallax-refined builds of walk capture 0 (the
  rig's calibration without CLAMS, the reference's maps), the refined
  depth and refined maps at a seeded sample of `chip_smoke.STITCH_SAMPLE`
  pixels and both spheres' errors against the analytic octagon
  (`stitch_*`); `odometry.main --parallax-refine` over the walk, each
  step's dense solve again from REG_JITTERS jittered seeds (`odo_*`);
  `calibrate` `collect` over the loop, `solve` from the perturbed
  extrinsics of `chip_smoke.perturbed_rt`, `pair`, `eval`, `fim`,
  `online --sensors 0 1`, `tof` and `laser` on `chip_smoke`'s ToF and
  laser scenes (`cal_*`); `labelize apply` / `propagate` statistics
  (`label_stats`); the RANSAC core on the reference's own index triples
  and the public `ransac_plane` (`ransac_*`).  ~4 min on the CPU.

* `entry_golden.npz` (`--entry-only`), the reference's `__graft_entry__.entry()`
  forward step at its own size (320x1920, `DenseRegConfig(pyramid_levels=3)`):
  the pose, Hessian and error it returns and the GN iterations per level;
  `rgbd360_tpu_torch.entry.entry()` is held to it (phase n).  ~20 s.

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py \
        [--batch-only | --odometry-only | --keyframe-only | --apps-only |
         --registration-only | --extras-only | --entry-only]
"""

from __future__ import annotations

import argparse
import contextlib
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
from _reference import reference_builder, reference_inputs  # noqa: E402

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


TRACK_VERIFY_JITTERS = 13  # unjittered, and +-JITTER_M along each axis


def record_tracked_solves(slam, calls: list) -> None:
    """Keep the inputs of every fused tracked solve of a reference
    `KeyframeSLAM` run by wrapping its `make_state` and `_fused_track_fn`
    (the reference package is not edited): `calls` receives, as the
    tracker runs, (frame, its keyframe's frame, the frame's pyramid, the
    keyframe's pyramid, the seed, the solve's pose).  A keyframe's pyramid
    is its frame's own, so the frame of a keyframe is found by the
    pyramid's identity."""
    frames: dict = {}  # id(pyramid) -> (frame, pyramid): keeps the pyramids alive
    make_state, fused = slam.make_state, slam._fused_track_fn()

    def recorded_state(raw):
        state = make_state(raw)
        frames[id(state.pyramid)] = (len(slam.events), state.pyramid)
        return state

    def recorded_fused(params, rgb, depth, kf_planes, kf_pyr, seed):
        out = fused(params, rgb, depth, kf_planes, kf_pyr, seed)
        f = len(slam.events)
        frames[id(out[1])] = (f, out[1])
        calls.append((f, frames[id(kf_pyr)][0], out[1], kf_pyr, np.asarray(seed, np.float32),
                      np.asarray(out[4].pose)))
        return out

    slam.make_state = recorded_state
    slam._fused_track_fn = lambda: recorded_fused


def track_verify_branches(slam, calls: list, n_jitters: int = TRACK_VERIFY_JITTERS) -> dict:
    """Every recorded tracked solve again through `aligner.align`, from its
    seed moved by `jitters()[:n_jitters]`: `track_verify_frames` (n,),
    `track_verify_kf_frames` (n,) the frame of its keyframe,
    `track_verify_seeds` (n, 4, 4), `track_verify_poses` (n, 4, 4) the
    run's own solve, `track_verify_branch_poses` (P, n, 4, 4).  A tracked
    solve leaves most pyramid levels through the accept-if-improved exit,
    where rounding decides the last step, so one input has several
    solutions within reach of rounding (PERF.md, Findings)."""
    frames, kf_frames, seeds, poses, branches = [], [], [], [], []
    for f, kf, pyr, kf_pyr, seed, pose in calls:
        frames.append(f), kf_frames.append(kf), seeds.append(seed), poses.append(pose)
        branches.append([
            np.asarray(slam.aligner.align(pyr, kf_pyr, jnp.asarray(_jittered(seed[None], j)[0]),
                                          method=D.PHOTO_DEPTH).pose)
            for j in jitters()[:n_jitters]
        ])
    return {"track_verify_frames": np.asarray(frames, np.int64),
            "track_verify_kf_frames": np.asarray(kf_frames, np.int64),
            "track_verify_seeds": np.asarray(seeds, np.float32).reshape(-1, 4, 4),
            "track_verify_poses": np.asarray(poses, np.float32).reshape(-1, 4, 4),
            "track_verify_branch_poses": np.asarray(branches, np.float32).reshape(
                len(frames), n_jitters, 4, 4).transpose(1, 0, 2, 3)}


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
        tracked: list = []

        def hook(slam):
            record_lc_verifies(slam, calls)
            record_tracked_solves(slam, tracked)

        slam, rec = keyframe_run_jax(caps, mode, subsample, pyramid_levels, config, gt,
                                     None if mode else hook)
        out.update({f"{name}_{k}": v for k, v in rec.items()})
        if not mode:
            out.update(lc_verify_branches(slam, calls))
            out.update(track_verify_branches(slam, tracked))
    rec = kidnap_run_jax(synthetic.kidnap_captures(caps), subsample, pyramid_levels, config,
                         synthetic.kidnap_poses(gt))
    out.update({f"kidnap_{k}": v for k, v in rec.items()})
    if solvers:
        out.update(solvers_jax())
    return out


# ---------------------------------------------------------------- the apps

@contextlib.contextmanager
def reference_apps(cfg):
    """The reference's apps (`rgbd360_tpu.apps.{odometry,kf_slam,
    register_pair,benchmark_registration,register_sequence,calibrate,
    labelize,load_rawlog,view_frame}.main`) run at
    the port configuration `cfg`: for the duration, the reference's
    `default_config` (and the one its `FrameBuilder` falls back on, which
    the registration apps build without a config) returns `cfg`'s twin and
    the apps' calibration loader gives the rig's own pinhole intrinsics (it
    assumes the full-size rig).  The reference package is not edited."""
    from rgbd360_tpu import config as ref_config
    from rgbd360_tpu.apps import (benchmark_registration, calibrate, kf_slam, labelize,
                                  load_rawlog, odometry, register_pair, register_sequence,
                                  view_frame)
    from rgbd360_tpu.core import frame as ref_frame
    from rgbd360_tpu.io.calib import load_calibration

    ref_cfg = reference_inputs(cfg)[0]

    def load_calib(args):
        return load_calibration(pathlib.Path(args.calib) / "Extrinsics", None, rig=ref_cfg.rig)

    apps = (kf_slam, odometry, register_pair, benchmark_registration, register_sequence,
            calibrate, labelize, load_rawlog, view_frame)
    saved = (ref_config.default_config, ref_frame.default_config,
             [app.load_calib for app in apps])
    ref_config.default_config = ref_frame.default_config = lambda: ref_cfg
    for app in apps:
        app.load_calib = load_calib
    try:
        yield
    finally:
        ref_config.default_config, ref_frame.default_config = saved[:2]
        for app, fn in zip(apps, saved[2]):
            app.load_calib = fn


def apps_odometry_jax(paths: dict, cfg, keyframe: bool = False) -> np.ndarray:
    """The reference `apps.odometry.main` over the walk: its trajectory."""
    from rgbd360_tpu.apps import odometry

    argv = [str(paths["walk"]), "--calib", str(paths["calib"]), "--no-intrinsics"]
    with reference_apps(cfg):
        return np.asarray(odometry.main(argv + (["--keyframe"] if keyframe else [])), np.float32)


def pbmap_record(slam, gt=None) -> dict:
    """What a finished `PbMapGraphSLAM` run is compared on (call after
    `flush()`): the keys of `chip_smoke.pbmap_record`."""
    from rgbd360_tpu.slam.graph import graph_chi2

    ev = slam.events
    n_kf, n_e = int(slam.map.n_kf), int(slam.map.n_edges)
    edges = np.concatenate(
        [np.asarray(slam.map.graph.edges_ij)[:n_e],
         np.asarray(slam.map.edge_is_lc)[:n_e, None].astype(np.int32)], axis=1)
    order = np.lexsort(edges.T[::-1])
    out = {
        "keyframe": np.array([e["keyframe"] for e in ev]),
        "ref_kf": np.array([e.get("ref_kf", -1) for e in ev], np.int64),
        "no_assoc": np.int64(slam.no_assoc),
        "edges": edges[order],
        "edge_rel": np.asarray(slam.map.graph.rel)[:n_e][order],
        "n_loop_closures": np.int64(slam.n_loop_closures),
        "area": np.asarray(slam.map.area)[:n_kf],
        "n_areas": np.int64(int(slam.map.n_areas)),
        "trajectory": np.stack(slam.trajectory).astype(np.float32),
        "opt_poses": np.asarray(slam.map.opt_poses)[:n_kf],
        "chi2": np.float32(graph_chi2(slam.map.graph)),
        "loop_closures": np.array([e.get("loop_closures", 0) for e in ev if e["keyframe"]]),
    }
    if gt is not None:
        out["gt"] = np.asarray(gt, np.float32)
    return out


def apps_kf_slam_jax(paths: dict, cfg, pbmap: bool = False, plane_ba: bool = False,
                     n_jitters: int = 0) -> dict:
    """The reference `apps.kf_slam.main` over the loop (with `--gt`): the
    tracker's record (`keyframe_record`, or `pbmap_record` with `pbmap`),
    with `plane_ba` the planar BA's problem and result under `ba_*`,
    recorded by wrapping `slam.plane_ba.optimize_plane_ba`, and with
    `n_jitters` the `KeyframeSLAM`'s tracked solves solved again from that
    many jittered seeds (`track_verify_*`, see `track_verify_branches`)."""
    from rgbd360_tpu.apps import kf_slam
    from rgbd360_tpu.slam import plane_ba as B

    argv = [str(paths["loop"]), "--calib", str(paths["calib"]), "--no-intrinsics",
            "--gt", str(paths["gt"])]
    argv += (["--pbmap"] if pbmap else []) + (["--plane-ba"] if plane_ba else [])
    ba, solve = {}, B.optimize_plane_ba

    def record(prob, *a, **kw):
        res = jax.device_get(solve(prob, *a, **kw))
        ba.update(poses=np.asarray(res[0]), chi2=np.float32(res[2]), iters=np.int64(res[3]),
                  obs_kf=np.asarray(prob.obs_kf), obs_pl=np.asarray(prob.obs_pl))
        return res

    from rgbd360_tpu.slam.odometry import KeyframeSLAM

    tracked: list = []
    init = KeyframeSLAM.__init__

    def init_recording(self, *a, **kw):
        init(self, *a, **kw)
        record_tracked_solves(self, tracked)

    B.optimize_plane_ba = record
    KeyframeSLAM.__init__ = init_recording
    try:
        with reference_apps(cfg):
            slam = kf_slam.main(argv)
    finally:
        B.optimize_plane_ba = solve
        KeyframeSLAM.__init__ = init
    gt = np.loadtxt(paths["gt"]).reshape(-1, 4, 4)
    rec = pbmap_record(slam, gt) if pbmap else keyframe_record(slam, gt)
    rec.update({f"ba_{k}": v for k, v in ba.items()})
    if tracked and n_jitters:
        rec.update(track_verify_branches(slam, tracked, n_jitters))
    return rec


def apps_jax(paths: dict, subsample: int = 1, pyramid_levels: int = 5) -> dict:
    """The reference's runs of the smoke's phase j (see the module doc)."""
    cfg = synthetic.config(subsample, pyramid_levels)
    out = {"odometry_trajectory": apps_odometry_jax(paths, cfg),
           "odometry_kf_trajectory": apps_odometry_jax(paths, cfg, keyframe=True)}
    # both trackers with SYNCHRONOUS keyframe events: a deferred reference
    # run is a race on the CPU (which closures an event verifies depends on
    # when it is advanced: the deferred KeyframeSLAM app missed the closure
    # 0-4 that its synchronous run and the port on the card accept; the
    # PbMap app at the tests' size closes 25 loops deferred, 35 synchronous)
    sync = _keyframe_config(subsample, pyramid_levels, cfg, False)
    rec = apps_kf_slam_jax(paths, sync, n_jitters=TRACK_VERIFY_JITTERS)
    out.update({f"kf_slam_{k}": v for k, v in rec.items()})
    rec = apps_kf_slam_jax(paths, sync, pbmap=True, plane_ba=True)
    out.update({f"pbmap_{k}": v for k, v in rec.items()})
    return out


def pbmap_run_jax(caps, async_events: bool, config, gt=None):
    """The reference `PbMapGraphSLAM` over the captures, then `flush()`:
    (tracker, record)."""
    from rgbd360_tpu.slam.pbmap_slam import PbMapGraphSLAM

    cfg = _keyframe_config(1, 5, config, async_events)
    slam = PbMapGraphSLAM(reference_builder(cfg))
    for rgb, d in caps:
        slam.process(RawRigFrame(rgb=rgb, depth_mm=d))
    slam.flush()
    return slam, pbmap_record(slam, gt)


def long_jax(subsample: int = 1, pyramid_levels: int = 5, n_frames: int = LOOP_FRAMES) -> dict:
    """The reference's runs of the smoke's long-map phase k: `KeyframeSLAM`
    and `PbMapGraphSLAM` over the loop at `synthetic.long_config`, with deferred and
    with synchronous events.  A run that raises (the deferred partition of
    a map that grew under it) is recorded as `long_*_raised`."""
    cfg = synthetic.long_config(synthetic.config(subsample, pyramid_levels))
    gt = synthetic.loop_poses(n_frames)
    caps = synthetic.loop_captures(n_frames, subsample)
    out = {}
    for name, run in (("kf", lambda m: keyframe_run_jax(caps, m, config=cfg, gt=gt)),
                      ("pb", lambda m: pbmap_run_jax(caps, m, cfg, gt))):
        for mode, tag in ((False, "sync"), (True, "async")):
            try:
                _, rec = run(mode)
            except ValueError as err:
                out[f"long_{name}_{tag}_raised"] = np.str_(str(err))
                continue
            out.update({f"long_{name}_{tag}_{k}": v for k, v in rec.items()})
    return out


# -------------------------------------------------------- the registration

# the captures, window and methods of phase l, defined once in the smoke
from chip_smoke import (  # noqa: E402
    BENCH_DENSE, BENCH_ICP, REG_BENCH_PAIR, REG_EXTRA_PAIR, REG_PAIR, REG_WINDOW,
)

REG_JITTERS = TRACK_VERIFY_JITTERS  # unjittered, and +-JITTER_M along each axis
BENCH_METHODS = ("pbmap",) + BENCH_DENSE[:4] + BENCH_ICP + ("rig_joint",)


@contextlib.contextmanager
def recorded_solves():
    """Record every `DenseAligner.align` and `RigDenseAligner.align` call of
    the reference (the classes' methods are wrapped for the duration; the
    package is not edited) and every `PlaneRegistration.register` result:
    yields {"dense": [(aligner, src, trg, seed, method, occlusion, pose,
    ill_posed)], "pbmap": [(success, n_matches, pose)]}, a call repeated on
    the same inputs (the benchmark's repeats) kept once."""
    from rgbd360_tpu.registration.planes import PlaneRegistration
    from rgbd360_tpu.registration.rig_dense import RigDenseAligner

    log = {"dense": [], "pbmap": []}
    seen = set()
    saved = [(c, c.align) for c in (D.DenseAligner, RigDenseAligner)]
    register = PlaneRegistration.register

    def wrap(align):
        def recorded(self, src, trg, init_pose=None, method=D.PHOTO_DEPTH, occlusion=0):
            res = align(self, src, trg, init_pose, method, occlusion)
            seed = np.eye(4, dtype=np.float32) if init_pose is None else np.asarray(init_pose)
            key = (id(self), id(src), id(trg), method, occlusion, seed.tobytes())
            if key not in seen:
                seen.add(key)
                log["dense"].append((self, src, trg, seed, method, occlusion,
                                     np.asarray(res.pose), bool(res.ill_posed)))
            return res
        return recorded

    def recorded_register(self, *a, **kw):
        res = register(self, *a, **kw)
        log["pbmap"].append((bool(res.success), int(res.n_matches), np.asarray(res.pose)))
        return res

    for cls, align in saved:
        cls.align = wrap(align)
    PlaneRegistration.register = recorded_register
    try:
        yield log
    finally:
        for cls, align in saved:
            cls.align = align
        PlaneRegistration.register = register


def solve_branches(calls, n_jitters: int = REG_JITTERS) -> np.ndarray:
    """(P, n, 4, 4): each recorded dense solve again from its seed moved by
    `jitters()[:n_jitters]` (a solve that leaves a level through the
    accept-if-improved exit has several solutions within reach of
    rounding, PERF.md)."""
    return np.asarray([
        [np.asarray(al.align(src, trg, jnp.asarray(_jittered(seed[None], j)[0]), method,
                             occ).pose) for al, src, trg, seed, method, occ, *_ in calls]
        for j in jitters()[:n_jitters]
    ], np.float32).reshape(n_jitters, len(calls), 4, 4)


def seq_pairs(n: int, window: int = REG_WINDOW) -> list:
    """register_sequence's pairs (i, j) in the order it registers them."""
    return [(j - back, j) for j in range(1, n) for back in range(1, min(window, j) + 1)]


def registration_extras_jax(paths: dict, cfg, n_jitters: int = REG_JITTERS) -> dict:
    """The phase-l solves outside the apps: `DenseAligner.align` with
    occlusion 1 and 2 on the walk's REG_EXTRA_PAIR (spheres built by the
    reference builder), and the pinhole `DenseAligner(intrinsics=K)` on
    sensor 0's raw pair (gray from the capture, depth in metres, 5 levels
    from the rig's 240x320), each with its jittered-seed branches."""
    from rgbd360_tpu.io.bin_format import read_rig_frame
    from rgbd360_tpu.ops.stitch import rgb_to_gray

    builder = reference_builder(cfg)
    raws = sorted(paths["walk"].glob("sphere_images_*.bin"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    raws = [read_rig_frame(raws[i]) for i in REG_EXTRA_PAIR]
    pyrs = [builder.build_with_pyramid(RigFrame(jnp.asarray(r.rgb), jnp.asarray(r.depth_mm)))[1]
            for r in raws]
    sensor = [D.build_frame_pyramid(rgb_to_gray(jnp.asarray(r.rgb[0])),
                                    jnp.asarray(r.depth_mm[0]).astype(jnp.float32) * 0.001,
                                    builder.config.dense, spherical=False) for r in raws]
    sphere_al = D.DenseAligner(builder.config.dense)
    pin_al = D.DenseAligner(builder.config.dense, intrinsics=builder.k)
    with recorded_solves() as log:
        for occ in (1, 2):
            sphere_al.align(pyrs[1], pyrs[0], occlusion=occ)
        pin_al.align(sensor[1], sensor[0])
    calls = log["dense"]
    return {"extra_poses": np.asarray([c[6] for c in calls], np.float32),
            "extra_branch_poses": solve_branches(calls, n_jitters)}


def registration_jax(paths: dict, subsample: int = 1, pyramid_levels: int = 5,
                     n_jitters: int = REG_JITTERS) -> dict:
    """The reference's registration apps over the files phase l writes
    (`register_pair --dense --out` and `--dense --bilinear` on REG_PAIR,
    `benchmark_registration` on REG_BENCH_PAIR, `register_sequence
    --window REG_WINDOW --out` over the walk), their PbMap results and
    every dense solve with its jittered-seed branches (see the module
    doc), and the solves beside them (`registration_extras_jax`).  The
    benchmark runs with `--repeats 1`: its results do not depend on the
    count."""
    import tempfile

    from rgbd360_tpu.apps import benchmark_registration, register_pair, register_sequence
    from rgbd360_tpu.slam import graph as G

    cfg = synthetic.config(subsample, pyramid_levels)
    walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
    out = {}
    with reference_apps(cfg), tempfile.TemporaryDirectory() as tmp:
        pair = [str(walk[i]) for i in REG_PAIR]
        for tag, extra in (("pair", ["--out", tmp]), ("pair_bilinear", ["--bilinear"])):
            with recorded_solves() as log:
                rec = register_pair.main(pair + calib + ["--dense"] + extra)
            (success, n_matches, _), = log["pbmap"]
            out.update({f"{tag}_pbmap": np.asarray(rec["pbmap"], np.float32),
                        f"{tag}_icp": np.asarray(rec["icp"], np.float32),
                        f"{tag}_icp_rms": np.float32(rec["icp_rms"]),
                        f"{tag}_dense": np.asarray(rec["dense"], np.float32),
                        f"{tag}_matches": np.int64(n_matches),
                        f"{tag}_pb_success": np.bool_(success),
                        f"{tag}_branch_poses": solve_branches(log["dense"], n_jitters)[:, 0]})

        bench = [str(walk[i]) for i in REG_BENCH_PAIR]
        with recorded_solves() as log:
            res = benchmark_registration.main(bench + calib + ["--repeats", "1"])
        for name in BENCH_METHODS:
            out[f"bench_{name}"] = np.asarray(res[name][0], np.float32)
        out["bench_pb_success"], out["bench_pb_matches"] = log["pbmap"][0][:2]
        # the dense solves in BENCH_DENSE order (the app's order)
        out["bench_dense_branch_poses"] = solve_branches(log["dense"], n_jitters)

        chi2 = {}
        optimize = G.optimize_pose_graph

        def recorded_optimize(g, *a, **kw):
            res = optimize(g, *a, **kw)
            chi2.update(chi2=np.float32(res[1]), iters=np.int64(res[2]),
                        poses=np.asarray(res[0], np.float32),
                        graph={f.name: np.asarray(getattr(g, f.name))
                               for f in dataclasses.fields(g)})
            return res

        G.optimize_pose_graph = recorded_optimize
        try:
            with recorded_solves() as log:
                traj, labels = register_sequence.main(
                    [str(paths["walk"])] + calib + ["--window", str(REG_WINDOW), "--out", tmp])
        finally:
            G.optimize_pose_graph = optimize
        pairs = seq_pairs(len(walk))
        ill = np.array([c[7] for c in log["dense"]])
        out.update(
            seq_trajectory=np.asarray(traj, np.float32), seq_labels=np.asarray(labels),
            seq_pairs=np.asarray(pairs, np.int64), seq_ill_posed=ill,
            seq_edges=np.asarray([p for p, b in zip(pairs, ill) if not b], np.int64),
            seq_poses=np.asarray([c[6] for c in log["dense"]], np.float32),
            seq_pb_success=np.array([s for s, _, _ in log["pbmap"]]),
            seq_pb_matches=np.array([m for _, m, _ in log["pbmap"]], np.int64),
            seq_pb_poses=np.asarray([p for _, _, p in log["pbmap"]], np.float32),
            seq_chi2=chi2["chi2"], seq_lm_iters=chi2["iters"], seq_solver_poses=chi2["poses"],
            **{f"seq_graph_{k}": v for k, v in chi2["graph"].items()},
            seq_branch_poses=solve_branches(log["dense"], n_jitters),
        )
    out.update(registration_extras_jax(paths, cfg, n_jitters))
    return out


# ---------------------------------------------------------------- the extras

def stitch_sample_jax(cfg, raw, n: int = None) -> dict:
    """The reference's plain and parallax-refined builds of one capture
    (the rig's calibration without CLAMS, the reference's own maps): the
    refined depth and refined maps at a seeded sample of `n` sphere pixels
    (`stitch_sample`, `stitch_depth`, `stitch_u`, `stitch_v`), and both
    spheres' mean absolute radial error against the analytic octagon and
    coverage (`stitch_err_*`, `stitch_cov_*`)."""
    import chip_smoke as C
    from rgbd360_tpu.apps.grabber import _octagon_hit
    from rgbd360_tpu.core.frame import FrameBuilder
    from rgbd360_tpu.ops import camera

    n = n or C.STITCH_SAMPLE
    ref_cfg, cal = reference_inputs(cfg)
    cal = dataclasses.replace(cal, clams_multipliers=None, clams_counts=None)
    refined_cfg = dataclasses.replace(
        ref_cfg, sphere=dataclasses.replace(ref_cfg.sphere, parallax_refine=True))
    frame = RigFrame(jnp.asarray(raw.rgb), jnp.asarray(raw.depth_mm))
    plain = FrameBuilder(cal, ref_cfg).build(frame)
    b_ref = FrameBuilder(cal, refined_cfg)
    refined = b_ref.build(frame)
    p = b_ref._params
    maps = stitch_ops.refine_stitch_maps(b_ref.maps, plain.sphere_depth, p["rt_inv"], p["k"],
                                         ref_cfg.rig.height, ref_cfg.rig.width)
    h, w = plain.sphere_depth.shape
    gt = _octagon_hit(np.zeros(3), np.asarray(camera.sphere_rays(h, w)), synthetic.ROOM_RADIUS)
    out = {}
    for tag, f in (("plain", plain), ("refined", refined)):
        d = np.asarray(f.sphere_depth)
        m = (d > 0) & np.isfinite(gt)
        out[f"stitch_err_{tag}"] = np.float64(np.mean(np.abs(d - gt)[m]))
        out[f"stitch_cov_{tag}"] = np.float64(np.mean(d > 0))
    idx = np.sort(np.random.default_rng(0).choice(h * w, n, replace=False)).astype(np.int32)
    out.update(stitch_sample=idx,
               stitch_depth=np.asarray(refined.sphere_depth).reshape(-1)[idx],
               stitch_u=np.asarray(maps.u).reshape(-1)[idx].astype(np.int16),
               stitch_v=np.asarray(maps.v).reshape(-1)[idx].astype(np.int16))
    return out


def odometry_refined_jax(paths: dict, cfg, n_jitters: int = REG_JITTERS) -> dict:
    """The reference `apps.odometry.main --parallax-refine` over the walk:
    its trajectory (`odo_trajectory`), per-frame steps (`odo_steps`), and
    the dense solve that gave each step again from REG_JITTERS jittered
    seeds (`odo_branch_steps` (P, n-1, 4, 4))."""
    from rgbd360_tpu.apps import odometry

    argv = [str(paths["walk"]), "--calib", str(paths["calib"]), "--no-intrinsics",
            "--parallax-refine"]
    with reference_apps(cfg), recorded_solves() as log:
        traj = np.asarray(odometry.main(argv), np.float64)
    steps = np.linalg.inv(traj[:-1]) @ traj[1:]
    calls = log["dense"]
    poses = np.asarray([c[6] for c in calls], np.float64)
    # each step's solve: the first of the closest solves after the previous
    # step's (a solve that ends on its seed repeats the previous step)
    matched, j0 = [], 0
    for s in steps:
        gap = np.linalg.norm(poses[j0:] - s, axis=(1, 2))
        matched.append(j0 + int(np.argmin(gap)))
        j0 = matched[-1] + 1
    gaps = [float(np.abs(poses[j] - s).max()) for j, s in zip(matched, steps)]
    print(f"odometry --parallax-refine: {len(calls)} dense solves, each step's solve "
          f"{matched} (largest entry gap {max(gaps):.2e})")
    return {"odo_trajectory": traj.astype(np.float32), "odo_steps": steps.astype(np.float32),
            "odo_branch_steps": solve_branches([calls[j] for j in matched], n_jitters)}


@contextlib.contextmanager
def recorded_calibrations():
    """Record the results of the reference's `RigCalibrator.calibrate` and
    `PairCalibrator.calibrate` (their classes' methods wrapped for the
    duration; the package is not edited): yields {"rig": [rt], "pair": [rt]}."""
    from rgbd360_tpu.calibration import solver

    log = {"rig": [], "pair": []}
    saved = {k: getattr(solver, c).calibrate for k, c in (("rig", "RigCalibrator"),
                                                          ("pair", "PairCalibrator"))}

    def wrap(key):
        def recorded(self, *a, **kw):
            rt, diag = saved[key](self, *a, **kw)
            log[key].append(np.asarray(rt, np.float64))
            return rt, diag
        return recorded

    solver.RigCalibrator.calibrate = wrap("rig")
    solver.PairCalibrator.calibrate = wrap("pair")
    try:
        yield log
    finally:
        solver.RigCalibrator.calibrate = saved["rig"]
        solver.PairCalibrator.calibrate = saved["pair"]


def parse_eval(text: str) -> np.ndarray:
    """`calibrate eval`'s table as rows (a, b, n, conditioning, rot, trans)."""
    import re

    rows = []
    for line in text.splitlines():
        m = re.match(r"\((\d+),(\d+)\)\s+(\d+)\s+(\S+)\s+(\S+)\s+(\S+)", line.strip())
        if m:
            rows.append([float(g) for g in m.groups()])
    return np.asarray(rows, np.float64).reshape(-1, 6)


def calibrate_jax(paths: dict, cfg, tmp) -> dict:
    """The reference `apps.calibrate.main` sub-commands over the files phase
    m writes: `collect` over the loop (`cal_cp`, the control planes' rows),
    `solve` seeded from the perturbed extrinsics (`cal_solve_rt`), `pair`
    and `fim` of CAL_PAIR (`cal_pair_rt`, `cal_fim`), `eval`
    (`cal_eval`, its table), `online --sensors` CAL_PAIR (`cal_online_rt`),
    `tof` (`cal_tof_rt`, `cal_tof_corresp`) and `laser` (`cal_laser_rt`)."""
    import io

    import chip_smoke as C
    from rgbd360_tpu.apps import calibrate

    tmp = pathlib.Path(tmp)
    calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
    cp = str(tmp / "cp.txt")
    pair = [str(v) for v in C.CAL_PAIR]
    C.write_perturbed_calibration(tmp / "pert", cfg.rig)
    ins = C.write_tof_laser_inputs(tmp / "extras")
    out = {}
    with reference_apps(cfg), recorded_calibrations() as log:
        calibrate.main(["collect", str(paths["loop"]), "--out", cp] + calib)
        out["cal_cp"] = np.loadtxt(cp)
        calibrate.main(["solve", cp, "--calib", str(tmp / "pert"), "--no-intrinsics"])
        out["cal_solve_rt"] = log["rig"][-1]
        calibrate.main(["pair", cp, "--sensors", *pair] + calib)
        out["cal_pair_rt"] = log["pair"][-1]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            calibrate.main(["eval", cp] + calib)
        out["cal_eval"] = parse_eval(buf.getvalue())
        out["cal_fim"] = calibrate.main(["fim", cp, "--sensors", *pair] + calib)
        out["cal_online_rt"] = calibrate.main(
            ["online", str(paths["loop"]), "--sensors", *pair, "--threshold-conditioning",
             "100000"] + calib)
        co = str(tmp / "corresp.txt")
        out["cal_tof_rt"] = np.asarray(calibrate.main(
            ["tof", str(ins["tof"]), "--corresp-out", co]), np.float64)
        out["cal_tof_corresp"] = np.loadtxt(co)
        out["cal_laser_rt"] = calibrate.main(
            ["laser", str(ins["laser"]), "--planes", str(ins["planes"]), "--guess",
             str(ins["guess"])] + calib)
    return out


def labelize_jax(paths: dict, cfg, tmp) -> dict:
    """The reference `apps.labelize.main`: `apply` LABELS to the walk's
    frame LABEL_FRAME, `propagate` over the walk, then
    `label_statistics` per level (`label_stats`, a JSON string)."""
    import json

    import chip_smoke as C
    from rgbd360_tpu.apps import labelize
    from rgbd360_tpu.slam.labeling import LabelStore, label_statistics

    tmp = pathlib.Path(tmp)
    store, labels = str(tmp / "store.json"), tmp / "labels.json"
    labels.write_text(json.dumps(C.LABELS))
    calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
    with reference_apps(cfg):
        labelize.main(["apply", str(paths["walk"]), "--frame", str(C.LABEL_FRAME), "--labels",
                       str(labels), "--store", store] + calib)
        labelize.main(["propagate", str(paths["walk"]), "--store", store] + calib)
    st = LabelStore.load(store)
    return {"label_stats": np.asarray(json.dumps(
        {lv: label_statistics(st, lv) for lv in ("plane", "object", "context")}))}


def ransac_jax() -> dict:
    """The reference's RANSAC core on `chip_smoke.ransac_scene()` with its
    own index triples (`ransac_idx`, drawn as `_ransac_plane_core` draws
    them from PRNGKey(0)): the winning plane, count and inlier mask
    (`ransac_n`, `ransac_d`, `ransac_count`, `ransac_inliers`); and the
    public `ransac_plane` (`ransac_plane_n`, `ransac_plane_d`)."""
    import chip_smoke as C
    from rgbd360_tpu.ops import ransac as R

    pts = jnp.asarray(C.ransac_scene())
    valid = jnp.ones(pts.shape[0], bool)
    key = jax.random.PRNGKey(0)
    idx = jax.random.randint(key, (C.RANSAC_HYPOTHESES, 3), 0, pts.shape[0])
    n, d, count = R._ransac_plane_core(pts, valid, key, jnp.float32(0.03), C.RANSAC_HYPOTHESES)
    inl = np.asarray((jnp.abs(pts @ n + d) < 0.03) & valid)
    pn, pd, _ = R.ransac_plane(np.asarray(pts), dist_threshold=0.03)
    return {"ransac_idx": np.asarray(idx, np.int32), "ransac_n": np.asarray(n),
            "ransac_d": np.float32(d), "ransac_count": np.int64(count), "ransac_inliers": inl,
            "ransac_plane_n": pn, "ransac_plane_d": np.float64(pd)}


def extras_jax(paths: dict, subsample: int = 1, pyramid_levels: int = 5,
               n_jitters: int = REG_JITTERS) -> dict:
    """Everything `extras_golden.npz` holds (see the module doc), over the
    inputs `synthetic.write_app_inputs` writes at `subsample`."""
    import tempfile

    from rgbd360_tpu.io.bin_format import read_rig_frame

    cfg = synthetic.config(subsample, pyramid_levels)
    walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    out = stitch_sample_jax(cfg, read_rig_frame(walk[0]))
    out.update(odometry_refined_jax(paths, cfg, n_jitters))
    with tempfile.TemporaryDirectory() as tmp:
        out.update(calibrate_jax(paths, cfg, tmp))
        out.update(labelize_jax(paths, cfg, tmp))
    out.update(ransac_jax())
    return out


def entry_jax(height: int = 320, width: int = 1920) -> dict:
    """`__graft_entry__.entry()`'s forward step on `_synthetic_pair(height,
    width)` from the identity: pose, Hessian, error, iterations per level."""
    from __graft_entry__ import _synthetic_pair
    from rgbd360_tpu.config import DenseRegConfig

    cfg = DenseRegConfig(pyramid_levels=3)

    def fwd(g1, d1, g2, d2, init):
        p1 = D.build_frame_pyramid(g1, d1, cfg)
        p2 = D.build_frame_pyramid(g2, d2, cfg)
        res = D.DenseAligner(cfg)._align_impl(p1, p2, init, D.PHOTO_DEPTH)
        return res.pose, res.hessian, res.error, res.iters

    out = jax.device_get(jax.jit(fwd)(*_synthetic_pair(height, width), jnp.eye(4)))
    return {k: np.asarray(v) for k, v in zip(("pose", "hessian", "error", "iters"), out)}


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
    only.add_argument("--apps-only", action="store_true",
                      help="write only apps_golden.npz")
    only.add_argument("--registration-only", action="store_true",
                      help="write only registration_golden.npz")
    only.add_argument("--extras-only", action="store_true",
                      help="write only extras_golden.npz")
    only.add_argument("--entry-only", action="store_true",
                      help="write only entry_golden.npz")
    args = p.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    if args.entry_only:
        res = entry_jax()
        np.savez(out_dir / "entry_golden.npz", **res)
        print(f"wrote {out_dir / 'entry_golden.npz'}: pose t {res['pose'][:3, 3].tolist()}, "
              f"error {float(res['error'])}, iterations {res['iters'].tolist()}")
        return
    if args.extras_only:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            res = extras_jax(synthetic.write_app_inputs(tmp))
        np.savez_compressed(out_dir / "extras_golden.npz", **res)
        print(f"wrote {out_dir / 'extras_golden.npz'}")
        for k in ("stitch_err_plain", "stitch_err_refined", "stitch_cov_plain",
                  "stitch_cov_refined", "label_stats", "ransac_count"):
            print(k, res[k])
        print("odometry --parallax-refine axial steps (m):", res["odo_steps"][:, 0, 3].tolist())
        print("control planes:", len(res["cal_cp"]), "eval:", res["cal_eval"].tolist())
        return
    if args.registration_only:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            res = registration_jax(synthetic.write_app_inputs(tmp, loop_frames=0))
        np.savez_compressed(out_dir / "registration_golden.npz", **res)
        print(f"wrote {out_dir / 'registration_golden.npz'}")
        for k in ("pair_matches", "pair_pb_success", "bench_pb_matches", "bench_pb_success",
                  "seq_edges", "seq_labels", "seq_chi2", "seq_lm_iters"):
            print(k, np.asarray(res[k]).tolist())
        for k in sorted(res):
            if k.endswith("branch_poses"):
                b = res[k]
                spread = np.linalg.norm(b[..., :3, 3] - b[:1, ..., :3, 3], axis=-1).max(axis=0)
                print(f"{k}: {b.shape[0]} branches, spread (m) {np.round(spread, 6).tolist()}")
        return
    if args.apps_only:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            res = apps_jax(synthetic.write_app_inputs(tmp))
        res.update(long_jax())
        np.savez_compressed(out_dir / "apps_golden.npz", **res)
        print(f"wrote {out_dir / 'apps_golden.npz'}")
        for name in ("kf_slam", "pbmap", "long_kf_sync", "long_kf_async", "long_pb_sync",
                     "long_pb_async"):
            if f"{name}_raised" in res:
                print(f"{name}: raised {res[f'{name}_raised']}")
                continue
            print(f"{name}: keyframes at frames {np.flatnonzero(res[f'{name}_keyframe']).tolist()}, "
                  f"edges (i, j, lc) {res[f'{name}_edges'].tolist()}, closures "
                  f"{int(res[f'{name}_n_loop_closures'])}, areas {res[f'{name}_area'].tolist()}, "
                  f"ref_kf {res.get(f'{name}_ref_kf', np.zeros(0)).tolist()}")
        print("plane BA: chi2", float(res["pbmap_ba_chi2"]), "in", int(res["pbmap_ba_iters"]),
              "LM iterations,", len(res["pbmap_ba_obs_kf"]), "observations")
        return
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
