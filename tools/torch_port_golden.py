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
* `reference_stitch_maps.npz`, the reference builder's stitch maps, which
  the batch phases load into the port's builder
  (`convert.stitch_maps_state_dict`): the two packages' maps differ on the
  sensor-tie columns and by ulps in `scale`, and the salient sweeps turn
  that into centimetres, so the batch goldens are compared on the same
  maps.

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py [--batch-only | --odometry-only]
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

from rgbd360_tpu.core.frame import FrameBuilder, RigFrame  # noqa: E402
from rgbd360_tpu.ops import se3  # noqa: E402
from rgbd360_tpu.ops import stitch as stitch_ops  # noqa: E402
from rgbd360_tpu.io.bin_format import RawRigFrame  # noqa: E402
from rgbd360_tpu.registration import dense as D  # noqa: E402
from rgbd360_tpu.slam.odometry import FrameToFrameOdometry  # noqa: E402
from rgbd360_tpu_torch import convert, synthetic  # noqa: E402
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=6, help="frames of the slice")
    p.add_argument("--out-dir", default=str(DATA))
    only = p.add_mutually_exclusive_group()
    only.add_argument("--batch-only", action="store_true",
                      help="write only batch_golden.npz and the stitch maps")
    only.add_argument("--odometry-only", action="store_true",
                      help="write only odometry_golden.npz")
    args = p.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
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
