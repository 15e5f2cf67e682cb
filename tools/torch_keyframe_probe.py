"""Probes behind the choices of the Keyframe SLAM phase of `chip_smoke.py`
(PERF.md).  Each runs the reference package on the CPU at full size
(and, for `solves`, the port beside it) and prints what it finds:

* `loop --room-radius R`: the reference `KeyframeSLAM` over the 24-frame
  loop in an octagon room of inradius R: keyframes, edges, loop closures,
  ATE.  (At 3 m it closes no loop, at 5 m one.)
* `kidnap --room-radius R [--blind]`: the kidnapped rig (frames 0-9, then
  18-21; with `--blind`, a blind capture in between): whether and where the
  reference declares itself lost and relocalises, each frame's depth
  residual and distance to the ground truth.
* `solves --frames N`: the first N frames of the loop through both packages
  on the CPU, the port on the reference's stitch maps: both trajectories,
  and the port's iterations per pyramid level of each tracked solve.

    JAX_PLATFORMS=cpu python tools/torch_keyframe_probe.py loop --room-radius 3
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "tools")]

import numpy as np  # noqa: E402
import torch_port_golden as golden  # noqa: E402  (sets jax up on the CPU)

from rgbd360_tpu_torch import synthetic  # noqa: E402

N = synthetic.KIDNAP_LOOP_FRAMES


def _summary(rec: dict) -> None:
    for k in ("keyframe", "lost", "relocalized"):
        print(f"{k} at frames {np.flatnonzero(rec[k]).tolist()}")
    print(f"edges (i, j, is_lc) {rec['edges'].tolist()}; {int(rec['n_loop_closures'])} loop "
          f"closures; connections per keyframe {rec['connections'].tolist()}")
    print(f"depth residual per frame {np.round(rec['av_depth_residual'], 3).tolist()}")
    errs = np.linalg.norm(rec["trajectory"][:, :3, 3] - rec["gt"][:, :3, 3], axis=1)
    print(f"distance to the ground truth per frame (m) {np.round(errs, 3).tolist()}")


def loop(room_radius: float) -> None:
    caps = synthetic.loop_captures(N, room_radius=room_radius)
    _, rec = golden.keyframe_run_jax(caps, True, gt=synthetic.loop_poses(N))
    _summary(rec)


def kidnap(room_radius: float, blind: bool) -> None:
    order = [i for i in synthetic.KIDNAP_ORDER if blind or i is not None]
    frames = [i for i in order if i is not None]
    by_frame = dict(zip(frames, synthetic.loop_captures(N, frames=frames, room_radius=room_radius)))
    by_frame[None] = tuple(np.zeros_like(a) for a in by_frame[0])
    rec = golden.kidnap_run_jax([by_frame[i] for i in order],
                                gt=synthetic.kidnap_poses(synthetic.loop_poses(N), order))
    _summary(rec)
    print(f"yaw rescue (coarse_align) at frames {rec['coarse_frames'].tolist()}")


def solves(n_frames: int) -> None:
    import chip_smoke
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RawRigFrame
    from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM, fetch

    cfg = chip_smoke.keyframe_config(synthetic.config(), False)
    caps = synthetic.loop_captures(N, frames=range(n_frames))
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    chip_smoke.load_reference_maps(builder)
    slam = KeyframeSLAM(builder, cfg)
    align, iters = slam.aligner.align, []

    def record(*a, **kw):
        res = align(*a, **kw)
        iters.append(fetch(res).iters.tolist())
        return res

    slam.aligner.align = record
    for rgb, d in caps:
        slam.process(RawRigFrame(rgb=rgb, depth_mm=d))
    _, ref = golden.keyframe_run_jax(caps, False, config=cfg)
    port = np.stack(slam.trajectory)
    print(f"port positions      {port[:, :3, 3].round(5).tolist()}")
    print(f"reference positions {ref['trajectory'][:, :3, 3].round(5).tolist()}")
    gaps = np.linalg.norm(port[:, :3, 3] - ref["trajectory"][:, :3, 3], axis=1)
    print(f"gaps (mm) {(1e3 * gaps).round(2).tolist()}")
    print(f"port iterations per level (finest first) of each solve {iters}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="probe", required=True)
    for name in ("loop", "kidnap"):
        q = sub.add_parser(name)
        q.add_argument("--room-radius", type=float, default=synthetic.ROOM_RADIUS)
    sub.choices["kidnap"].add_argument("--blind", action="store_true")
    sub.add_parser("solves").add_argument("--frames", type=int, default=4)
    args = p.parse_args(argv)
    if args.probe == "loop":
        loop(args.room_radius)
    elif args.probe == "kidnap":
        kidnap(args.room_radius, args.blind)
    else:
        solves(args.frames)


if __name__ == "__main__":
    main()
