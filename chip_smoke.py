#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (`rgbd360_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA device and refuses to run without one: no phase falls back
to the CPU.  Phases, in order (any failure exits non-zero):

a. the CUDA device check, and the card's name and power limit from
   nvidia-smi;
b. K1 (`csrc/fused_gradients.cu`) is built from the checkout's sources and
   held bit for bit against its plain PyTorch version at every level shape
   of the 5-level pyramid, stacked as C=2 (gray + depth) and as a batch of
   4 frames (C=8), on inputs with zeros, plateaus and equal neighbours; at
   awkward shapes (tiles' ragged edges, widths that are no multiple of 4, a
   pointer that is not 16-byte aligned: the one-pixel-per-thread
   instantiation); and as the grouped launch over a whole pyramid (10
   stacks, B = 1 and 4) with and without seam masks.  Each is timed with
   CUDA events and, in phase h, with `torch.profiler` (device time, the L2
   flushed between launches, and back to back), and printed with the bytes
   it must move, its bound at 3.35 TB/s and its share of that bound;
c. K2 (`csrc/pyr_down.cu`) likewise at every level transition shape, for
   C = 1 and 4, in both row modes (edge-clamped and circular), and
   `fused_level_down` (the gray's pyrDown and the depth's 2x2 valid mean
   in one launch) for B = 1 and 4 with depths below, inside and above the
   valid range; beside them the time of the banded `A @ img @ B` sandwich
   (a library call for the same function, timed only);
o. (run after c) the dense sweep's normal equations
   (`csrc/normal_equations.cu`) against the plain version summed in
   float64 at the main path's sweep shapes (level 0 with 1 and 3 elements,
   level 1, a verification's salient 3x16384, the coarse yaw grid's
   16x2400), to the card tests' limits (NEQ_RTOL); each timed like K1 and
   K2, beside the plain version (the code it replaced) and the library's
   `J^T J` GEMM alone, with its bytes (55 a pixel) and bound.  Every phase
   that runs a dense solve counts its GN trips through the kernel (two
   launches a trip, `_counts`) and fails if there are none;
d. the first slice at full size: 6 synthetic octagon-room captures
   (8x240x320 rig, `rgbd360_tpu_torch.synthetic`) go through
   `FrameBuilder.build_with_pyramid` (320x1920 sphere, 5 levels) and each
   consecutive pair through `DenseAligner.align` (PHOTO_DEPTH, constant
   velocity seed).  Checked: finite, well-posed poses; 0.1 m +- 0.02 m
   axial steps; agreement with the JAX golden
   (`rgbd360_tpu_torch/data/smoke_golden.npz`, from
   `tools/torch_port_golden.py`); K1 and K2 launched by the run; one
   pyramid is exactly 1 K1 launch and 4 K2 launches, and a profiled pyramid
   (phase h) runs no other device op (no `bmm`, no seam multiply).  The slice then
   runs once with K1, and once with K2, swapped for its plain version;
e. the batched tracking path at full size (the reference's batch-4
   pipeline): keyframe 0 from `build_with_pyramid`, frames 1-4 through
   `build_gray_depth_batch` -> `build_frame_pyramid_batch` (B = 4) ->
   the batched `DenseAligner.align` with `salient_pixels=16384`, each
   seeded one 0.1 m step short of its offset.  Checked: finite,
   well-posed poses; k*0.1 m +- 0.02 m axial offsets; the JAX golden
   (`data/batch_golden.npz`); the port's own unbatched `align` of each
   element; K1 and K2 launched by the run; a K2-swap rerun.  Timed: the
   4-frame batch, frames/s;
f. `batch_align_targets` of frame 4 against frames 0-3 (golden, and four
   unbatched `align` calls), and `coarse_errors` / `coarse_align` of frame
   1 against frame 0 over 8 yaw hypotheses (golden);
g. frame-to-frame odometry at full size with the default config (bilateral
   on, dense sweeps): `FrameToFrameOdometry(FrameBuilder(...))` takes the 6
   captures, each through `process(raw)` (build, 8x120x160 clouds, plane
   segmentation, the pyramid, PbMap registration against the previous
   frame, the dense seed chain).  Checked against the JAX golden
   (`data/odometry_golden.npz`): every frame tracked with a 0.1 +- 0.02 m
   axial step, `rel` within 5e-4 m and 2e-4 rad, the same seeds tried, the
   same PbMap success and (where both succeed) pose, the same number of
   valid planes, matched planes' normals, centres and areas; a second run
   agrees with the first; K1 and K2 launched.  Timed: `process` and
   `build_full` per frame, the tracker's stages, PbMap `register`; counted:
   host syncs per frame (PyTorch's sync debug mode, which misses some, so a
   lower bound), and, in phase h, one profiled frame with its host waits
   and device-to-host copies as the profiler sees them, and one profile of
   each of its stages (the bilateral and the connected-component scans
   alone).
i. Keyframe SLAM at full size with the default config (map capacity 64
   keyframes / 512 edges): `KeyframeSLAM(FrameBuilder(...))` takes a closed
   loop of 24 raw captures in the octagon room, each through
   `process(raw)`, then `flush()`.  Checked against the JAX golden
   (`data/keyframe_golden.npz`, `tools/torch_port_golden.py
   --keyframe-only`), for the deferred (default) and the synchronous
   keyframe events: the same per-frame flags (`keyframe`, `lost`,
   `relocalized`), the same edges `(i, j, is_lc)`, the same number of loop
   closures, the same partition up to relabelling, the fused tracked frame
   on every healthy frame, `trajectory` and `optimized_trajectory()` within
   KF_TOL_M / KF_TOL_RAD, each loop closure's measured pose within
   LC_EDGE_TOL of the nearest of the golden's solves of that closure from
   micrometre-jittered seeds, every edge's measured pose within KF_TOL_M /
   KF_TOL_RAD and the final chi2 within KF_CHI2_RTOL of the loop's branch
   set (the golden's run, and the loop run with the plain normal equations
   from seeds moved by a micrometre, `loop_branches`, where its decisions
   are the golden's; that run unjittered is held to the golden alone), the
   ATE no worse than the golden's by more than 5 mm.  Deferred against
   synchronous events: the same keyframes, edges and closures, nothing
   pending after `flush()`, optimized trajectories within 0.02 m.  A second
   synchronous run after `reset()` is identical bit for bit.  A kidnapped
   rig (`synthetic.kidnap_captures`: frames 0-9, a blind capture, then
   frames 18-21): lost at the blind capture, relocalised later, under
   0.15 m off the ground truth there and at the end, through the golden's
   branch (plane hypothesis or yaw rescue).  A checkpoint saved mid-loop and
   resumed in a fresh tracker (its keyframe pyramids rebuilt from the
   bfloat16 payload, through K1 and K2 without seam masks) gives the
   uninterrupted run's keyframes and edges.  The solvers alone: a seeded
   ring graph with a wrong closure at capacity 64 (dense LM) and 256
   (LM-PCG) against the golden's chi2 and poses, DCS switching the wrong
   closure off, a second solve identical; and the loop closer's scan and
   the relocaliser over a map filled to 64 keyframes, against a loop over
   the unbatched matcher.  Timed and counted: `process` per tracked and
   per keyframe frame, the event's phases, host syncs per frame, the
   solvers, the scan, peak memory, K1/K2 launches; one keyframe frame is
   profiled in phase h.  Each tracked solve of the golden's run is also
   solved by the port from the golden's seed on the same two frames (a
   builder holding the reference's stitch maps) and held to TRACK_TOL of
   the nearest of the golden's solves of it from jittered seeds;
j. the apps on capture files at full size: a calibration directory
   (construction-spec `Rt_0{s}.txt`, `--no-intrinsics`) and the loop's 24
   and the walk's 6 captures written with `write_rig_frame`, then
   `apps.odometry.main` (plain, with `--out`, and `--keyframe`),
   `apps.kf_slam.main` (`--gt`, `--out`) and `apps.kf_slam.main --pbmap
   --plane-ba`, each as a user runs it (on the card by default), held to
   `data/apps_golden.npz` (the reference's own `main` over the same files,
   `tools/torch_port_golden.py --apps-only`): odometry steps to the golden
   tolerance, the keyframe runs with phase i's gates and its per-solve
   gate, the PbMap run's decisions, registrations and planar BA; every
   `--out` file written and not empty; 1 K1 + 4 K2 launches per built
   frame; ms per frame and the phase's peak memory; `apps.grabber.main
   synth` read back by `SequenceDataset`;
k. the long map: `KeyframeSLAM` and `PbMapGraphSLAM` over the loop at
   `synthetic.long_config` (capacity 4 keyframes / 8 edges, LM-PCG from 4
   keyframes, a partition every 2), so the map grows, the graph is solved
   with LM-PCG on a live map and partitioned often: synchronous events
   against the golden's synchronous runs (`long_*`; `KeyframeSLAM`'s with
   the branch set of phase i at this configuration), then deferred events
   with every due partition held at its SSO snapshot until a later
   keyframe is promoted (the map grows under the event): the run
   completes, and each partition labels the keyframes its snapshot covers
   as the spectral partition of that snapshot and keeps the later ones'
   areas;
l. the pair-registration apps on capture files at full size (the
   calibration directory and the walk's 6 captures): `register_pair` on
   captures 0 and 5 with `--dense --out` and with `--dense --bilinear`,
   `benchmark_registration` on captures 0 and 2 (`--repeats 3`: PbMap,
   dense photo / depth / both / bilinear, ICP point / plane, GICP and the
   joint rig aligner from the raw sensors) and `register_sequence
   --window 2 --out` over the 6, each as a user runs it, held to
   `data/registration_golden.npz` (the reference's own `main` over the
   same files, `tools/torch_port_golden.py --registration-only`): PbMap
   success and matches equal (its pose printed, with the tied votes of
   the symmetric room's aliases where it took another than the golden's);
   `register_pair` and `register_sequence` seeded with the golden's PbMap
   results, so that what they seed is held on every run: ICP and GICP
   poses to ICP_TOL, every dense solve of the apps within APP_DENSE_TOL of
   the nearest of the golden's jittered solves of it and, solved again
   from the golden's seed on the reference's stitch maps, within the
   golden tolerance; `register_sequence`'s edges, graph, chi2
   (KF_CHI2_RTOL), trajectory (SEQ_TRAJ_TOL) and partition, and the solver on
   the golden's graph to SOLVER_CHI2_RTOL; `DenseAligner.align` with
   occlusion 1 and 2 and a pinhole `DenseAligner(intrinsics=K)` on sensor
   0's 240x320 pair, the same way; 1 K1 + 4 K2 launches per sphere, rig
   and pinhole pyramid, and (phase h) no other device op in a rig
   pyramid; GICP's loop reads nothing back (sync debug mode).  Printed:
   each method's ms (the app's own timing, CUDA-synchronized), each app's
   wall, the phase's peak memory.  Phases b and c hold K1 and K2 at the
   rig's and the pinhole solve's shapes (8x240x320 ... 8x15x20 and
   1x240x320 ... 1x15x20) too;
m. the extras at full size (the calibration directory, the loop's 24 and
   the walk's 6 captures), against `data/extras_golden.npz` (the
   reference's own functions and apps over the same inputs,
   `tools/torch_port_golden.py --extras-only`): the parallax-refined stitch
   of walk capture 0 (on the reference's maps, the refined depth and maps
   at the golden's seeded pixel sample; on the port's own, the radial
   error against the analytic octagon under 0.2x the plain sphere's and
   under 1 cm, coverage within 0.02); `apps.odometry.main --parallax-refine`
   over the walk (1 K1 + 4 K2 per frame, steps within the golden
   tolerance of the golden's or of its jittered re-solves); `calibrate`'s
   nine sub-commands (`collect` over the loop, `solve` from perturbed
   extrinsics, `pair`, `eval`, `fim`, `online --sensors 0 1`, `tof` on a
   rawlog of ToF range images, `laser` on a ray-cast 2D scan, `viz`), and
   `solve` / `pair` on the golden's own control planes; `load_rawlog` on
   a rawlog of 2 walk captures with gray images (`--to-bin` read back, the
   sphere export); `view_frame --planes --cloud`, its .pcd with the
   .pbmap, `--sequence --video` (the GIF); `labelize apply / propagate /
   stats`; a depth-only stereo sphere written, read back and tracked
   through `make_state_from_sphere`; RANSAC on the golden's index triples.
   Printed: each app's wall, the phase's time and peak memory;
n. distribution at full size (`parallel/`, ranks spawned by
   `parallel.spawn.run_ranks`, rendezvous through a FileStore, each group
   of ranks under RANKS_TIMEOUT_S; the kernels built here first): the
   sharded tracker, `KeyframeSLAM(mesh=)` over phase i's loop, on a world
   of 1 (NCCL) and of 2 (gloo, both ranks on the card; NCCL refuses two
   ranks on one device) with synchronous events, held to phase i's
   synchronous single-device run (the same keyframes, edges, closures and
   partition; both trajectories within SHARDED_TOL_M) and to the golden
   (KF_TOL_M / KF_TOL_RAD), every rank agreeing; on the 2 ranks also with
   deferred events on the deterministic poll cadence: at least one event
   in flight across a frame boundary, the ranks agreeing on the event
   schedule and the trajectory, held like the synchronous runs to the
   single-device run on the same cadence (rank 0 runs it in the world of
   2), whose optimized trajectory is held to ASYNC_SYNC_TOL_M of the
   synchronous run (its decisions printed); on 2 ranks, each sharded
   stage against its single-device counterpart: `sharded_pair_align` on 4 level-0 walk pairs, `sharded_plane_scan`, the
   sharded `LoopCloser` and `Relocalizer` over phase i's filled
   capacity-64 map, `distributed_pose_graph` and
   `distributed_pose_graph_pcg` (DCS) on the capacity-256 ring,
   `distributed_plane_ba` on the reference's own test problem,
   `GraphOptimizerBackend("sharded")`, and `register_sequence --sharded
   --window 2` over the walk's files (PbMap seeded from the golden as in
   phase l) against the unsharded app; `entry.entry()` at 320x1920 against
   `data/entry_golden.npz` with exactly 2 K1 + 4 K2 launches, then
   `entry.dryrun_multichip(2, "gloo", "cuda:0")`; the native capture
   decoder byte-equal to the Python reader on the walk's files.  Printed:
   ms per tracked and per keyframe frame per world, collectives per frame,
   each rank's peak memory, each stage's ms, the decoders' ms per file,
   the phase's command time.  The ranks' kernel launches count in the
   `kernels` line;
h. the measurements that need `torch.profiler` (the kernels' device times
   of phases b and c, the profiled pyramid of phase d, the profiled frames
   of phases g and i), put off until every host-clock timing is taken: once a process has profiled once
   its kernel launches cost more host time (measured on an H100: `process`
   100-119 ms per tracked frame in a fresh process, 129-192 ms after one
   profile), which would be read as the port's.
Phases e and f stitch with the reference builder's maps
(`data/reference_stitch_maps.npz`, see `load_reference_maps`), and each
pose must lie on one of the golden's branches (see `_gate_branches`).

Every plane set that `build_full` returns in phases g, i, j and k is
held finite in every field of every slot, padding included, and phase a
probes the card's `eigh` on degenerate 3x3 matrices (`probe_degenerate_eigh`).

The last two lines are a JSON line of per-kernel results (launch counts
summed over the gated runs of phases d-n, each counted from 0, the
ranks' of phase n included, the normal equations' from the GN trips;
times,
bytes, bounds and the library call's time at the main path's level-0
shapes, and per shape under `shapes`) and the contract line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder, RawRigFrame, RigFrame, downsample2_depth
from rgbd360_tpu_torch.io.calib import load_calibration
from rgbd360_tpu_torch.ops import _build, hopper_kernels as HK, se3
from rgbd360_tpu_torch.ops import segmentation as seg_ops
from rgbd360_tpu_torch.ops.bilateral import bilateral_depth
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.slam import graph as graph_ops
from rgbd360_tpu_torch.slam.loop_closure import LoopCloser
from rgbd360_tpu_torch.slam.map import Map360
from rgbd360_tpu_torch.slam.odometry import FrameToFrameOdometry, KeyframeSLAM, fetch
from rgbd360_tpu_torch.slam.relocalizer import Relocalizer
from rgbd360_tpu_torch.slam.topological import partition_map, recursive_spectral_partition
from rgbd360_tpu_torch.utils import metrics
from rgbd360_tpu_torch.utils.trace import StageTimer

DATA = Path(__file__).resolve().parent / "rgbd360_tpu_torch" / "data"
GOLDEN = DATA / "smoke_golden.npz"
BATCH_GOLDEN = DATA / "batch_golden.npz"
REFERENCE_MAPS = DATA / "reference_stitch_maps.npz"
ODOMETRY_GOLDEN = DATA / "odometry_golden.npz"
KEYFRAME_GOLDEN = DATA / "keyframe_golden.npz"
LOOP_FRAMES = synthetic.KIDNAP_LOOP_FRAMES  # the closed loop of phase i (24 frames)
N_FRAMES = 6
BATCH_FRAMES = 5  # keyframe 0 and a batch of 4
YAW_HYPOTHESES = 8
LEVEL_SHAPES = [(320, 1920), (160, 960), (80, 480), (40, 240), (20, 120)]
TRANSITION_SHAPES = LEVEL_SHAPES[:-1]
# the rig pyramid of phase l: the 8 sensors' 240x320 images as the batch;
# its pinhole solve's pyramid: one sensor's, the same shapes with a batch of 1
RIG_SENSORS = 8
RIG_BATCHES = {"rig": RIG_SENSORS, "pinhole": 1}
RIG_LEVEL_SHAPES = [(240, 320), (120, 160), (60, 80), (30, 40), (15, 20)]
RIG_TRANSITION_SHAPES = RIG_LEVEL_SHAPES[:-1]
STEP_M, STEP_TOL_M = 0.1, 0.02  # the reference's end-to-end synth gate
# Port vs JAX golden, per pair.  The port's stitch maps differ from the
# reference's on the sensor-tie columns and its sums run in another order,
# so the two solvers stop at slightly different points: measured on an
# H100, 8.0e-5 m and 2.8e-5 rad at most (PERF.md); the bounds are ~6x that.
GOLDEN_TOL_M = 5e-4
GOLDEN_TOL_RAD = 2e-4
# The batched solve against the port's own unbatched solve of each element:
# the same inputs and steps, but the Hessian and statistic reductions run
# over other shapes, so their sums may round differently; the bound is the
# golden's, because the GN steps amplify a rounding change the same way.
UNBATCHED_TOL_M = GOLDEN_TOL_M
UNBATCHED_TOL_RAD = GOLDEN_TOL_RAD
# A kernel vs its plain version inside a path: bit-equal outputs give the
# same poses; the bound only guards against nondeterministic reductions.
SWAP_TOL = 1e-6
# The batch phases against the golden's branches: the reference's salient
# solve is bistable on some elements (seeds moved by 1e-6 m end up to
# 1.1e-2 m apart, PERF.md), so each element must lie within the golden
# tolerance of the NEAREST of the reference's solutions for micrometre
# seed jitters (`tools/torch_port_golden.py`, JITTER_M).
COARSE_ERR_RTOL = 1e-3  # a coarse error against its matched branch's
# Phase g against the JAX golden.  The PbMap pose solves the same matches
# from planes whose moments differ by ulps (bilateral exp, summation
# order): measured on an H100 within 6.7e-7 m and 3.1e-6 rad (PERF.md).
PB_TOL_M, PB_TOL_RAD = 1e-4, 1e-4
# Matched planes (nearest centre): normal angle, centre distance, relative
# area; measured on an H100 at 5.6e-4 rad, 7.1e-4 m and 1.7e-4.  Pixels on
# a region's rim, whose neighbour gates sit at their thresholds, join or
# leave it with ulps in the normals, and the hull's in-plane basis is an
# eigenvector pair whose sign is free, so centres and areas move.
PLANE_TOL_RAD, PLANE_TOL_M, PLANE_TOL_AREA = 2e-3, 2e-3, 1e-3
# A seed against the golden's: the seeds are the last step (a `rel`) and
# the PbMap pose, so they carry the looser of the two tolerances.
SEED_TOL_M, SEED_TOL_RAD = GOLDEN_TOL_M, GOLDEN_TOL_RAD

K1, K2 = HK.fused_gradients, HK.fused_pyr_down  # the launch counters
PYRAMID_KERNELS = ("fused_gradients", "fused_pyr_down")
MIN_DEPTH, MAX_DEPTH = 0.3, 20.0  # DenseRegConfig's valid depth range
# The card's peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


TOTAL_LAUNCHES: Counter = Counter()  # over the gated runs of every phase


_NEQ_TRIPS = [0]  # D.GN_COUNTS["normal_eq"] at the last _reset_counts()


def _reset_counts() -> None:
    K1.launches = 0
    K2.launches = 0
    _NEQ_TRIPS[0] = D.GN_COUNTS["normal_eq"]


def _counts() -> dict:
    """Kernel launches since `_reset_counts()`.  The normal equations'
    are those of the GN trips whose sweep ran the kernel, two a trip,
    replayed from a CUDA graph or eager (`dense.GN_COUNTS["normal_eq"]`:
    the wrapper's own count sees a graph's capture, not its replays); the
    coarse refinements' sweeps (`coarse_errors`, `coarse_align`) are not
    in it."""
    return {"fused_gradients": K1.launches, "fused_pyr_down": K2.launches,
            "normal_equations": 2 * (D.GN_COUNTS["normal_eq"] - _NEQ_TRIPS[0])}


def _pyramid_counts(counts: dict) -> dict:
    """K1's and K2's launches of `counts`: what the pyramids launched."""
    return {k: counts[k] for k in PYRAMID_KERNELS}


def _require_launches(counts: dict, phase: str, solves: bool = True) -> None:
    """Every kernel of `counts` launched, the normal equations only where
    the phase ran a dense solve (`solves`); the counts add to the
    `kernels` line."""
    print(f"{phase}: kernel launches {counts}")
    missing = [k for k, n in counts.items()
               if n == 0 and (solves or k in PYRAMID_KERNELS)]
    if missing:
        raise AssertionError(f"{phase} never launched {missing}")
    TOTAL_LAUNCHES.update(counts)


def _median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps: int) -> list[float]:
    """Host-clock times of `reps` synchronized calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _plateau_inputs(c: int, h: int, w: int, rng) -> torch.Tensor:
    """Random f32 (c, h, w) with ~30% plateau pixels (equal neighbours),
    ~10% zeros and a spread of magnitudes, so every branch of the harmonic
    mean runs (zero differences, mixed signs, monotonic runs)."""
    x = rng.uniform(0.0, 4.0, (c, h, w))
    plateau = rng.uniform(size=(c, h, w)) < 0.3
    x = np.where(plateau, np.round(x), x)
    x = np.where(rng.uniform(size=(c, h, w)) < 0.1, 0.0, x)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def _depth_inputs(c: int, h: int, w: int, rng) -> torch.Tensor:
    """Random f32 depths (c, h, w): ~20% zeros, the rest spread over 0-25 m,
    so 2x2 blocks hold depths below, inside and above the valid range
    (0.3-20 m) in every mix, blocks with no valid depth included."""
    d = rng.uniform(0.0, 25.0, (c, h, w))
    d = np.where(rng.uniform(size=(c, h, w)) < 0.2, 0.0, d)
    d[:, : h // 4, : w // 4] = 0.1  # a region with no valid depth at all
    return torch.from_numpy(d.astype(np.float32)).cuda()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose pointer is 4-byte but not 16-byte
    aligned (the kernels' one-pixel instantiation must take it)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def _seam_like_masks(shapes, rng) -> list:
    """One random (H, W) bool mask (~5% zeros) per shape, on the card."""
    return [torch.from_numpy(rng.uniform(size=hw) > 0.05).cuda() for hw in shapes]


def _flat(out) -> list:
    """The tensors of a kernel's result (a tensor, a tuple, a list of tuples)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for item in out for t in _flat(item)]


def _device_events(prof) -> list:
    """The device events of a profile, without the GPU ranges of
    `record_function` regions (the tracker's StageTimer), which would count
    a region's span as busy."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in REGIONS]


_FLUSH: list = []  # one int32 buffer of 128 MB, larger than the 50 MB L2
_DEFERRED: list = []  # phase h: the jobs that run the profiler
# phase h's pyramid profiles, run before the frame profiles: after a session
# of ~10^4 device ops a later session of a few launches lost one of them
# (the rig pyramid's profile showed 4 of its 5 launches in 5 of 5 tries
# after phase i's frame profiles, all 5 with none before it; an H100)
_DEFERRED_PYRAMIDS: list = []


def _device_time(fn, cold: bool, n: int = 20) -> tuple[float, float]:
    """(device ms, device ops) of one call of fn: the sum of its device
    events' durations (`torch.profiler`) and their count, means of n calls.
    `cold`: a pass over a 128 MB buffer before every call empties the L2
    (its kernel is left out of the sum).  Raises where five profiles in a
    row come back short of device events."""
    from torch.profiler import ProfilerActivity, profile

    if not _FLUSH:
        _FLUSH.append(torch.zeros(32 * 1024 * 1024, dtype=torch.int32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a profile now and then comes back short of device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    _FLUSH[0].bitwise_not_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in _device_events(prof) if "bitwise_not" not in e.name]
        if ev and len(ev) % n == 0:  # every call's events are there
            return sum(e.time_range.elapsed_us() for e in ev) / n / 1e3, len(ev) / n
    raise RuntimeError("the profiler lost device events in five profiles in a row")


def _device_ms(fn, cold: bool, n: int = 20) -> float:
    return _device_time(fn, cold, n)[0]


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_and_time(name, shape, kernel, plain, nbytes, flops, library=None,
                    timed: bool = True, check=None) -> dict:
    """`kernel()` against `plain()` bit for bit, or, given `check`, held by
    `check(kernel())`, which returns (its largest error, what fails or
    None); with `timed`, both (and `library()`, one PyTorch call for the
    same function) timed: per call by CUDA events now, device time by the
    profiler with the L2 cold and warm in phase h (the row is filled in
    then, so `kernel`, `plain` and `library` must hold their inputs, not a
    loop's variables)."""
    if check is None:
        got, ref = _flat(kernel()), _flat(plain())
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() if a.numel() else 0.0 for a, b in zip(got, ref))
        if len(got) != len(ref) or not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} differs from its plain version at {shape}: "
                                 f"max |diff| {err}")
        agree = "bit-equal"
    else:
        err, fails = check(kernel())
        if fails:
            raise AssertionError(f"{name} at {shape}: {fails}")
        agree = f"within tolerance (largest relative error {err:.3e})"
    row = dict(name=name, shape=shape, **{"max_abs_err" if check is None else "max_rel_err": err})
    if not timed:
        print(f"{name} {shape}: {agree}")
        return row
    bound_ms, bound_by = _bound(nbytes, flops)
    row.update(call_ms=_median_ms(kernel), plain_call_ms=_median_ms(plain, reps=10, warmup=2),
               bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    print(f"{name} {shape}: {agree}; per call {row['call_ms']:.4f} ms, plain "
          f"{row['plain_call_ms']:.4f} ms (CUDA events, medians of 30 and 10)")

    def profiled() -> None:
        row.update(
            ms=_device_ms(kernel, cold=True), warm_ms=_device_ms(kernel, cold=False),
            plain_ms=_device_ms(plain, cold=True, n=5),
            library_ms=None if library is None else _device_ms(library, cold=True, n=10),
        )
        lib = "" if library is None else f", library call {1e3 * row['library_ms']:.2f} us"
        print(f"{name} {shape}: device {1e3 * row['ms']:.2f} us cold, "
              f"{1e3 * row['warm_ms']:.2f} us warm (profiler, mean of 20); plain "
              f"{1e3 * row['plain_ms']:.2f} us device{lib}; {nbytes / 1e6:.3f} MB, bound "
              f"{1e3 * bound_ms:.2f} us by {bound_by}, share of bound "
              f"{bound_ms / row['ms']:.2f} cold, {bound_ms / row['warm_ms']:.2f} warm")

    _DEFERRED.append(profiled)
    return row


# Operations per pixel, for the bounds: K1 two harmonic means (2 differences,
# 3 divisions, 1 sum each) and 2 mask products; K2's blur 7 per window column
# (2 of them per output) and 7 per output; the valid mean 6 sums, a division.
K1_FLOPS_PER_PIXEL = 14
K2_FLOPS_PER_OUTPUT = 21
DEPTH_FLOPS_PER_OUTPUT = 7
# Shapes that cross tile edges and take the one-pixel instantiation
AWKWARD_K1 = [(3, 22, 36), (1, 6, 6), (5, 38, 124), (2, 9, 131), (1, 3, 5), (2, 33, 130)]
AWKWARD_K2 = [(3, 22, 36), (1, 6, 6), (5, 38, 124), (2, 10, 264), (2, 10, 134), (1, 2, 2)]


def _k1_bytes(stacks, masks=None) -> int:
    """Bytes a K1 launch must move: every pixel read once and written
    twice, and every distinct mask (a level's gray and depth stacks share
    one) read once."""
    unique = {m.data_ptr(): m.numel() for m in masks or () if m is not None}
    return sum(3 * 4 * x.numel() for x in stacks) + sum(unique.values())


def check_k1(rng) -> dict:
    """Phase b: K1 against its plain version at every level shape, at the
    awkward shapes, and as the grouped launch over a whole pyramid."""
    rows = []
    for h, w in LEVEL_SHAPES:
        for c in (2, 8):
            x = _plateau_inputs(c, h, w, rng)
            rows.append(_check_and_time(
                "K1 fused_gradients", (c, h, w), lambda x=x: HK.fused_gradients(x),
                lambda x=x: HK.fused_gradients_plain(x), _k1_bytes([x]),
                K1_FLOPS_PER_PIXEL * c * h * w,
            ))
    for c, h, w in AWKWARD_K1:
        x = _plateau_inputs(c, h, w, rng)
        m = _seam_like_masks([(h, w)], rng)[0]
        for what, xi in (("", x), (" (misaligned)", _misaligned(x))):
            for mask in (None, m):
                rows.append(_check_and_time(
                    f"K1 fused_gradients{what}{' masked' if mask is not None else ''}",
                    (c, h, w), lambda: HK.fused_gradients(xi, mask),
                    lambda: HK.fused_gradients_plain(xi, mask), 0, 0, timed=False,
                ))
    groups = {}
    for tag, c in RIG_BATCHES.items():
        for h, w in RIG_LEVEL_SHAPES:
            x = _plateau_inputs(c, h, w, rng)
            rows.append(_check_and_time(
                f"K1 fused_gradients ({tag})", (c, h, w), lambda x=x: HK.fused_gradients(x),
                lambda x=x: HK.fused_gradients_plain(x), _k1_bytes([x]),
                K1_FLOPS_PER_PIXEL * c * h * w,
            ))
        # the pyramid's launch: gray and depth of the c sensors at 5 levels
        stacks = [f(c, h, w, rng) for h, w in RIG_LEVEL_SHAPES
                  for f in (_plateau_inputs, _depth_inputs)]
        groups[tag] = _check_and_time(
            f"K1 fused_gradients_levels ({tag})", (c, f"{tag} 5 levels", len(stacks)),
            lambda s=stacks: HK.fused_gradients_levels(s, None),
            lambda s=stacks: HK.fused_gradients_levels_plain(s, None), _k1_bytes(stacks),
            K1_FLOPS_PER_PIXEL * sum(x.numel() for x in stacks),
        )
        rows.append(groups[tag])
    for b in (1, 4):
        stacks = [f(b, h, w, rng) for h, w in LEVEL_SHAPES for f in (_plateau_inputs, _depth_inputs)]
        masks = [m for m in _seam_like_masks(LEVEL_SHAPES, rng) for _ in range(2)]
        for mk in (None, masks):
            before = K1.launches
            HK.fused_gradients_levels(stacks, mk)
            if K1.launches != before + 1:
                raise AssertionError("the grouped K1 call is not one launch")
            n_px = sum(x.numel() for x in stacks)
            row = _check_and_time(
                f"K1 fused_gradients_levels{' masked' if mk else ''}",
                (b, "5 levels", len(stacks)),
                lambda s=stacks, m=mk: HK.fused_gradients_levels(s, m),
                lambda s=stacks, m=mk: HK.fused_gradients_levels_plain(s, m),
                _k1_bytes(stacks, mk),
                K1_FLOPS_PER_PIXEL * n_px,
            )
            rows.append(row)
            if mk:
                groups[b] = row
    count, bits = HK.check_fast_reciprocal()
    if count:
        raise AssertionError(f"K1's fast reciprocal differs from IEEE division at {count} "
                             f"floats, e.g. bits {bits:#010x}")
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), rows=rows, groups=groups,
                rcp_mismatches=count)


def _sandwich(x: torch.Tensor):
    """The banded `A @ img @ B` pyrDown of the reference as one PyTorch
    call chain: K2's library yardstick, used nowhere in the port."""
    from rgbd360_tpu_torch.ops.pyramid import _blur_decim_mats

    a, b = _blur_decim_mats(x.shape[-2], x.shape[-1], x.device)
    return lambda: (a @ x) @ b


def check_k2(rng) -> dict:
    """Phase c: K2 against its plain version at every transition shape in
    both row modes, `fused_level_down` at every transition shape for B = 1
    and 4, and all of them at the awkward shapes."""
    rows, transitions = [], {}
    for h, w in TRANSITION_SHAPES:
        for c in (1, 4):
            x = _plateau_inputs(c, h, w, rng)
            d = _depth_inputs(c, h, w, rng)
            nbytes = 5 * c * h * w  # 4 bytes in, a quarter of that out
            flops = K2_FLOPS_PER_OUTPUT * c * h * w // 4
            for circ, fn in ((False, HK.fused_pyr_down), (True, HK.fused_pyr_down_circular)):
                rows.append(_check_and_time(
                    f"K2 {fn.__name__}", (c, h, w), lambda fn=fn, x=x: fn(x),
                    lambda x=x, circ=circ: HK.fused_pyr_down_plain(x, circular=circ),
                    nbytes, flops,
                    library=_sandwich(x) if circ else None, timed=circ or c == 4,
                ))
            before = K2.launches
            HK.fused_level_down(x, d, MIN_DEPTH, MAX_DEPTH)
            if K2.launches != before + 1:
                raise AssertionError("fused_level_down is not one launch")
            row = _check_and_time(
                "K2 fused_level_down (gray + depth)", (c, h, w),
                lambda x=x, d=d: HK.fused_level_down(x, d, MIN_DEPTH, MAX_DEPTH),
                lambda x=x, d=d: HK.fused_level_down_plain(x, d, MIN_DEPTH, MAX_DEPTH),
                2 * nbytes,
                flops + DEPTH_FLOPS_PER_OUTPUT * c * h * w // 4, library=_sandwich(x),
            )
            rows.append(row)
            transitions[(c, h, w)] = row
    for (tag, c), (h, w) in itertools.product(RIG_BATCHES.items(), RIG_TRANSITION_SHAPES):
        x, d = _plateau_inputs(c, h, w, rng), _depth_inputs(c, h, w, rng)
        nbytes, flops = 5 * c * h * w, K2_FLOPS_PER_OUTPUT * c * h * w // 4
        rows.append(_check_and_time(
            f"K2 fused_pyr_down_circular ({tag})", (c, h, w),
            lambda x=x: HK.fused_pyr_down_circular(x),
            lambda x=x: HK.fused_pyr_down_plain(x, circular=True), nbytes, flops,
            library=_sandwich(x),
        ))
        row = _check_and_time(
            f"K2 fused_level_down ({tag}, gray + depth)", (c, h, w),
            lambda x=x, d=d: HK.fused_level_down(x, d, MIN_DEPTH, MAX_DEPTH),
            lambda x=x, d=d: HK.fused_level_down_plain(x, d, MIN_DEPTH, MAX_DEPTH),
            2 * nbytes, flops + DEPTH_FLOPS_PER_OUTPUT * c * h * w // 4, library=_sandwich(x),
        )
        rows.append(row)
        transitions[(c, h, w)] = row
    for c, h, w in AWKWARD_K2:
        x = _plateau_inputs(c, h, w, rng)
        d = _depth_inputs(c, h, w, rng)
        for what, xi, di in (("", x, d), (" (misaligned)", _misaligned(x), _misaligned(d))):
            for circ, fn in ((False, HK.fused_pyr_down), (True, HK.fused_pyr_down_circular)):
                rows.append(_check_and_time(
                    f"K2 {fn.__name__}{what}", (c, h, w), lambda: fn(xi),
                    lambda: HK.fused_pyr_down_plain(xi, circular=circ), 0, 0, timed=False,
                ))
            rows.append(_check_and_time(
                f"K2 fused_level_down{what}", (c, h, w),
                lambda: HK.fused_level_down(xi, di, MIN_DEPTH, MAX_DEPTH),
                lambda: HK.fused_level_down_plain(xi, di, MIN_DEPTH, MAX_DEPTH), 0, 0,
                timed=False,
            ))
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), rows=rows,
                transitions=transitions)


# The dense sweep's normal equations (`csrc/normal_equations.cu`): (batch,
# pixels) of the main path's sweeps: level 0 (a tracked solve's polish, and a
# verification's at three elements), level 1, a verification's salient subset
# and the coarse yaw grid at level 4.  Per pixel and element, both terms:
# bytes 12 of tp, 1 of the visible mask and 21 a term (12 of a, 4 of w, 4 of
# r, 1 of the mask); operations 71 a term (the cross product 9, J's 6
# products, the 21 H and 6 g fused multiply-adds, the squared sum's one).
NEQ_SHAPES = [(1, 614400), (3, 614400), (1, 153600), (3, 16384), (16, 2400)]
NEQ_BYTES_PER_PIXEL = 12 + 1 + 2 * 21
NEQ_FLOPS_PER_PIXEL = 2 * 71
# Against the plain version summed in float64 (the card tests' limits):
# H within 1e-6 relative Frobenius and each squared sum within 1e-6
# relative (sums of positive addends, which a float32 tree over <= 2^20 of
# them keeps within ~20 ulp); g within 1e-6 of the norm of |J|^T |r| (the
# scale of its signed addends: g nears 0 as a solve converges, and that
# cancellation is not the kernel's error); the counts exact.
NEQ_RTOL = 1e-6


def _neq_inputs(b: int, n: int, seed: int) -> tuple:
    """A sweep's operands on the card, both terms: points at 1-5 m, Jacobian
    prefixes over five decades, weights in (0, 1], 60% of the pixels kept
    by each term's mask, residuals 0 where it is off."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    tp = torch.randn((b, n, 3), generator=gen, device="cuda") * (1 + 4 * u(b, n, 1))
    vis = u(b, n) < 0.9
    terms = {}
    for p in ("photo", "depth"):
        m = (u(b, n) < 0.6) & vis
        a = torch.randn((b, n, 3), generator=gen, device="cuda") * 10.0 ** (5 * u(b, n, 1) - 3)
        terms[p] = (a, torch.where(m, 0.05 + 0.95 * u(b, n), 0.0), m,
                    torch.where(m, 0.1 * torch.randn((b, n), generator=gen, device="cuda"), 0.0))
    return tp, terms, vis


def _neq_check(args):
    """`_check_and_time`'s check of the kernel's (H, g, stats) on `args`
    against the plain version summed in float64, to NEQ_RTOL."""
    tp, terms, vis = args

    def check(got) -> tuple:
        h, g, st = got
        h0, g0, st0 = HK.normal_equations_plain(
            tp.double(), {k: (a.double(), w.double(), m, r.double())
                          for k, (a, w, m, r) in terms.items()}, vis)
        scale = torch.zeros_like(g0)
        for a, w, m, r in terms.values():
            jac = torch.cat([a, torch.linalg.cross(tp, a, dim=-1)], -1).double() * w[..., None]
            scale += (torch.where(m[..., None], jac, 0.0).abs().mT @ r.double().abs()[..., None])[..., 0]
        gaps = {
            "H": (torch.linalg.norm((h.double() - h0).flatten(1), dim=1)
                  / torch.linalg.norm(h0.flatten(1), dim=1)).max().item(),
            "g": (torch.linalg.norm(g.double() - g0, dim=1)
                  / torch.linalg.norm(scale, dim=1)).max().item(),
        }
        gaps.update({k: ((st[k].double() - v).abs() / v).max().item()
                     for k, v in st0.items() if k.endswith("_sq")})
        fails = [f"{k} {v:.3e} (tol {NEQ_RTOL})" for k, v in gaps.items() if not v <= NEQ_RTOL]
        fails += [f"{k} {st[k].tolist()} != {v.tolist()}" for k, v in st0.items()
                  if not k.endswith("_sq") and not torch.equal(st[k], v)]
        if not torch.equal(h, h.mT):
            fails.append("H is not symmetric")
        return max(gaps.values()), "; ".join(fails)

    return check


def check_normal_equations() -> dict:
    """Phase o: the normal equations kernel against its plain version
    summed in float64 at the main path's sweep shapes, each timed beside
    the plain version (the code it replaced: `cat`, `cross`, `where`, the
    float32 GEMM and GEMV) and the library's `J^T J` GEMM alone."""
    rows, main = [], None
    for seed, (b, n) in enumerate(NEQ_SHAPES):
        args = _neq_inputs(b, n, seed)
        before = HK.normal_equations.launches
        HK.normal_equations(*args)
        if HK.normal_equations.launches != before + 2:
            raise AssertionError("a normal_equations call is not two launches")
        jac = torch.randn((b, n, 6), device="cuda")
        row = _check_and_time(
            "normal_equations", (b, n), lambda a=args: HK.normal_equations(*a),
            lambda a=args: HK.normal_equations_plain(*a), NEQ_BYTES_PER_PIXEL * b * n,
            NEQ_FLOPS_PER_PIXEL * b * n, library=lambda j=jac: j.mT @ j, check=_neq_check(args),
        )
        rows.append(row)
        main = main or row
    return dict(max_rel_err=max(r["max_rel_err"] for r in rows), rows=rows, main=main)


class _Swapped:
    """Swap a kernel wrapper of `hopper_kernels` for its plain version
    (through the function the path calls, not a flag in the path)."""

    def __init__(self, name: str, plain):
        self.name, self.plain = name, plain

    def __enter__(self):
        self.kernel = getattr(HK, self.name)
        setattr(HK, self.name, self.plain)

    def __exit__(self, *exc):
        setattr(HK, self.name, self.kernel)


def _swaps():
    """(name, counter, swap) of each kernel the paths launch."""
    return (
        ("K1", K1, _Swapped("fused_gradients_levels", HK.fused_gradients_levels_plain)),
        ("K2", K2, _Swapped("fused_level_down", HK.fused_level_down_plain)),
    )


def track_pairs(builder, aligner, frames, timed: bool = False) -> dict:
    """Build every frame with its pyramid, then align each consecutive
    pair (T_prev<-cur) seeded with the previous pair's pose (constant
    velocity; identity for the first).  `frames` are RigFrames on the
    builder's device."""
    build_ms, align_ms, pyrs = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        pyrs.append(builder.build_with_pyramid(f)[1])
        if timed:
            torch.cuda.synchronize()
            build_ms.append(1e3 * (time.perf_counter() - t0))
    dev = builder.sensor.device
    seed = torch.eye(4, device=dev)
    out = {k: [] for k in ("poses", "hessians", "errors", "iters", "ill_posed", "sso")}
    for i in range(1, len(pyrs)):
        t0 = time.perf_counter()
        res = aligner.align(pyrs[i], pyrs[i - 1], seed, method=D.PHOTO_DEPTH)
        if timed:
            torch.cuda.synchronize()
            align_ms.append(1e3 * (time.perf_counter() - t0))
        seed = res.pose
        out["poses"].append(res.pose.cpu().numpy())
        out["hessians"].append(res.hessian.cpu().numpy())
        out["errors"].append(res.error.item())
        out["iters"].append(res.iters.cpu().numpy())
        out["ill_posed"].append(bool(res.ill_posed))
        out["sso"].append(res.sso.item())
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(build_ms=build_ms, align_ms=align_ms)
    return out


def _pose_gaps(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """Largest translation (m) and rotation (rad) gap between pose stacks."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()
    rel = np.einsum("pji,pjk->pik", a[:, :3, :3], b[:, :3, :3])
    # angle = atan2(2 sin, 2 cos): accurate for tiny angles, unlike arccos
    v = np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                  rel[:, 1, 0] - rel[:, 0, 1]], axis=1)
    ang = np.arctan2(np.linalg.norm(v, axis=1), np.trace(rel, axis1=1, axis2=2) - 1.0)
    return float(dt), float(ang.max())


def _gate_gaps(what, got, ref, tol_m, tol_rad) -> tuple[float, float]:
    dt, dr = _pose_gaps(got, ref)
    print(f"{what}: max translation gap {dt:.3e} m (tol {tol_m}), "
          f"max rotation gap {dr:.3e} rad (tol {tol_rad})")
    if dt > tol_m or dr > tol_rad:
        raise AssertionError(f"{what}: poses leave the tolerance")
    return dt, dr


def _gate_branches(what, got: np.ndarray, branches: np.ndarray,
                   tol: tuple = (GOLDEN_TOL_M, GOLDEN_TOL_RAD)) -> np.ndarray:
    """Each pose of `got` (n, 4, 4) within `tol` (the golden tolerance by
    default) of the nearest of the golden's branches (P, n, 4, 4); returns
    the matched branch of each element."""
    matched, worst = [], (0.0, 0.0)
    for i in range(len(got)):
        gaps = [_pose_gaps(got[i : i + 1], b[i : i + 1]) for b in branches]
        j = min(range(len(gaps)), key=lambda b: gaps[b][0] / tol[0] + gaps[b][1] / tol[1])
        matched.append(j)
        worst = (max(worst[0], gaps[j][0]), max(worst[1], gaps[j][1]))
    to0 = _pose_gaps(got, branches[0])
    spread = max(_pose_gaps(b, branches[0])[0] for b in branches)
    print(f"{what}: nearest golden branches {matched}: max gap {worst[0]:.3e} m "
          f"(tol {tol[0]}), {worst[1]:.3e} rad (tol {tol[1]}); to the "
          f"unjittered golden {to0[0]:.3e} m, {to0[1]:.3e} rad; the golden's "
          f"{len(branches)} branches spread over {spread:.3e} m")
    if worst[0] > tol[0] or worst[1] > tol[1]:
        raise AssertionError(f"{what}: poses leave the golden's tolerance")
    return np.asarray(matched)


def _gate_poses(what, res: dict, prefix: str, offsets) -> None:
    """Finite, well-posed poses with the walk's axial offsets."""
    poses = res[f"{prefix}_poses"]
    steps = poses[:, 0, 3]
    print(f"{what}: axial offsets (m) {steps.tolist()} (expected "
          f"{np.round(offsets, 6).tolist()} +- {STEP_TOL_M}); "
          f"iterations per level {res[f'{prefix}_iters'].tolist()}")
    if not np.isfinite(poses).all():
        raise AssertionError(f"{what}: non-finite pose")
    if res[f"{prefix}_ill_posed"].any():
        raise AssertionError(f"{what}: ill-posed alignment {res[f'{prefix}_ill_posed']}")
    if np.abs(steps - np.asarray(offsets)).max() > STEP_TOL_M:
        raise AssertionError(f"{what}: axial offsets {steps} not {offsets} +- {STEP_TOL_M} m")


def load_reference_maps(builder: FrameBuilder) -> None:
    """Stitch with the reference builder's own maps (the state carried
    across, as a model port loads the reference's weights): the two
    packages' maps differ on the sensor-tie columns, and the salient sweeps
    of the batch phases would turn that into centimetres."""
    levels = builder.config.dense.pyramid_levels
    state = convert.stitch_maps_state_dict(np.load(REFERENCE_MAPS), levels)
    builder.load_state_dict(state, strict=False)


def _synthetic_setup(n_frames: int, dense_cfg=None, reference_maps: bool = False):
    """(builder, aligner, RigFrames) of the full-size synthetic sequence on
    the card."""
    cfg = synthetic.config()
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    if reference_maps:
        load_reference_maps(builder)
    aligner = D.DenseAligner(dense_cfg or cfg.dense)
    frames = [RigFrame.from_raw(raw) for raw in synthetic_raws(n_frames)]
    return builder, aligner, frames


def check_slice() -> dict:
    """Phase d: the first slice at full size, against the JAX golden."""
    golden = np.load(GOLDEN)
    t0 = time.perf_counter()
    builder, aligner, frames = _synthetic_setup(N_FRAMES)
    torch.cuda.synchronize()
    print(f"slice set-up (calibration maps, synthetic captures): "
          f"{time.perf_counter() - t0:.2f} s")

    track_pairs(builder, aligner, frames[:2])  # warm-up
    _reset_counts()
    run = track_pairs(builder, aligner, frames, timed=True)
    launches = _counts()
    _require_launches(launches, "slice")

    poses = run["poses"]
    steps = poses[:, 0, 3]
    print(f"axial steps (m): {steps.tolist()}")
    print(f"iterations per level: {run['iters'].tolist()}")
    print(f"errors: {run['errors'].tolist()}  sso: {run['sso'].tolist()}")
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite pose")
    if run["ill_posed"].any():
        raise AssertionError(f"ill-posed alignment: {run['ill_posed'].tolist()}")
    if np.abs(steps - STEP_M).max() > STEP_TOL_M:
        raise AssertionError(f"axial steps {steps} not {STEP_M} +- {STEP_TOL_M} m")

    _gate_gaps("slice vs JAX golden", poses, golden["poses"], GOLDEN_TOL_M, GOLDEN_TOL_RAD)
    same_iters = int((run["iters"] == golden["iters"]).all(axis=1).sum())
    print(f"slice vs JAX golden: max error gap "
          f"{np.abs(run['errors'] - golden['errors']).max():.3e}; "
          f"{same_iters}/{len(poses)} pairs with identical iteration counts")

    sphere = builder.build(frames[0])
    pyramid = check_pyramid_stage(lambda: builder.pyramid(sphere),
                                  builder.config.dense.pyramid_levels)
    build_ms = statistics.median(run["build_ms"])
    align_ms = statistics.median(run["align_ms"])
    print(f"build_with_pyramid: median {build_ms:.3f} ms/frame over {N_FRAMES} "
          f"frames; align: median {align_ms:.3f} ms/pair over {N_FRAMES - 1} pairs")

    for name, counter, swap in _swaps():
        before = counter.launches
        with swap:
            plain = track_pairs(builder, aligner, frames)
        if counter.launches != before:
            raise AssertionError(f"{name} launched while swapped out")
        sdt, sdr = _pose_gaps(poses, plain["poses"])
        print(f"slice with plain {name} vs {name}: pose gap {sdt:.3e} m, {sdr:.3e} rad")
        if sdt > SWAP_TOL or sdr > SWAP_TOL:
            raise AssertionError(f"{name} and its plain version give different poses")
    return dict(launches=launches, build_ms=build_ms, align_ms=align_ms, pyramid=pyramid)


def check_pyramid_stage(pyramid, levels: int, what: str = "pyramid stage") -> dict:
    """One pyramid (`pyramid()`, a frame's or a rig's) is 1 K1 launch and
    levels - 1 K2 launches, and (in phase h) a profiled pyramid runs
    nothing else on the device (no `bmm` pair, no seam multiply, no stack
    copy).  Returns its wall ms; phase h adds its device ops and busy ms."""
    pyramid()
    _reset_counts()
    pyramid()
    counts = _pyramid_counts(_counts())
    if counts != {"fused_gradients": 1, "fused_pyr_down": levels - 1}:
        raise AssertionError(f"{what}: one pyramid launched {counts}, not 1 K1 and "
                             f"{levels - 1} K2")
    pyr_ms = statistics.median(_host_ms(pyramid, reps=30))
    print(f"{what}: launches {counts}; wall {pyr_ms:.3f} ms (median of 30)")
    out = dict(wall_ms=pyr_ms)

    def profiled() -> None:
        # the profiler now and then drops device events: a profile that shows
        # fewer ops than were launched is taken again, and none may show more
        names: list = []
        for _ in range(5):
            wall, busy, ops, _, _ = _profile(pyramid, names)
            if ops >= levels:
                break
        foreign = [n for n in names
                   if "fused_gradients_kernel" not in n and "level_down_kernel" not in n]
        if ops != levels or foreign:
            raise AssertionError(f"{what} launched {levels} kernels and its profile "
                                 f"shows {ops} device ops ({names}), {foreign} not K1's "
                                 f"or K2's")
        print(f"{what}, profiled: {ops} device ops (all K1's and K2's kernels), device "
              f"busy {busy:.4f} ms, wall {wall:.3f} ms")
        out.update(device_ops=ops, busy_ms=busy)

    _DEFERRED_PYRAMIDS.append(profiled)
    return out


def _result_np(res: D.AlignResult, prefix: str) -> dict:
    fields = {"poses": "pose", "hessians": "hessian", "errors": "error",
              "iters": "iters", "ill_posed": "ill_posed", "sso": "sso"}
    return {f"{prefix}_{k}": getattr(res, f).cpu().numpy() for k, f in fields.items()}


def batch_inputs(builder, frames):
    """(keyframe pyramid, stacked raw rgbs, stacked raw depths, seeds) of
    the batch phase: frame 0 is the keyframe, frames 1.. the batch, each
    seeded one 0.1 m step short of its offset."""
    trg = builder.build_with_pyramid(frames[0])[1]
    rgbs = torch.stack([f.rgb for f in frames[1:]])
    depths = torch.stack([f.depth for f in frames[1:]])
    seeds = torch.from_numpy(synthetic.walk_seeds(STEP_M * np.arange(len(frames) - 1)))
    return trg, rgbs, depths, seeds.to(rgbs.device)


def track_batch(builder, aligner, trg, rgbs, depths, seeds):
    """The batched tracking path: (batch pyramid, batched AlignResult)."""
    grays, sphere_depths = builder.build_gray_depth_batch(rgbs, depths)
    pyr = D.build_frame_pyramid_batch(
        grays, sphere_depths, builder.config.dense, builder.seam_levels
    )
    return pyr, aligner.align(pyr, trg, seeds, method=D.PHOTO_DEPTH)


def align_unbatched(aligner, srcs, trgs, seeds) -> dict:
    """One unbatched `align` per element: the batched solve's twin."""
    out = [aligner.align(s, t, p, method=D.PHOTO_DEPTH) for s, t, p in zip(srcs, trgs, seeds)]
    return {"poses": np.stack([r.pose.cpu().numpy() for r in out]),
            "iters": np.stack([r.iters.cpu().numpy() for r in out])}


def run_coarse(aligner, src, trg) -> dict:
    """coarse_errors and coarse_align over the yaw grid (the tracker
    rescue's pattern)."""
    cands = torch.from_numpy(se3.yaw_grid(YAW_HYPOTHESES).astype(np.float32))
    cands = cands.to(src.gray[0].device)
    poses, errs = aligner.coarse_align(src, trg, cands)
    return {"coarse_static_errors": aligner.coarse_errors(src, trg, cands).cpu().numpy(),
            "coarse_poses": poses.cpu().numpy(), "coarse_errors": errs.cpu().numpy()}


def batch_dense_config(cfg):
    """The batch phases' DenseRegConfig: the default with the salient-pixel
    budget of the reference's batch-4 pipeline."""
    return dataclasses.replace(cfg.dense, salient_pixels=synthetic.BATCH_SALIENT_PIXELS)


def check_batch(builder, aligner, frames, smi: str) -> dict:
    """Phase e: the batched tracking path at full size."""
    golden = np.load(BATCH_GOLDEN)
    n = BATCH_FRAMES - 1
    offsets = STEP_M * np.arange(1, n + 1)

    inputs = batch_inputs(builder, frames)
    track_batch(builder, aligner, *inputs)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    inputs = batch_inputs(builder, frames)
    pyr, res = track_batch(builder, aligner, *inputs)
    torch.cuda.synchronize()
    launches = _counts()
    _require_launches(launches, "batch path")
    got = _result_np(res, "batch")

    _gate_poses("batch path", got, "batch", offsets)
    m = _gate_branches("batch path vs JAX golden", got["batch_poses"],
                       golden["batch_branch_poses"])
    print(f"matched branches' iterations "
          f"{golden['batch_branch_iters'][m, np.arange(n)].tolist()}")

    trg, _, _, seeds = inputs
    one = align_unbatched(aligner, D.unstack_pyramid(pyr), [trg] * n, seeds)
    _gate_gaps("batch path vs unbatched align", got["batch_poses"], one["poses"],
               UNBATCHED_TOL_M, UNBATCHED_TOL_RAD)
    print(f"unbatched iterations per level {one['iters'].tolist()}")

    _, counter, swap = _swaps()[1]
    before = counter.launches
    with swap:
        _, plain = track_batch(builder, aligner, *inputs)
    if counter.launches != before:
        raise AssertionError("K2 launched while swapped out")
    _gate_gaps("batch path with plain K2 vs K2", plain.pose.cpu().numpy(),
               got["batch_poses"], SWAP_TOL, SWAP_TOL)

    times = _host_ms(lambda: track_batch(builder, aligner, *inputs), reps=7)
    ms = statistics.median(times)
    fps = n / (ms / 1e3)
    print(f"batch path: {fps:.2f} frames/s (median {ms:.3f} ms per {n}-frame batch "
          f"over {len(times)} repeats, spread {min(times):.3f}-{max(times):.3f} ms) "
          f"on {smi}")
    return dict(launches=launches, fps=fps, batch_ms=ms)


def align_targets(builder, aligner, frames) -> tuple[dict, list]:
    """batch_align_targets of the last frame against all the others (each
    seeded one step short), and the coarse rescue of frame 1 against frame
    0; returns (results, pyramids)."""
    pyrs = [builder.build_with_pyramid(f)[1] for f in frames]
    n = len(frames) - 1
    seeds = synthetic.walk_seeds(STEP_M * np.arange(n - 1, -1, -1))
    res = D.batch_align_targets(aligner, pyrs[n], pyrs[:n], list(seeds))
    out = _result_np(res, "targets")
    out.update(run_coarse(aligner, pyrs[1], pyrs[0]))
    return out, pyrs


def check_targets(builder, aligner, frames) -> dict:
    """Phase f: batch_align_targets and the coarse rescue."""
    golden = np.load(BATCH_GOLDEN)
    n = BATCH_FRAMES - 1
    offsets = STEP_M * np.arange(n, 0, -1)

    _reset_counts()
    got, pyrs = align_targets(builder, aligner, frames)
    _require_launches(_counts(), "batch_align_targets phase")
    _gate_poses("batch_align_targets", got, "targets", offsets)
    m = _gate_branches("batch_align_targets vs JAX golden", got["targets_poses"],
                       golden["targets_branch_poses"])
    seeds = torch.from_numpy(synthetic.walk_seeds(STEP_M * np.arange(n - 1, -1, -1)))
    seeds = seeds.to(builder.sensor.device)
    one = align_unbatched(aligner, [pyrs[n]] * n, pyrs[:n], seeds)
    _gate_gaps("batch_align_targets vs unbatched align", got["targets_poses"],
               one["poses"], UNBATCHED_TOL_M, UNBATCHED_TOL_RAD)
    print(f"batch_align_targets iterations {got['targets_iters'].tolist()}, unbatched "
          f"{one['iters'].tolist()}, matched golden branches "
          f"{golden['targets_branch_iters'][m, np.arange(n)].tolist()}")
    seeds_list = list(seeds)
    targets_ms = statistics.median(_host_ms(
        lambda: D.batch_align_targets(aligner, pyrs[n], pyrs[:n], seeds_list), reps=5
    ))
    print(f"batch_align_targets ({n} targets): median {targets_ms:.3f} ms over 5")

    check_coarse(got, golden)
    return dict(targets_ms=targets_ms)


def check_coarse(got: dict, golden: dict) -> None:
    """coarse_errors and coarse_align against the golden: the same static
    errors, the same best hypothesis, and each refined pose (with its
    error) on one of the golden's branches."""
    print(f"coarse_errors {got['coarse_static_errors'].tolist()}, golden "
          f"{golden['coarse_static_errors'].tolist()}")
    print(f"coarse_align errors {got['coarse_errors'].tolist()}, golden "
          f"{golden['coarse_errors'].tolist()}")
    np.testing.assert_allclose(got["coarse_static_errors"], golden["coarse_static_errors"],
                               rtol=COARSE_ERR_RTOL)
    if int(np.argmin(got["coarse_errors"])) != int(np.argmin(golden["coarse_errors"])):
        raise AssertionError("coarse_align ranks another hypothesis first")
    m = _gate_branches("coarse_align vs JAX golden", got["coarse_poses"],
                       golden["coarse_branch_poses"])
    np.testing.assert_allclose(
        got["coarse_errors"], golden["coarse_branch_errors"][m, np.arange(len(m))],
        rtol=COARSE_ERR_RTOL,
    )


def synthetic_raws(n_frames: int, subsample: int = 1) -> list:
    """The synthetic captures as `RawRigFrame`s (host numpy), the input of
    `FrameToFrameOdometry.process`."""
    return [RawRigFrame(rgb=rgb, depth_mm=d) for rgb, d in synthetic.captures(n_frames, subsample)]


def track_odometry(builder, raws, timer: StageTimer | None = None) -> dict:
    """`FrameToFrameOdometry` over raw captures, each through `process`.
    The seeds each frame's chain tried and the PbMap results are recorded
    by wrapping the tracker's `aligner.align` and `plane_reg.register` (as
    the golden tool does for the reference); everything recorded is fetched
    after the run.  Returns the golden's keys, and `process_ms` per frame
    (host clock, synchronized)."""
    tracker = FrameToFrameOdometry(builder)
    if timer is not None:
        tracker.timer = timer
    seeds, pbs, planes, ms = [], [], [], []
    align, register = tracker.aligner.align, tracker.plane_reg.register

    def record_align(src, trg, init_pose=None, *args, **kw):
        seeds[-1].append(init_pose)
        return align(src, trg, init_pose, *args, **kw)

    def record_register(*args, **kw):
        pbs.append(register(*args, **kw))
        return pbs[-1]

    tracker.aligner.align = record_align
    tracker.plane_reg.register = record_register
    for raw in raws:
        seeds.append([])
        t0 = time.perf_counter()
        tracker.process(raw)
        if builder.sensor.is_cuda:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        planes.append(tracker.prev.planes)
    pbs, planes, seeds = fetch(pbs), fetch(planes), fetch(seeds[1:])
    stats = tracker.stats
    out = {
        "rel": np.stack([i["rel"] for i in stats]).astype(np.float32),
        "tracked": np.array([i["tracked"] for i in stats]),
        "pb_matches": np.array([i["pb_matches"] for i in stats]),
        "av_depth_residual": np.array([i["av_depth_residual"] for i in stats]),
        "sso": np.array([i["sso"] for i in stats]),
        "pb_success": np.array([bool(p.success) for p in pbs]),
        "pb_pose": np.stack([p.pose.numpy() for p in pbs]),
        "pb_pairs": np.stack([p.pairs.numpy() for p in pbs]),
        "seed_counts": np.array([len(x) for x in seeds]),
        "seeds": np.stack([x.numpy() for f in seeds for x in f]),
        "process_ms": np.array(ms),
    }
    for f in ("normal", "center", "area", "valid"):
        out[f"planes_{f}"] = np.stack([getattr(p, f).numpy() for p in planes])
    return out


def _matched_plane_gaps(got: dict, golden: dict) -> tuple[float, float, float]:
    """Largest normal angle (rad), centre distance (m) and relative area
    gap between each golden valid plane and the port's valid plane of the
    same frame with the nearest centre (slots of near-equal area may come
    in another order)."""
    worst = np.zeros(3)
    for f in range(len(golden["planes_valid"])):
        gv, pv = golden["planes_valid"][f], got["planes_valid"][f]
        gc, pc = golden["planes_center"][f][gv], got["planes_center"][f][pv]
        if len(gc) == 0 or len(pc) == 0:
            continue
        near = np.argmin(np.linalg.norm(gc[:, None] - pc[None], axis=-1), axis=1)
        gn = golden["planes_normal"][f][gv].astype(np.float64)
        pn = got["planes_normal"][f][pv][near].astype(np.float64)
        # atan2(|a x b|, a . b): accurate for tiny angles, unlike arccos
        ang = np.arctan2(np.linalg.norm(np.cross(gn, pn), axis=-1), np.sum(gn * pn, axis=-1)).max()
        dc = np.linalg.norm(gc - pc[near], axis=-1).max()
        ga, pa = golden["planes_area"][f][gv], got["planes_area"][f][pv][near]
        da = (np.abs(ga - pa) / ga).max()
        worst = np.maximum(worst, [ang, dc, da])
    return tuple(float(x) for x in worst)


def check_odometry(got: dict, golden: dict, what: str = "odometry") -> dict:
    """Phase g's gates on one run against the golden; returns the gaps."""
    rel, steps = got["rel"], got["rel"][:, 0, 3]
    print(f"{what}: axial steps (m) {steps.tolist()} (golden "
          f"{golden['rel'][:, 0, 3].tolist()}); PbMap matches {got['pb_matches'].tolist()} "
          f"(golden {golden['pb_matches'].tolist()}); seeds tried "
          f"{got['seed_counts'].tolist()}; valid planes "
          f"{got['planes_valid'].sum(axis=1).tolist()}")
    if not np.isfinite(rel).all():
        raise AssertionError(f"{what}: non-finite pose")
    if not got["tracked"].all() or not golden["tracked"].all():
        raise AssertionError(f"{what}: untracked frames {got['tracked']} (golden {golden['tracked']})")
    if np.abs(steps - STEP_M).max() > STEP_TOL_M:
        raise AssertionError(f"{what}: axial steps {steps} not {STEP_M} +- {STEP_TOL_M} m")
    dt, dr = _gate_gaps(f"{what} rel vs JAX golden", rel, golden["rel"], GOLDEN_TOL_M, GOLDEN_TOL_RAD)
    if not np.array_equal(got["seed_counts"], golden["seed_counts"]):
        raise AssertionError(f"{what}: seeds tried {got['seed_counts']}, golden {golden['seed_counts']}")
    _gate_gaps(f"{what} seeds vs JAX golden", got["seeds"], golden["seeds"], SEED_TOL_M, SEED_TOL_RAD)
    if not np.array_equal(got["pb_success"], golden["pb_success"]):
        raise AssertionError(f"{what}: PbMap success {got['pb_success']}, golden {golden['pb_success']}")
    both = got["pb_success"] & golden["pb_success"]
    pb = (0.0, 0.0)
    if both.any():
        pb = _gate_gaps(f"{what} PbMap pose vs JAX golden", got["pb_pose"][both],
                        golden["pb_pose"][both], PB_TOL_M, PB_TOL_RAD)
    same_pairs = [bool(np.array_equal(a, b)) for a, b in zip(got["pb_pairs"], golden["pb_pairs"])]
    print(f"{what}: PbMap pairs identical to the golden's on {sum(same_pairs)}/{len(same_pairs)} frames")
    n_got, n_ref = got["planes_valid"].sum(axis=1), golden["planes_valid"].sum(axis=1)
    if not np.array_equal(n_got, n_ref):
        raise AssertionError(f"{what}: valid planes {n_got.tolist()}, golden {n_ref.tolist()}")
    ang, dc, da = _matched_plane_gaps(got, golden)
    print(f"{what}: matched planes vs JAX golden: normal {ang:.3e} rad (tol {PLANE_TOL_RAD}), "
          f"centre {dc:.3e} m (tol {PLANE_TOL_M}), area {da:.3e} relative (tol {PLANE_TOL_AREA})")
    if ang > PLANE_TOL_RAD or dc > PLANE_TOL_M or da > PLANE_TOL_AREA:
        raise AssertionError(f"{what}: matched planes leave the tolerance")
    return dict(rel_m=dt, rel_rad=dr, pb_m=pb[0], pb_rad=pb[1], plane_rad=ang,
                plane_m=dc, plane_area=da)


def _count_syncs(fn) -> int:
    """Host syncs in fn(), counted by PyTorch's sync debug mode: a lower
    bound, since the mode does not yet see every synchronizing operation
    (`_profile` counts the host waits the profiler records)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


REGIONS = {"build", "stitch", "cloud", "pyramid", "segment", "register", "align",
           "fused_track", "register_pbmap", "register_dense", "loop_closure", "optimize",
           "frame", "track.fetch", "kf_pyramid", "partition", "relocalize", "relocalize.scan",
           "relocalize.verify", "event.A", "event.B", "event.C", "event.rescue", "event.D",
           "event.fetch", "event.drain"}


# CUDA runtime calls that block the host; `cudaDeviceSynchronize` is left
# out, since the path never calls it and the profile's own closing
# `torch.cuda.synchronize()` is one
HOST_WAITS = {"cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


def _profile(fn, names: list | None = None) -> tuple[float, float, int, int, int]:
    """(wall ms, device busy ms, device ops, host waits, device-to-host
    copies) of one profiled call; busy is the union of the device events'
    intervals, host waits the count of `HOST_WAITS` calls.  `names`, when
    given, is filled with the device events' names."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    if names is not None:
        names[:] = [e.name for e in events]
    busy, end = 0.0, -np.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    waits = sum(e.name in HOST_WAITS for e in prof.events())
    d2h = sum(e.name.startswith("Memcpy DtoH") for e in events)
    return wall, busy / 1e3, len(events), waits, d2h


def check_odometry_phase(smi: str) -> None:
    """Phase g: FrameToFrameOdometry at full size against the JAX golden."""
    golden = dict(np.load(ODOMETRY_GOLDEN))
    t0 = time.perf_counter()
    cfg = synthetic.config()
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    raws = synthetic_raws(N_FRAMES)
    print(f"odometry set-up (calibration maps, synthetic captures): "
          f"{time.perf_counter() - t0:.2f} s")

    first = track_odometry(builder, raws)  # warm-up, and the first of two runs
    _reset_counts()
    with planes_finite() as finite:
        run = track_odometry(builder, raws)
    _require_launches(_counts(), "odometry")
    check_planes_finite(finite, "odometry")
    check_odometry(run, golden)
    dt, dr = _pose_gaps(first["rel"], run["rel"])
    print(f"odometry, two runs: rel gap {dt:.3e} m, {dr:.3e} rad")
    if dt > SWAP_TOL or dr > SWAP_TOL:
        raise AssertionError("two odometry runs give different poses")
    for k in ("planes_valid", "pb_pairs", "seed_counts"):
        if not np.array_equal(first[k], run[k]):
            raise AssertionError(f"two odometry runs differ in {k}")

    process_ms = statistics.median(run["process_ms"][1:])
    frame = RigFrame.from_raw(raws[1])
    build_ms = statistics.median(_host_ms(lambda: builder.build_full(frame), reps=7))
    print(f"odometry: process median {process_ms:.3f} ms per tracked frame "
          f"(all {np.round(run['process_ms'], 3).tolist()}); build_full median "
          f"{build_ms:.3f} ms per frame over 7, on {smi}")
    timer = StageTimer()
    timer.enable()
    track_odometry(builder, raws, timer)
    print(f"odometry spans ({N_FRAMES} frames):\n{timer.report()}")
    reg = [sp.ms for sp in timer.spans if sp.name == "register"]
    print(f"odometry: PbMap register {sum(reg) / len(reg):.3f} ms per tracked frame "
          f"(host span, its fetch included)")

    tracker = FrameToFrameOdometry(builder)
    tracker.process(raws[0])
    syncs = [_count_syncs(lambda r=r: tracker.process(r)) for r in raws[1:]]
    planes = builder.build_full(frame)[2]
    parts = {"build_full": _count_syncs(lambda: builder.build_full(frame)),
             "register": _count_syncs(lambda: fetch(tracker.plane_reg.register(planes, planes)))}
    print(f"odometry: host syncs per tracked frame (sync debug mode, a lower bound) "
          f"{syncs}; of which build_full {parts['build_full']}, register + fetch "
          f"{parts['register']}")

    def profiled() -> None:
        tracker = FrameToFrameOdometry(builder)
        tracker.process(raws[0])
        prev = tracker.prev
        wall, busy, ops, waits, d2h = _profile(lambda: tracker.process(raws[1]))
        print(f"odometry, one profiled frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}, device ops {ops}, host waits {waits}, "
              f"device-to-host copies {d2h}")
        for name, fn in _odometry_stages(builder, tracker, prev, frame).items():
            fn()
            wall, busy, ops, waits, d2h = _profile(fn)
            print(f"odometry stage {name}: wall {wall:.3f} ms (profiled), device busy "
                  f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, device ops {ops}, "
                  f"host waits {waits}, device-to-host copies {d2h}")

    _DEFERRED.append(profiled)


def _odometry_stages(builder, tracker, prev, frame) -> dict:
    """The stages of a tracked frame (frame against `prev`, the tracker's
    previous state) as calls, for one profile each: the two costliest of
    the front end (the bilateral and the connected-component scans) alone."""
    rig, seg_cfg = builder.config.rig, builder.config.seg
    sphere, pyr, planes = builder.build_full(frame)
    d_small = downsample2_depth(builder._undistort_depth(frame.depth))
    _, compat_r, compat_c = seg_ops._compat_masks(sphere.local_xyz, sphere.cloud_valid, seg_cfg)
    eye = torch.eye(4, device=frame.depth.device)
    return {
        "build (stitch + cloud)": lambda: builder.build(frame),
        "bilateral": lambda: bilateral_depth(d_small, rig.bilateral_sigma_s, rig.bilateral_sigma_r),
        "segment": lambda: builder.segment_planes(sphere),
        "_connected_labels": lambda: seg_ops._connected_labels(
            compat_r, compat_c, sphere.cloud_valid, seg_cfg.cc_iters),
        "pyramid": lambda: builder.pyramid(sphere),
        "register + fetch": lambda: fetch(tracker.plane_reg.register(prev.planes, planes)),
        "align + fetch (identity seed)": lambda: fetch(
            tracker.aligner.align(pyr, prev.pyramid, eye)),
    }


# ------------------------------------------------------------- phase i
#
# Phase i against the JAX golden.  A tracked solve of this loop (15 degrees
# and 0.21 m per frame) leaves most pyramid levels through the
# accept-if-improved exit after 1-4 steps; rounding decides which step is
# the last, and two runs' poses then end up to 1.3 cm apart while their
# residuals agree to 3e-3 relative (measured on frame 2 between the
# reference and the port, BOTH on the CPU and on the reference's stitch
# maps; on the card 1.21e-2 m, 2.1e-3 rad at most).  Poses are relative to
# the keyframe, so the gaps do not chain: the frame after is back within
# 0.1-0.5 mm.  With deferred events, in addition, the frame at which an
# event's optimized poses land depends on when its phases are ready (a race
# between host and device, and another in the reference's run on the CPU;
# the golden's own two modes differ by 1.0e-2 m): 7.9e-3 rad measured.
# Hence 0.02 m (the reference's bound for deferred against synchronous
# events) and 0.01 rad for both modes, for the CHAINED trajectory only.
# Each tracked solve itself is held tight (TRACK_TOL, check_tracked_solves):
# re-solved by the port from the golden's seed on the same frames, it lies
# within 5.3e-5 m / 9.0e-6 rad of the nearest of the golden's 13 solves of
# it from micrometre-jittered seeds (on an H100; 7.1e-5 m in phase j),
# while those 13 spread over up to 13.0 mm (frame 2; 15.0 mm in phase j).
KF_TOL_M, KF_TOL_RAD = 0.02, 0.01
# The graph's information matrices are the Hessians of 600k-pixel solves
# (chi2 4.6e4 with millimetres of residual), so the final chi2 moves with
# the edges' millimetres: measured 1.35e-3 relative.  The solvers alone,
# on the same graph as the reference, are held to SOLVER_CHI2_RTOL.
KF_CHI2_RTOL = 5e-3
SOLVER_CHI2_RTOL = 1e-3
KF_ATE_SLACK_M = 5e-3
ASYNC_SYNC_TOL_M = 0.02  # the reference's own bound (its async-vs-sync test)
KIDNAP_TOL_M = 0.15  # the reference's own bound (its kidnapped-robot test)
# A resumed run tracks against keyframe pyramids rebuilt from the
# bfloat16 payload without seam masks; bfloat16 keeps 8 bits, so a depth of
# 4-8 m is stored in steps of 3.1 cm.  Measured 8.1e-3 m from the
# uninterrupted run (the reference holds its own, shorter, sequence to
# 2e-3 m); the bound is the tracked solves' own (KF_TOL_M).
RESUME_TOL_M = 0.02
SOLVER_POSE_TOL = 1e-4  # m and rad, a solved graph against the golden's
# A closure's edge is the pose of its verification (or of its heading
# rescue), salient solves that have several solutions within reach of
# rounding (see the batch phases): it is held to the NEAREST of the
# reference's solves from micrometre-jittered seeds.  Measured on an H100:
# the loop's closure 2-5 (accepted through the rescue in both packages)
# lies 7.1e-4 m, 4.5e-5 rad from the nearest of 53 (8.5e-4 m from the
# unjittered one), while the 53 spread over 2.1e-4 m only: here it is not
# the seed that separates the packages but their stitch maps, which differ
# on the sensor-tie columns (the batch phases load the reference's maps for
# that reason; this phase runs the port's own).  Hence 4x the golden's
# tolerance in translation.
LC_EDGE_TOL = (4 * GOLDEN_TOL_M, GOLDEN_TOL_RAD)
SCAN_KEYFRAMES = 64


def loop_raws(n_frames: int, subsample: int = 1, frames=None) -> list:
    """The closed loop's captures (`synthetic.loop_captures`) as
    `RawRigFrame`s, the input of `KeyframeSLAM.process`."""
    return [RawRigFrame(rgb=rgb, depth_mm=d)
            for rgb, d in synthetic.loop_captures(n_frames, subsample, frames)]


def keyframe_record(slam, gt=None) -> dict:
    """What a finished `KeyframeSLAM` run is compared on (call after
    `flush()`): per-frame flags, the edge list sorted, the areas, both
    trajectories, the final graph's chi2 and the per-keyframe event counts
    with the edges' measured poses (the keys of the golden tool's
    `keyframe_record`)."""
    ev = slam.events
    n_kf, n_e = int(slam.map.n_kf), int(slam.map.n_edges)
    edges = np.concatenate(
        [slam.map.graph.edges_ij[:n_e].cpu().numpy(),
         slam.map.edge_is_lc[:n_e, None].cpu().numpy().astype(np.int32)], axis=1)
    kf_ev = [e for e in ev if e["keyframe"]]
    order = np.lexsort(edges.T[::-1])  # stable: equal (i, j, is_lc) keep their order
    out = {
        "keyframe": np.array([e["keyframe"] for e in ev]),
        "lost": np.array([bool(e.get("lost", False)) for e in ev]),
        "relocalized": np.array([bool(e["relocalized"]) for e in ev]),
        "edges": edges[order],
        "edge_rel": slam.map.graph.rel[:n_e].cpu().numpy()[order],
        "n_loop_closures": np.int64(slam.n_loop_closures),
        "area": slam.map.area[:n_kf].cpu().numpy(),
        "n_areas": np.int64(int(slam.map.n_areas)),
        "trajectory": np.stack(slam.trajectory).astype(np.float32),
        "optimized_trajectory": slam.optimized_trajectory().astype(np.float32),
        "opt_poses": slam.map.opt_poses[:n_kf].cpu().numpy(),
        "chi2": np.float32(graph_ops.graph_chi2(slam.map.graph).item()),
        "fused_track": np.int64(slam.timer.counts.get("fused_track", 0)),
        "connections": np.array([e.get("connections", 0) for e in kf_ev]),
        "loop_closures": np.array([e.get("loop_closures", 0) for e in kf_ev]),
        "optimized": np.array([bool(e.get("optimized", False)) for e in kf_ev]),
        "av_depth_residual": np.array([e.get("av_depth_residual", np.nan) for e in ev]),
    }
    if gt is not None:
        out["gt"] = np.asarray(gt, np.float32)
    return out


def keyframe_config(cfg, async_events: bool):
    return cfg.replace(kf=dataclasses.replace(cfg.kf, async_kf_events=async_events))


def run_keyframe(slam, raws, gt=None) -> dict:
    """`KeyframeSLAM` over raw captures, each through `process`, then
    `flush()`; the record, and `process_ms` per frame (host clock,
    synchronized on the card)."""
    ms = []
    for raw in raws:
        t0 = time.perf_counter()
        slam.process(raw)
        if slam.device.type == "cuda":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    slam.flush()
    out = keyframe_record(slam, gt)
    out["process_ms"] = np.array(ms)
    return out


def same_partition(a, b) -> bool:
    """Two area labellings are the same partition (equal up to a
    permutation of the labels)."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(a) == len(b) and len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def describe_decisions(got: dict) -> str:
    return (f"keyframes at frames {np.flatnonzero(got['keyframe']).tolist()}, lost "
            f"{np.flatnonzero(got['lost']).tolist()}, relocalized "
            f"{np.flatnonzero(got['relocalized']).tolist()}; {len(got['edges'])} edges, "
            f"{int(got['edges'][:, 2].sum())} loop closures; connections per keyframe "
            f"{got['connections'].tolist()}; areas {got['area'].tolist()}")


def check_keyframe_decisions(got: dict, ref: dict, what: str) -> None:
    """The decisions of one run against another's (the golden's, or the
    port's own other mode): flags, keyframe frames, edges, closures,
    partition up to relabelling."""
    print(f"{what}: {describe_decisions(got)}")
    for k in ("keyframe", "lost", "relocalized"):
        if not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"{what}: `{k}` flags {np.flatnonzero(got[k]).tolist()}, "
                                 f"expected {np.flatnonzero(ref[k]).tolist()}")
    if not np.array_equal(got["edges"], ref["edges"]):
        raise AssertionError(f"{what}: edges (i, j, is_lc) {got['edges'].tolist()}, expected "
                             f"{ref['edges'].tolist()}")
    if int(got["n_loop_closures"]) != int(ref["n_loop_closures"]):
        raise AssertionError(f"{what}: {got['n_loop_closures']} loop closures, expected "
                             f"{ref['n_loop_closures']}")
    if int(got["n_areas"]) != int(ref["n_areas"]) or not same_partition(got["area"], ref["area"]):
        raise AssertionError(f"{what}: areas {got['area'].tolist()}, expected (up to "
                             f"relabelling) {ref['area'].tolist()}")


def check_closure_edges(got: dict, lc_verify: dict, what: str, tol: tuple = LC_EDGE_TOL) -> list:
    """Each loop-closure edge's measured pose within `tol` (m, rad) of the
    NEAREST of the reference's solves of that closure (its verification, or
    its heading rescue where that was the accepted one) from
    micrometre-jittered seeds (`lc_verify`: the golden's `lc_verify_*` keys
    without the prefix).  Returns each closure's (m, rad) gap."""
    edges, out = got["edges"], []
    for n, (i, j) in enumerate(lc_verify["edges"].tolist()):
        row = np.flatnonzero((edges == (i, j, 1)).all(axis=1))
        if len(row) != 1:
            raise AssertionError(f"{what}: closure {i}-{j} of the golden is no edge of this run")
        branches = lc_verify["branch_poses"][:, n : n + 1]
        gaps = [_pose_gaps(got["edge_rel"][row], b) for b in branches]
        dt, dr = min(gaps, key=lambda g: g[0] / tol[0] + g[1] / tol[1])
        spread = max(_pose_gaps(b, branches[0])[0] for b in branches)
        print(f"{what}: closure {i}-{j} ({'rescue' if lc_verify['rescued'][n] else 'verification'}) "
              f"vs the nearest of the golden's {len(gaps)} jittered solves: {dt:.3e} m, {dr:.3e} "
              f"rad (tol {tol[0]}, {tol[1]}); to the unjittered one {gaps[0][0]:.3e} m, "
              f"{gaps[0][1]:.3e} rad; the set spreads over {spread:.3e} m")
        out.append((dt, dr))
    if any(dt > tol[0] or dr > tol[1] for dt, dr in out):
        raise AssertionError(f"{what}: a closure's pose leaves the golden's solves")
    return out


# The loop's branches (phases i and k).  Its tracked solves are multi-stable
# (the golden's 13 jittered solves of frame 2 fall 0, 6.8 and 12.9 mm from
# the unjittered one), and a branch taken early moves every later edge and
# the final chi2.  Measured on an H100 (PERF.md, section 6, PR 20): the loop
# run with the plain normal equations (the sums the port had before the
# kernel, whose unjittered run is the golden's within 1.35e-3 of its chi2)
# from tracked seeds moved by 1 um reads final chi2 from -13.6% to +4.5% of
# the golden's, odometry edges up to 1.55e-2 m from its, and other decisions
# on 2 of 9 seed sets.  So the main path's run is held, for its final chi2
# and its edges' measured poses, to that branch set: the golden's run and
# those plain-sum runs whose decisions are the golden's, with the same
# tolerances (`check_keyframe_run`'s `branches`); the unjittered plain-sum
# run is held to the golden alone, as the main path was before the kernel.
LOOP_BRANCH_SEEDS = tuple(range(1, 7))  # the jittered seed sets
LOOP_JITTER_M = 1e-6


@contextlib.contextmanager
def plain_normal_equations():
    """The normal equations' plain version in place of the kernel, in GN
    graphs captured for the context (the main path's are set aside, and
    back when it closes)."""
    def plain(*args):
        return HK.normal_equations_plain(*args)

    plain.launches = 0
    saved = dict(D._GRAPHS)
    D._GRAPHS.clear()
    try:
        with _Swapped("normal_equations", plain):
            yield
    finally:
        D._GRAPHS.clear()
        D._GRAPHS.update(saved)


def jitter_seeds(slam, seed: int) -> None:
    """Move the seed of every solve of the tracker's aligner by
    LOOP_JITTER_M, in directions drawn from `seed`."""
    rng, align = np.random.default_rng(seed), slam.aligner.align

    def jittered(src, trg, init_pose, *args, **kw):
        pose = torch.as_tensor(init_pose, dtype=torch.float32, device=src.gray[0].device).clone()
        j = rng.normal(size=3)
        pose[..., :3, 3] += torch.as_tensor(j / np.linalg.norm(j) * LOOP_JITTER_M, device=pose.device)
        return align(src, trg, pose, *args, **kw)

    slam.aligner.align = jittered


def loop_branches(builder, cfg, raws, gt) -> list:
    """`KeyframeSLAM(builder, cfg)` over `raws` with the plain normal
    equations, unjittered and from each of LOOP_BRANCH_SEEDS: the records."""
    out = []
    with plain_normal_equations():
        for seed in (None, *LOOP_BRANCH_SEEDS):
            slam = KeyframeSLAM(builder, cfg)
            if seed is not None:
                jitter_seeds(slam, seed)
            out.append(run_keyframe(slam, raws, gt))
    return out


def check_loop_branches(branches: list, golden: dict, what: str) -> None:
    """The branch set's first run (unjittered plain sums) against the
    golden with every gate of `check_keyframe_run`; the others' decisions
    and final chi2 printed."""
    check_keyframe_run(branches[0], golden, f"{what}, plain normal equations")
    for seed, run in zip(LOOP_BRANCH_SEEDS, branches[1:]):
        same = _same_decisions(run, golden)
        print(f"{what}, plain normal equations, seeds moved by {LOOP_JITTER_M} m (set {seed}): "
              f"final chi2 {float(run['chi2']):.6f}, golden {float(golden['chi2']):.6f}; "
              f"{'the golden decisions' if same else 'other decisions: ' + describe_decisions(run)}")


def _same_decisions(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in ("keyframe", "lost", "relocalized", "edges"))


def _nearest_gaps(got: np.ndarray, refs: list, tol: tuple) -> tuple[float, float]:
    """Each pose of `got` against the same pose of the nearest of `refs`
    (pose stacks; by the gap over `tol`): the largest translation and
    rotation gaps."""
    dt, dr = [], []
    for n in range(len(got)):
        gaps = [_pose_gaps(got[n:n + 1], r[n:n + 1]) for r in refs]
        g = min(gaps, key=lambda g: g[0] / tol[0] + g[1] / tol[1])
        dt.append(g[0])
        dr.append(g[1])
    return max(dt, default=0.0), max(dr, default=0.0)


def check_keyframe_run(got: dict, golden: dict, what: str, tol_m: float = KF_TOL_M,
                       tol_rad: float = KF_TOL_RAD, chi2_rtol: float = KF_CHI2_RTOL,
                       edge_tol: tuple = (KF_TOL_M, KF_TOL_RAD), closures: bool = True,
                       raw_trajectory: bool = True, branches: list = ()) -> dict:
    """One loop run against the golden's run of the same mode: the
    decisions, the fused tracked frame on every healthy frame, both
    trajectories, the edges' measured poses, the final chi2 and the ATE.
    Without `closures` the loop closures' poses and the chi2 they weigh are
    printed, not gated (a closure's heading rescue may land on another
    alias of the room where every solve is a degraded one).  Without
    `raw_trajectory` only `optimized_trajectory` is gated: a run with
    deferred events against a golden with synchronous ones samples each
    frame before or after its keyframe's correction lands, depending on
    when the event ran (the reference's own async-vs-sync test compares
    optimized trajectories for that reason).  With `branches` (the loop's
    plain-sum runs, `loop_branches`), each edge's measured pose is held to
    the nearest of the golden's and those runs' with the golden's
    decisions, and the final chi2 to the range of theirs."""
    check_keyframe_decisions(got, golden, f"{what} vs JAX golden")
    if int(got["fused_track"]) != int(golden["fused_track"]) or got["fused_track"] < 1:
        raise AssertionError(f"{what}: the fused tracked frame ran {got['fused_track']} times, "
                             f"golden {golden['fused_track']} (of {len(got['keyframe']) - 1} "
                             f"frames after the first)")
    gaps, problems = {}, []
    for k in ("trajectory", "optimized_trajectory"):
        dt, dr = gaps[k] = _pose_gaps(got[k], golden[k])
        gated = raw_trajectory or k == "optimized_trajectory"
        print(f"{what} {k} vs JAX golden: max translation gap {dt:.3e} m, max rotation gap "
              f"{dr:.3e} rad " + (f"(tol {tol_m}, {tol_rad})" if gated else "(not gated)"))
        if gated and (dt > tol_m or dr > tol_rad):
            problems.append(f"{k} leaves the tolerance")
    per_frame = np.linalg.norm(got["trajectory"][:, :3, 3] - golden["trajectory"][:, :3, 3], axis=1)
    print(f"{what} trajectory vs JAX golden, per frame (mm): {(1e3 * per_frame).round(2).tolist()}")
    # the edges' measured poses: tracked solves (odometry), PbMap poses,
    # connection aligns, and the loop closures' salient verifications
    refs = [golden] + [b for b in branches if _same_decisions(b, golden)]
    against = "JAX golden" if len(refs) == 1 else (
        f"the nearest of the JAX golden and {len(refs) - 1} of {len(branches)} plain-sum runs "
        f"with its decisions")
    for name, lc in (("odometry and connection", 0), ("loop-closure", 1)):
        sel = got["edges"][:, 2] == lc
        if sel.any():
            dt, dr = gaps[f"edges_{lc}"] = _nearest_gaps(
                got["edge_rel"][sel], [r["edge_rel"][sel] for r in refs], edge_tol)
            gated = closures or not lc
            print(f"{what}: {int(sel.sum())} {name} edges' measured poses vs {against}: "
                  f"{dt:.3e} m, {dr:.3e} rad "
                  + (f"(tol {edge_tol[0]}, {edge_tol[1]})" if gated else "(not gated)"))
            if gated and (dt > edge_tol[0] or dr > edge_tol[1]):
                problems.append(f"{name} edges' poses leave the tolerance")
            if len(refs) > 1:
                g = _pose_gaps(got["edge_rel"][sel], golden["edge_rel"][sel])
                print(f"{what}: the same vs the JAX golden alone: {g[0]:.3e} m, {g[1]:.3e} rad")
    kf_gap = _pose_gaps(got["opt_poses"], golden["opt_poses"])
    print(f"{what}: optimized keyframe poses {kf_gap[0]:.3e} m, {kf_gap[1]:.3e} rad from the "
          f"golden's")
    chi2, chi2_g = float(got["chi2"]), float(golden["chi2"])
    lo, hi = min(float(r["chi2"]) for r in refs), max(float(r["chi2"]) for r in refs)
    rel = max(lo - chi2, chi2 - hi, 0.0) / max(chi2_g, 1e-12)
    print(f"{what}: final chi2 {chi2:.6f}, golden {chi2_g:.6f}"
          + ("" if len(refs) == 1 else f", the set's range [{lo:.6f}, {hi:.6f}]")
          + f" (relative gap {rel:.3e}, " + (f"tol {chi2_rtol})" if closures else "not gated)"))
    if closures and rel > chi2_rtol:
        problems.append("final chi2 leaves the tolerance")
    ate = metrics.ate_rmse(got["optimized_trajectory"], golden["gt"])
    ate_ref = metrics.ate_rmse(golden["optimized_trajectory"], golden["gt"])
    rpe_t, rpe_r = metrics.rpe(got["trajectory"], golden["gt"])
    print(f"{what}: ATE {ate:.5f} m (golden {ate_ref:.5f} m, slack {KF_ATE_SLACK_M}); RPE "
          f"{rpe_t:.5f} m, {rpe_r:.5f} rad; path length "
          f"{metrics.trajectory_length(got['trajectory']):.3f} m")
    if ate > ate_ref + KF_ATE_SLACK_M:
        problems.append(f"ATE {ate} worse than the golden's {ate_ref}")
    if problems:
        raise AssertionError(f"{what}: " + "; ".join(problems))
    return dict(gaps, chi2_rel=rel, ate=ate)


# Each tracked solve of the golden's run, re-solved by the port from the
# golden's own seed on the same two frames (a builder holding the
# reference's stitch maps), against the NEAREST of the reference's solves
# of it from micrometre-jittered seeds (`track_verify_*`, 13 per solve);
# measured spread and gaps beside KF_TOL_M.
TRACK_TOL = (GOLDEN_TOL_M, GOLDEN_TOL_RAD)


def check_tracked_solves(builder, raws, tv: dict, what: str, tol: tuple = TRACK_TOL) -> list:
    """The golden's tracked solves (`tv`: its `track_verify_*` keys without
    the prefix) solved by the port: `align(frame, keyframe, seed)` with the
    golden's seed, on pyramids that `builder` (holding the reference's
    stitch maps) builds of the same captures.  Each within `tol` of the
    nearest of the golden's jittered solves of it; returns each (m, rad)
    gap.  The chained trajectory keeps KF_TOL."""
    aligner = D.DenseAligner(builder.config.dense)
    dev = builder.sensor.device
    pyrs: dict = {}

    def pyramid(f):
        if f not in pyrs:
            pyrs[f] = builder.build_full(RigFrame.from_raw(raws[f], dev))[1]
        return pyrs[f]

    out, spreads = [], []
    for n, (f, kf, seed) in enumerate(zip(tv["frames"], tv["kf_frames"], tv["seeds"])):
        res = fetch(aligner.align(pyramid(int(f)), pyramid(int(kf)),
                                  torch.as_tensor(seed, device=dev), method=D.PHOTO_DEPTH))
        branches = tv["branch_poses"][:, n]
        gaps = [_pose_gaps(res.pose.numpy()[None], b[None]) for b in branches]
        out.append(min(gaps, key=lambda g: g[0] / tol[0] + g[1] / tol[1]))
        spreads.append(max(_pose_gaps(b[None], branches[0][None])[0] for b in branches))
    dt = np.array([g[0] for g in out])
    dr = np.array([g[1] for g in out])
    print(f"{what}: {len(out)} tracked solves (frames {tv['frames'].tolist()}) re-solved from the "
          f"golden's seeds, vs the nearest of the golden's {tv['branch_poses'].shape[0]} jittered "
          f"solves of each: max {dt.max():.3e} m, {dr.max():.3e} rad (tol {tol[0]}, {tol[1]}); per "
          f"solve (mm) {np.round(1e3 * dt, 3).tolist()}; the golden's jittered solves spread over "
          f"(mm) {np.round(1e3 * np.array(spreads), 3).tolist()}")
    if dt.max() > tol[0] or dr.max() > tol[1]:
        raise AssertionError(f"{what}: a tracked solve leaves the golden's solves (frames "
                             f"{tv['frames'][(dt > tol[0]) | (dr > tol[1])].tolist()})")
    return out


def check_async_vs_sync(asy: dict, syn: dict, pending: int) -> float:
    """The deferred pipeline reproduces the synchronous one (the
    reference's own test): the same decisions, nothing pending after
    `flush()`, optimized trajectories within ASYNC_SYNC_TOL_M."""
    if pending:
        raise AssertionError(f"{pending} keyframe events pending after flush()")
    check_keyframe_decisions(asy, syn, "deferred vs synchronous events")
    d = np.linalg.norm(asy["optimized_trajectory"][:, :3, 3]
                       - syn["optimized_trajectory"][:, :3, 3], axis=1).max()
    print(f"deferred vs synchronous events: optimized trajectories {d:.3e} m apart "
          f"(tol {ASYNC_SYNC_TOL_M})")
    if d > ASYNC_SYNC_TOL_M:
        raise AssertionError("the deferred pipeline's trajectory leaves the synchronous one's")
    return float(d)


def check_identical(a: dict, b: dict, what: str) -> None:
    """Two runs agree bit for bit in everything recorded."""
    for k in a:
        if k != "process_ms" and not np.array_equal(a[k], b[k], equal_nan=True):
            raise AssertionError(f"{what}: `{k}` differs between the two runs")
    print(f"{what}: identical, bit for bit")


def run_kidnap(slam, raws, gt) -> dict:
    """The kidnapped-rig run: the record, the frames at which the
    relocaliser took the yaw rescue (`coarse_align` called while lost), and
    each frame's distance to the ground truth."""
    coarse, calls = slam.aligner.coarse_align, []

    def record_coarse(*a, **kw):
        calls.append(len(slam.events))
        return coarse(*a, **kw)

    slam.aligner.coarse_align = record_coarse
    out = run_keyframe(slam, raws, gt)
    slam.aligner.coarse_align = coarse
    out["coarse_frames"] = np.asarray(calls, np.int64)
    out["errs"] = np.linalg.norm(out["trajectory"][:, :3, 3] - np.asarray(gt)[:, :3, 3], axis=1)
    return out


def check_kidnap(got: dict, golden: dict) -> None:
    """Lost at the blind capture, relocalised later, near the ground truth
    there and at the end, through the golden's branch."""
    teleport = synthetic.KIDNAP_ORDER.index(None)
    reloc = np.flatnonzero(got["relocalized"])
    print(f"kidnap: lost at {np.flatnonzero(got['lost']).tolist()}, relocalized at "
          f"{reloc.tolist()}, yaw rescue at {got['coarse_frames'].tolist()} (golden "
          f"{golden['coarse_frames'].tolist()}); distance to the ground truth "
          f"{np.round(got['errs'], 4).tolist()}")
    if not got["lost"][teleport]:
        raise AssertionError("kidnap: the teleport was not detected as lost")
    if len(reloc) == 0 or reloc[0] < teleport:
        raise AssertionError("kidnap: never relocalized")
    k = int(reloc[0])
    if got["errs"][k] > KIDNAP_TOL_M or got["errs"][-1] > KIDNAP_TOL_M:
        raise AssertionError(f"kidnap: relocalized {got['errs'][k]:.3f} m off, ended "
                             f"{got['errs'][-1]:.3f} m off (tol {KIDNAP_TOL_M})")
    for key in ("keyframe", "lost", "relocalized"):
        if not np.array_equal(got[key], golden[key]):
            raise AssertionError(f"kidnap: `{key}` flags {np.flatnonzero(got[key]).tolist()}, "
                                 f"golden {np.flatnonzero(golden[key]).tolist()}")
    if not np.array_equal(got["coarse_frames"], golden["coarse_frames"]):
        raise AssertionError("kidnap: the relocalisation took another branch than the golden's")


def run_checkpoint(builder, cfg, raws, cut: int, path) -> dict:
    """Run `cut` frames, save a checkpoint, resume it in a FRESH tracker and
    run the rest; the resumed tracker's record, and the pyramids it rebuilt
    from the payload (`rebuilds`)."""
    a = KeyframeSLAM(builder, cfg)
    for raw in raws[:cut]:
        a.process(raw)
    a.save_checkpoint(str(path))
    b = KeyframeSLAM(builder, cfg)
    b.resume_from_checkpoint(str(path))
    if b.current_kf != a.current_kf or b._n_kf_host != a._n_kf_host:
        raise AssertionError("the resumed tracker is not where the saved one was")
    b.timer.enable()
    out = run_keyframe(b, raws[cut:])
    out["rebuilds"] = np.asarray(
        [sp.attrs["kf"] for sp in b.timer.take_spans() if sp.name == "kf_pyramid"], np.int64
    )
    return out


def check_checkpoint(got: dict, full: dict, cut: int, tol_m: float = RESUME_TOL_M) -> None:
    """The resumed run gives the uninterrupted run's keyframes and edges,
    and a trajectory within `tol_m` of it."""
    for k in ("keyframe", "lost", "relocalized"):
        if not np.array_equal(got[k], full[k][cut:]):
            raise AssertionError(f"checkpoint: `{k}` flags after the resume "
                                 f"{np.flatnonzero(got[k]).tolist()}, uninterrupted "
                                 f"{np.flatnonzero(full[k][cut:]).tolist()}")
    if not np.array_equal(got["edges"], full["edges"]):
        raise AssertionError(f"checkpoint: edges {got['edges'].tolist()}, uninterrupted "
                             f"{full['edges'].tolist()}")
    d = np.linalg.norm(got["trajectory"][:, :3, 3] - full["trajectory"][:, :3, 3], axis=1).max()
    print(f"checkpoint at frame {cut}: the same keyframes and {len(got['edges'])} edges; "
          f"trajectory {d:.3e} m from the uninterrupted run (tol {tol_m}); "
          f"{len(got['rebuilds'])} keyframe pyramids rebuilt from the payload "
          f"(keyframes {got['rebuilds'].tolist()})")
    if got["trajectory"].shape != full["trajectory"].shape or d > tol_m:
        raise AssertionError("checkpoint: the resumed trajectory leaves the uninterrupted one")
    if len(got["rebuilds"]) == 0:
        raise AssertionError("checkpoint: no keyframe pyramid was rebuilt from the payload")


def solve_rings(device) -> dict:
    """`synthetic.ring_graph` through the dense LM at capacity 64 and the
    LM-PCG at capacity 256, both with DCS (the golden tool's `solvers_jax`):
    poses, chi2, iterations, switches, and each solver's wall ms."""
    out = {}
    for name, n_live, cap, e_cap, pcg in (("ring64", 48, 64, 512, False),
                                          ("ring256", 200, 256, 512, True)):
        leaves, loop_mask, _ = synthetic.ring_graph(n_live, cap, e_cap)
        g = convert.pose_graph_from_numpy(leaves, device)
        lm = torch.from_numpy(loop_mask).to(device)
        counts: list = []
        solve = ((lambda: graph_ops.optimize_pose_graph_pcg(g, 10, loop_mask=lm, cg_counts=counts))
                 if pcg else (lambda: graph_ops.optimize_pose_graph(g, 10, loop_mask=lm)))
        solve()  # warm-up
        counts.clear()
        t0 = time.perf_counter()
        poses, chi2, iters = solve()
        chi2_host = float(chi2)  # the copy waits for the solve
        ms = 1e3 * (time.perf_counter() - t0)
        again = solve()[0]
        out.update({
            f"{name}_poses": poses.cpu().numpy(), f"{name}_chi2": np.float32(chi2_host),
            f"{name}_iters": np.int64(iters), f"{name}_ms": ms,
            f"{name}_switches": graph_ops.loop_closure_switches(g, poses, lm).cpu().numpy(),
            f"{name}_chi2_start": np.float32(float(graph_ops.graph_chi2(g))),
            f"{name}_identical": bool(torch.equal(poses, again)),
            f"{name}_cg": np.asarray(counts[: int(iters)], np.int64),
            f"{name}_wrong": np.int64(int(leaves[5].sum()) - 1),
            f"{name}_live": np.int64(n_live),
        })
    return out


def check_solvers(got: dict, golden: dict, smi: str = "") -> None:
    problems = []
    for name, solver in (("ring64", "dense LM, capacity 64"), ("ring256", "LM-PCG, capacity 256")):
        n = int(got[f"{name}_live"])
        rel = abs(float(got[f"{name}_chi2"]) - float(golden[f"{name}_chi2"])) / float(
            golden[f"{name}_chi2"])
        dt, dr = _pose_gaps(got[f"{name}_poses"][:n], golden[f"{name}_poses"][:n])
        s = got[f"{name}_switches"]
        wrong = int(got[f"{name}_wrong"])
        cg = got[f"{name}_cg"]
        print(f"solver {name} ({solver}): chi2 {float(got[f'{name}_chi2_start']):.3f} -> "
              f"{float(got[f'{name}_chi2']):.5f} (golden {float(golden[f'{name}_chi2']):.5f}, "
              f"relative gap {rel:.3e}, tol {SOLVER_CHI2_RTOL}) in {int(got[f'{name}_iters'])} LM "
              f"iterations (golden {int(golden[f'{name}_iters'])})"
              + (f", CG iterations {cg.tolist()}" if len(cg) else "")
              + f"; poses {dt:.3e} m, {dr:.3e} rad from the golden's (tol {SOLVER_POSE_TOL}); "
              f"wrong closure's switch {s[wrong]:.4f} (golden "
              f"{golden[f'{name}_switches'][wrong]:.4f}); {got[f'{name}_ms']:.3f} ms {smi}")
        if rel > SOLVER_CHI2_RTOL or dt > SOLVER_POSE_TOL or dr > SOLVER_POSE_TOL:
            problems.append(f"solver {name} leaves the golden's tolerance")
        # odometry edges stay hard (1.0); the wrong closure is switched off;
        # every switch is the golden's
        gap = np.abs(s - golden[f"{name}_switches"]).max()
        if s[wrong] > 0.25 or (s[: n - 1] != 1.0).any() or gap > 1e-2:
            problems.append(f"solver {name}: DCS switches {s[n - 1: wrong + 1].tolist()} "
                            f"(golden's differ by {gap:.3e})")
        if not got[f"{name}_identical"]:
            problems.append(f"solver {name}: a second solve differs from the first")
    if problems:
        raise AssertionError("; ".join(problems))


def filled_map(cfg, states, poses, n_kf: int, device) -> Map360:
    """A map filled to `n_kf` keyframes from the frame states of a loop run
    (cycled, each lap shifted 5 cm sideways), with odometry edges between
    consecutive keyframes, partitioned by the host partitioner."""
    m = Map360.empty(cfg.map, cfg.sphere.height, cfg.sphere.width, cfg.seg.max_planes,
                     cfg.seg.hull_dirs, device)
    n = len(states)
    for k in range(n_kf):
        st, pose = states[k % n], np.array(poses[k % n], np.float32)
        pose[1, 3] += 0.05 * (k // n)
        m = m.add_keyframe(pose, st.sphere.sphere_gray, st.sphere.sphere_depth, st.planes,
                           n_live=k)
    ij = np.stack([np.arange(n_kf - 1), np.arange(1, n_kf)], axis=1)
    eye4 = np.tile(np.eye(4, dtype=np.float32), (n_kf - 1, 1, 1))
    eye6 = np.tile(np.eye(6, dtype=np.float32), (n_kf - 1, 1, 1))
    m = m.add_edges(ij, eye4, eye6, np.full(n_kf - 1, 0.7, np.float32),
                    np.zeros(n_kf - 1, bool), n_live=0)
    # co-visibility falling off with distance along the sequence
    idx = np.arange(n_kf)
    sso = np.clip(1.0 - np.abs(idx[:, None] - idx[None, :]) / 8.0, 0.0, 1.0).astype(np.float32)
    m.sso[:n_kf, :n_kf] = torch.from_numpy(sso).to(device)
    area, n_areas = partition_map(m, cfg.map.sso_partition_threshold)
    m.area.copy_(torch.from_numpy(area))
    m.n_areas.fill_(n_areas)
    return m


def scan_filled_map(cfg, m: Map360, states, query: int) -> dict:
    """The loop closer's scan and the relocaliser over a filled map for the
    planes of frame `query`, against a loop over the unbatched matcher."""
    from rgbd360_tpu_torch.registration import planes as P

    n_kf = int(m.n_kf)
    closer, reloc = LoopCloser(cfg), Relocalizer(cfg)
    planes = states[query].planes
    pose = m.opt_poses[query].cpu().numpy()
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    scan, scan_ms = timed(lambda: fetch(closer.scan_dispatch(m, planes, pose, n_kf - 1)))
    r, reloc_ms = timed(lambda: reloc.relocalize(m, planes))
    gate = torch.arange(m.kf_capacity, device=m.device) < n_kf
    n_b, area_b, pose_b, _, obs_b = fetch(closer._batch_match_impl(planes, m.planes, gate))
    n_loop = []
    for k in range(n_kf):
        one = type(planes)(**{f.name: getattr(m.planes, f.name)[k]
                              for f in dataclasses.fields(planes)})
        n_loop.append(P.match_planes(one, planes, cfg.matcher, P.PLANAR_3DOF)[1])
    n_loop = torch.stack(n_loop).cpu().numpy()
    # the relocaliser's rule on the scan's results: most matches, then newest
    rc = cfg.reloc
    ok = obs_b.numpy() & (n_b.numpy() >= rc.min_matches) & (area_b.numpy() > rc.min_area)
    expect = int(np.argmax(np.where(ok, n_b.numpy() * 1000 + np.arange(len(ok)), -1)))
    return dict(scan_idx=scan[0].numpy(), scan_ok=scan[1].numpy(), scan_ms=scan_ms,
                reloc_kf=r.kf, reloc_success=r.success, reloc_pose=r.pose, reloc_ms=reloc_ms,
                reloc_matches=r.n_matches, n_batched=n_b.numpy()[:n_kf], n_loop=n_loop,
                areas=int(m.n_areas), reloc_expect=expect, pose_expect=pose_b[expect].numpy(),
                valid_planes=[int(st.planes.valid.sum()) for st in states],
                non_finite=[i for i, st in enumerate(states) if not all(
                    bool(torch.isfinite(getattr(st.planes, f.name)[st.planes.valid]).all())
                    for f in dataclasses.fields(st.planes))])


def check_scan(got: dict, query: int, smi: str = "") -> None:
    print(f"scan over {len(got['n_loop'])} keyframes in {got['areas']} areas: candidates "
          f"{got['scan_idx'].tolist()} (valid {got['scan_ok'].tolist()}), {got['scan_ms']:.3f} ms; "
          f"relocalise -> keyframe {got['reloc_kf']} with {got['reloc_matches']} matched planes, "
          f"{got['reloc_ms']:.3f} ms {smi}; matches per keyframe, batched "
          f"{got['n_batched'].tolist()}; valid planes per frame {got['valid_planes']}; frames "
          f"with a non-finite valid plane {got['non_finite']}")
    if got["non_finite"]:
        raise AssertionError(f"frames {got['non_finite']} hold non-finite valid planes")
    if not np.array_equal(got["n_batched"], got["n_loop"]):
        raise AssertionError(f"the batched matcher's counts differ from a loop over the "
                             f"unbatched one: {got['n_loop'].tolist()}")
    if not got["scan_ok"].any():
        raise AssertionError("the scan found no candidate in a map that holds the query's place")
    if got["n_loop"][query] < got["n_loop"].max() - 2:
        raise AssertionError(f"the query's own keyframe matches {got['n_loop'][query]} planes, "
                             f"others up to {got['n_loop'].max()}")
    # in the eightfold-symmetric room other frames match as many planes as
    # the query's own; the winner is the newest of those with the most
    if not got["reloc_success"] or got["reloc_kf"] != got["reloc_expect"]:
        raise AssertionError(f"relocalised to keyframe {got['reloc_kf']}, the scan's results "
                             f"give {got['reloc_expect']}")
    if not np.array_equal(got["reloc_pose"], got["pose_expect"]):
        raise AssertionError("the relocalisation's pose is not the scan's for that keyframe")


def _gate_collector(failed: list):
    """A `gate(check, *args)` that runs one gate: a failed one is reported
    at once and appended to `failed`, which the phase raises at its end
    with every other failed gate (so one run shows them all)."""
    def gate(check, *args, **kw):
        try:
            return check(*args, **kw)
        except AssertionError as err:
            print(f"GATE FAILED: {err}")
            failed.append(str(err))
    return gate


def _phase_times(slam) -> list:
    """Wrap the tracker's `_advance_head`: a list, filled as the tracker
    runs, of one list per event of the wall ms of each phase it advanced
    (synchronized)."""
    advance, log = slam._advance_head, []

    def timed():
        if slam._pending[0][1] is None:  # an event's first advance
            log.append([])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance()
        torch.cuda.synchronize()
        log[-1].append(1e3 * (time.perf_counter() - t0))

    slam._advance_head = timed
    return log


def check_keyframe_phase(smi: str) -> None:
    """Phase i: KeyframeSLAM at full size against the JAX golden."""
    import tempfile

    failed: list = []
    gate = _gate_collector(failed)
    golden = dict(np.load(KEYFRAME_GOLDEN))
    sub = lambda p: {k[len(p) + 1:]: v for k, v in golden.items() if k.startswith(p + "_")}  # noqa: E731
    t0 = time.perf_counter()
    cfg = synthetic.config()
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    raws = loop_raws(LOOP_FRAMES)
    gt = synthetic.loop_poses(LOOP_FRAMES)
    print(f"keyframe SLAM set-up (calibration maps, {LOOP_FRAMES} loop captures): "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    cfg_sync = keyframe_config(cfg, False)

    # the main path: the default (deferred events) tracker over the loop
    asy_slam = KeyframeSLAM(builder)
    _reset_counts()
    with planes_finite() as finite:
        asy = run_keyframe(asy_slam, raws, gt)
    counts = _counts()
    _require_launches(counts, "keyframe SLAM")
    if counts["fused_pyr_down"] != 4 * counts["fused_gradients"]:
        raise AssertionError(f"a pyramid is not 1 K1 + 4 K2 launches: {counts}")
    ref_builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    load_reference_maps(ref_builder)
    gate(check_tracked_solves, ref_builder, raws, sub("track_verify"), "keyframe SLAM")
    del ref_builder
    gate(check_closure_edges, asy, sub("lc_verify"), "keyframe SLAM (deferred events)")

    syn_slam = KeyframeSLAM(builder, cfg_sync)
    with planes_finite() as more:
        syn = run_keyframe(syn_slam, raws, gt)
    gate(check_planes_finite, finite + more, "keyframe SLAM (both event modes)")
    gate(check_closure_edges, syn, sub("lc_verify"), "keyframe SLAM (synchronous events)")
    gate(check_async_vs_sync, asy, syn, len(asy_slam._pending))
    _PHASE_I.update(syn=syn, raws=raws)  # phase n's reference run

    # a second run after reset(): identical; and the times of a warm run
    syn_slam.reset()
    phases = _phase_times(syn_slam)
    syn2 = run_keyframe(syn_slam, raws, gt)
    gate(check_identical, syn, syn2, "synchronous run, again after reset()")
    asy_slam.reset()
    asy2 = run_keyframe(asy_slam, raws, gt)
    same = all(np.array_equal(asy[k], asy2[k], equal_nan=True) for k in asy if k != "process_ms")
    gate(check_keyframe_decisions, asy2, asy, "deferred run, again after reset()")
    print(f"deferred run, again after reset(): {'identical' if same else 'the same decisions; '}"
          f"{'' if same else 'poses differ (phase readiness is a race with the card)'}")

    kf = asy2["keyframe"]
    kf[0] = False  # the first frame only seeds the map
    tracked = ~kf
    tracked[0] = False
    for name, run in (("deferred", asy2), ("synchronous", syn2)):
        ms = run["process_ms"]
        print(f"keyframe SLAM ({name} events): process median {statistics.median(ms[tracked]):.3f} "
              f"ms per tracked frame, {statistics.median(ms[kf]):.3f} ms per keyframe frame "
              f"(all {np.round(ms, 1).tolist()}), on {smi}")
    four = [v for v in phases if len(v) == 4]
    print(f"keyframe events (synchronous, {len(phases)} events): ms per phase of each event "
          f"{[np.round(v, 1).tolist() for v in phases]}; ms per phase A-D, medians over the "
          f"{len(four)} four-phase events "
          f"{[round(statistics.median(c), 3) for c in zip(*four)] if four else []}; dispatch "
          f"sites per event {syn_slam.kf_event_dispatches}, on {smi}")
    print(f"keyframe SLAM stages (synchronous run):\n{syn_slam.timer.report()}")

    # host syncs per frame (sync debug mode, a lower bound)
    syn_slam.reset()
    syncs = np.array([_count_syncs(lambda r=r: syn_slam.process(r)) for r in raws])
    print(f"keyframe SLAM: host syncs per frame (sync debug mode, a lower bound) "
          f"{syncs.tolist()}: median {int(np.median(syncs[tracked]))} per tracked frame, "
          f"{int(np.median(syncs[kf]))} per keyframe frame (its event included)")

    # kidnap
    kraws = [RawRigFrame(rgb=rgb, depth_mm=d) for rgb, d in synthetic.kidnap_captures(
        [(r.rgb, r.depth_mm) for r in raws])]
    kid = run_kidnap(KeyframeSLAM(builder), kraws, synthetic.kidnap_poses(gt))
    gate(check_kidnap, kid, sub("kidnap"))

    # checkpoint / resume against the uninterrupted synchronous run
    cut = LOOP_FRAMES // 2
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        res = run_checkpoint(builder, cfg_sync, raws, cut, Path(tmp) / "slam_state.npz")
        rcounts = _counts()
    gate(check_checkpoint, res, syn, cut)
    pyramids = LOOP_FRAMES + len(res["rebuilds"])
    print(f"checkpoint: kernel launches {rcounts} over {LOOP_FRAMES} frames and "
          f"{len(res['rebuilds'])} rebuilt pyramids")
    if _pyramid_counts(rcounts) != {"fused_gradients": pyramids, "fused_pyr_down": 4 * pyramids}:
        failed.append(f"{pyramids} pyramids are not {rcounts}")

    # the solvers alone, and the scans at capacity 64
    gate(check_solvers, solve_rings(builder.sensor.device), golden, f"on {smi}")
    states = [syn_slam.make_state(r) for r in raws]
    m = filled_map(cfg, states, gt, SCAN_KEYFRAMES, builder.sensor.device)
    gate(check_scan, scan_filled_map(cfg, m, states, query=5), 5, f"on {smi}")
    del m, states

    # both event modes against the golden and the loop's branches (after
    # every timing: the branch set runs in GN graphs of its own)
    t0 = time.perf_counter()
    branches = loop_branches(builder, cfg_sync, raws, gt)
    print(f"keyframe SLAM: the loop's branch set ({len(branches)} runs) took "
          f"{time.perf_counter() - t0:.1f} s")
    gate(check_loop_branches, branches, sub("loop_sync"), "keyframe SLAM (synchronous events)")
    gate(check_keyframe_run, asy, sub("loop_async"), "keyframe SLAM (deferred events)",
         branches=branches)
    gate(check_keyframe_run, syn, sub("loop_sync"), "keyframe SLAM (synchronous events)",
         branches=branches)
    print(f"keyframe SLAM: peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, on {smi}")

    def profiled() -> None:
        # a keyframe frame whose event optimizes (the last, if none does)
        frames, opt = np.flatnonzero(syn2["keyframe"]), syn2["optimized"]
        f = int(frames[np.argmax(opt)] if opt.any() else frames[-1])
        slam = KeyframeSLAM(builder, cfg_sync)
        for raw in raws[:f]:
            slam.process(raw)
        for what, raw in (("keyframe frame", raws[f]), ("next frame", raws[f + 1])):
            wall, busy, ops, waits, d2h = _profile(lambda: slam.process(raw))
            ev = slam.events[-1]
            print(f"keyframe SLAM, one profiled {what} (frame {len(slam.events) - 1}, keyframe "
                  f"{ev['keyframe']}, synchronous event: {ev.get('connections', 0)} connections, "
                  f"{ev.get('loop_closures', 0)} closures, optimized {ev.get('optimized', False)}): "
                  f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.3f}, device ops {ops}, host waits {waits}, "
                  f"device-to-host copies {d2h}, on {smi}")

    _DEFERRED.append(profiled)
    if failed:
        raise AssertionError(f"phase i: {len(failed)} gates failed: " + " | ".join(failed))


# ------------------------------------------------------- F2: finite planes


@contextlib.contextmanager
def planes_finite():
    """Count, on the device, the non-finite entries of every field of every
    plane set `FrameBuilder.build_full` returns while the context is open,
    padded slots included (no host sync per frame); yields a list of one
    count per built frame, read by `check_planes_finite`."""
    build_full, counts = FrameBuilder.build_full, []

    def counted(self, *args, **kw):
        out = build_full(self, *args, **kw)
        counts.append(_non_finite_fields(out[2]))
        return out

    FrameBuilder.build_full = counted
    try:
        yield counts
    finally:
        FrameBuilder.build_full = build_full


def _float_fields(planes) -> list:
    return [f.name for f in dataclasses.fields(planes) if getattr(planes, f.name).is_floating_point()]


def _non_finite_fields(planes) -> torch.Tensor:
    """Per float field of a plane set, its non-finite entries in valid and
    in padded slots: (2, fields) on the device."""
    valid = planes.valid
    rows = []
    for name in _float_fields(planes):
        bad = ~torch.isfinite(getattr(planes, name))
        bad = bad.reshape(valid.shape + (-1,)).sum(-1)
        rows.append(torch.stack([(bad * valid).sum(), (bad * ~valid).sum()]))
    return torch.stack(rows, dim=1)


def _non_finite(planes) -> torch.Tensor:
    """The non-finite entries of a plane set's fields, all slots."""
    return _non_finite_fields(planes).sum()


def check_planes_finite(counts: list, what: str) -> None:
    """Every slot of every plane set built is finite; a failure names the
    frames, the fields and whether the slots were valid or padding."""
    per = torch.stack(counts).cpu().numpy() if counts else np.zeros((0, 2, 0))
    bad = per.sum(axis=(1, 2))
    print(f"{what}: {len(bad)} plane sets built, non-finite entries (padded slots included) "
          f"{int(bad.sum())}")
    if not len(bad) or bad.any():
        from rgbd360_tpu_torch.ops.segmentation import PlaneSet

        names = [f.name for f in dataclasses.fields(PlaneSet) if f.name != "valid"]
        where = {f"frame {int(i)}": {n: per[i, :, k].tolist() for k, n in enumerate(names)
                                     if per[i, :, k].any()} for i in np.flatnonzero(bad)}
        raise AssertionError(f"{what}: plane sets with non-finite entries ([valid, padded] "
                             f"counts per field): {where} (of {len(bad)} frames)")


def probe_degenerate_eigh() -> None:
    """Where a padded plane slot's non-finite value came from: the card's
    `torch.linalg.eigh` on the degenerate 3x3 scatter matrices of a
    segment's padding (all zero; a 1-point and a 2-point segment), batched
    as the segmentation batches them, raw and through the guard
    `segmentation._slot_eigh`."""
    cov = torch.zeros((8, 16, 3, 3), device="cuda")
    p = torch.tensor([1.3, -0.4, 2.2], device="cuda")
    q = torch.tensor([1.1, -0.2, 2.9], device="cuda")
    cov[:, 1] = torch.outer(p, p) - torch.outer(p, p)
    c2 = (p + q) / 2
    cov[:, 2] = (torch.outer(p, p) + torch.outer(q, q)) / 2 - torch.outer(c2, c2)
    count = torch.zeros((8, 16), device="cuda")
    count[:, 1:3] = torch.tensor([1.0, 2.0], device="cuda")
    val, vec = torch.linalg.eigh(cov)
    raw = [int((~torch.isfinite(x[:, i])).sum()) for x in (val, vec) for i in range(3)]
    g_val, g_vec = seg_ops._slot_eigh(cov, count)
    guarded = int((~torch.isfinite(g_val)).sum() + (~torch.isfinite(g_vec)).sum())
    print(f"F2 probe: torch.linalg.eigh on the card, 8x16 degenerate 3x3 matrices (zero, 1-point, "
          f"2-point): non-finite entries in (eigenvalues, eigenvectors) per kind {raw[:3]}, "
          f"{raw[3:]}; through _slot_eigh {guarded}")
    if guarded:
        raise AssertionError("F2: _slot_eigh returned non-finite values")


# ------------------------------------------------------------- phase j
#
# The apps on capture files at full size.  Their runs are held to the JAX
# golden `data/apps_golden.npz` (`tools/torch_port_golden.py --apps-only`:
# the reference's own `main` over the same files) with the gates of the
# phases that run the same trackers: odometry's per-frame step to
# GOLDEN_TOL (phase g), the keyframe trackers' decisions exactly, their
# trajectories to KF_TOL and their tracked solves to TRACK_TOL (phase i).
# The apps' events are deferred and the golden's synchronous (a deferred
# reference run is a race on the CPU; on the card a phase is nearly always
# ready when polled, see PERF.md).  The PbMap app's tracker is gated (decisions,
# registrations to PB_EDGE_TOL, poses to KF_TOL) and its events' decisions
# printed; its planar BA: the same associations, chi2 to KF_CHI2_RTOL and
# poses to KF_TOL along the directions its landmarks observe.
APPS_GOLDEN = DATA / "apps_golden.npz"
# The PbMap tracker's edges are plane registrations (closed-form solves of
# a few matched planes): the packages' agree to ~1e-5 m (measured on the
# CPU at the tests' size).  Its poses are not held tighter than that: a
# wall-only registration leaves the vertical translation unobserved (zero
# information), so the keyframes' heights come only from the loop
# closures, whose salient verifications have several solutions (see
# LC_EDGE_TOL): at the tests' size one closure's pose differs by 0.75 m
# between the packages and the trajectory by 5.9 cm, vertically.  At full
# size on the card the closures agree and so do the poses (1.7e-4 m in
# phase k, 5.1e-4 m in phase j): they are held to KF_TOL there.
PB_EDGE_TOL = (1e-3, 1e-3)
APP_OUT_FILES = ("map.ply", "map.pcd", "kf_000.ply", "selected_kfs.ply", "topology.ply",
                 "trajectory.ply", "trajectory_opt.ply", "trajectory.txt", "map.npz")


def pbmap_record(slam, gt=None) -> dict:
    """What a finished `PbMapGraphSLAM` run is compared on (call after
    `flush()`): per-frame flags and reference keyframes, the edge list
    sorted, the areas, the trajectory, the final graph's chi2 (the keys of
    the golden tool's `pbmap_record`)."""
    ev = slam.events
    n_kf, n_e = int(slam.map.n_kf), int(slam.map.n_edges)
    edges = np.concatenate(
        [slam.map.graph.edges_ij[:n_e].cpu().numpy(),
         slam.map.edge_is_lc[:n_e, None].cpu().numpy().astype(np.int32)], axis=1)
    order = np.lexsort(edges.T[::-1])
    out = {
        "keyframe": np.array([e["keyframe"] for e in ev]),
        "ref_kf": np.array([e.get("ref_kf", -1) for e in ev], np.int64),
        "no_assoc": np.int64(slam.no_assoc),
        "edges": edges[order],
        "edge_rel": slam.map.graph.rel[:n_e].cpu().numpy()[order],
        "n_loop_closures": np.int64(slam.n_loop_closures),
        "area": slam.map.area[:n_kf].cpu().numpy(),
        "n_areas": np.int64(int(slam.map.n_areas)),
        "trajectory": np.stack(slam.trajectory).astype(np.float32),
        "opt_poses": slam.map.opt_poses[:n_kf].cpu().numpy(),
        "chi2": np.float32(graph_ops.graph_chi2(slam.map.graph).item()),
        "loop_closures": np.array([e.get("loop_closures", 0) for e in ev if e["keyframe"]]),
    }
    if gt is not None:
        out["gt"] = np.asarray(gt, np.float32)
    return out


def check_pbmap_run(got: dict, golden: dict, what: str, tol_m: float = KF_TOL_M,
                    tol_rad: float = KF_TOL_RAD, events: bool = True, poses: bool = True) -> dict:
    """A PbMap run against the golden's: the per-frame decisions (keyframe,
    reference keyframe, frames without association); with `events` the
    edges, the closures and the partition up to relabelling (what the
    keyframe events decide); the PbMap registrations' edges and their
    poses (to PB_EDGE_TOL); with `poses` the trajectory and the keyframes'
    poses to (`tol_m`, `tol_rad`)."""
    print(f"{what}: reference keyframes {got['ref_kf'].tolist()}, no association "
          f"{int(got['no_assoc'])}; {len(got['edges'])} edges, {int(got['n_loop_closures'])} loop "
          f"closures (golden {len(golden['edges'])}, {int(golden['n_loop_closures'])}); areas "
          f"{got['area'].tolist()} (golden {golden['area'].tolist()})")
    for k in ("keyframe", "ref_kf") + (("edges",) if events else ()):
        if not np.array_equal(got[k], golden[k]):
            raise AssertionError(f"{what}: `{k}` {got[k].tolist()}, golden {golden[k].tolist()}")
    for k in ("no_assoc",) + (("n_loop_closures", "n_areas") if events else ()):
        if int(got[k]) != int(golden[k]):
            raise AssertionError(f"{what}: {k} {int(got[k])}, golden {int(golden[k])}")
    if events and not same_partition(got["area"], golden["area"]):
        raise AssertionError(f"{what}: areas {got['area'].tolist()}, golden {golden['area'].tolist()}")
    # the tracker's own measurements: the PbMap registrations' poses
    gaps = {}
    sel, sel_g = got["edges"][:, 2] == 0, golden["edges"][:, 2] == 0
    if not np.array_equal(got["edges"][sel], golden["edges"][sel_g]):
        raise AssertionError(f"{what}: PbMap edges {got['edges'][sel].tolist()}, golden "
                             f"{golden['edges'][sel_g].tolist()}")
    if sel.any():
        gaps["pbmap_edges"] = _pose_gaps(got["edge_rel"][sel], golden["edge_rel"][sel_g])
        print(f"{what}: {int(sel.sum())} PbMap (odometry) edges' poses vs JAX golden: "
              f"{gaps['pbmap_edges'][0]:.3e} m, {gaps['pbmap_edges'][1]:.3e} rad (tol {PB_EDGE_TOL})")
        if gaps["pbmap_edges"][0] > PB_EDGE_TOL[0] or gaps["pbmap_edges"][1] > PB_EDGE_TOL[1]:
            raise AssertionError(f"{what}: the PbMap registrations' poses leave the tolerance")
    for k in ("trajectory", "opt_poses"):
        dt, dr = gaps[k] = _pose_gaps(got[k], golden[k])
        print(f"{what} {k} vs JAX golden: {dt:.3e} m, {dr:.3e} rad"
              + (f" (tol {tol_m}, {tol_rad})" if poses else " (not gated)"))
    if poses and any(gaps[k][0] > tol_m or gaps[k][1] > tol_rad for k in ("trajectory", "opt_poses")):
        raise AssertionError(f"{what}: poses leave the tolerance")
    return gaps


@contextlib.contextmanager
def timed_process(*classes):
    """Wrap the trackers' `process` to record each call's wall ms (host
    clock, synchronized); yields a list the calls' times are appended to
    (the caller takes them out after each run)."""
    saved, times = [(c, c.process) for c in classes], []

    def wrap(cls, process):
        def timed(self, raw):
            t0 = time.perf_counter()
            out = process(self, raw)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    for cls, process in saved:
        cls.process = wrap(cls, process)
    try:
        yield times
    finally:
        for cls, process in saved:
            cls.process = process


@contextlib.contextmanager
def recorded_plane_ba():
    """Record the result of `apps.kf_slam.plane_ba` (the app returns only
    the tracker); yields a dict filled when the app runs it."""
    from rgbd360_tpu_torch.apps import kf_slam

    solve, out = kf_slam.plane_ba, {}

    def record(slam):
        res = solve(slam)
        prob = convert.plane_ba_problem_to_numpy(res["problem"])
        out.update(poses=res["poses"].cpu().numpy(), chi2=res["chi2"], iters=res["iters"],
                   obs_kf=prob[2], obs_pl=prob[3], normals=prob[1][:, :3])
        return res

    kf_slam.plane_ba = record
    try:
        yield out
    finally:
        kf_slam.plane_ba = solve


def observed_gaps(got: np.ndarray, ref: np.ndarray, normals: np.ndarray) -> tuple:
    """(m, rad) gaps of two pose sets as planar BA sees them: translations
    only along the span of the landmarks' normals (`normals` (M, 3), world
    frame, zero rows ignored); a direction no landmark faces (the vertical,
    when only walls are associated) carries no information and keeps its
    starting value."""
    n = np.asarray(normals, np.float64)
    n = n[np.linalg.norm(n, axis=1) > 0.5]
    _, sv, vt = np.linalg.svd(n, full_matrices=False)
    basis = vt[sv > 0.1 * sv.max()]  # the observed directions
    d = np.asarray(got, np.float64)[:, :3, 3] - np.asarray(ref, np.float64)[:, :3, 3]
    dt = float(np.linalg.norm(d @ basis.T, axis=1).max())
    return dt, _pose_gaps(got, ref)[1], len(basis)


def check_plane_ba(got: dict, golden: dict, what: str, tol: tuple = (KF_TOL_M, KF_TOL_RAD)) -> None:
    """The planar BA of the PbMap run: the same associations, chi2 within
    KF_CHI2_RTOL, poses within `tol` along what the BA observes
    (`observed_gaps`: its starting poses' unobserved heights come from
    the loop closures, see PB_EDGE_TOL)."""
    rel = abs(got["chi2"] - float(golden["ba_chi2"])) / max(float(golden["ba_chi2"]), 1e-12)
    dt, dr, n_dirs = observed_gaps(got["poses"], golden["ba_poses"], got["normals"])
    full = _pose_gaps(got["poses"], golden["ba_poses"])[0]
    print(f"{what}: planar BA over {len(got['obs_kf'])} observations, chi2 {got['chi2']:.6f} "
          f"(golden {float(golden['ba_chi2']):.6f}, relative gap {rel:.3e}, tol {KF_CHI2_RTOL}) "
          f"in {got['iters']} LM iterations (golden {int(golden['ba_iters'])}); poses {dt:.3e} m "
          f"along the {n_dirs} observed directions ({full:.3e} m in all), {dr:.3e} rad from the "
          f"golden's (tol {tol[0]}, {tol[1]})")
    if not (np.array_equal(got["obs_kf"], golden["ba_obs_kf"])
            and np.array_equal(got["obs_pl"], golden["ba_obs_pl"])):
        raise AssertionError(f"{what}: the planar BA's associations differ from the golden's")
    if rel > KF_CHI2_RTOL or dt > tol[0] or dr > tol[1]:
        raise AssertionError(f"{what}: the planar BA leaves the tolerance")


def check_app_files(out: Path, names, what: str) -> None:
    missing = [n for n in names if not (out / n).is_file() or (out / n).stat().st_size == 0]
    print(f"{what}: --out wrote {sorted(p.name for p in out.iterdir())}")
    if missing:
        raise AssertionError(f"{what}: --out files missing or empty: {missing}")


def check_app_launches(counts: dict, frames: int, what: str, solves: bool = True) -> None:
    """One pyramid per built frame: 1 K1 + 4 K2 launches; with `solves`,
    the run's dense solves launched the normal equations."""
    _require_launches(counts, what, solves)
    if _pyramid_counts(counts) != {"fused_gradients": frames, "fused_pyr_down": 4 * frames}:
        raise AssertionError(f"{what}: {frames} built frames are not {frames} K1 + {4 * frames} "
                             f"K2 launches: {counts}")


def check_apps_phase(smi: str) -> None:
    """Phase j: the apps (`odometry`, `kf_slam`, `kf_slam --pbmap
    --plane-ba`, `grabber synth`) on capture files, at full size."""
    import tempfile

    from rgbd360_tpu_torch.apps import grabber, kf_slam, odometry
    from rgbd360_tpu_torch.io.dataset import SequenceDataset
    from rgbd360_tpu_torch.slam.pbmap_slam import PbMapGraphSLAM

    failed: list = []
    gate = _gate_collector(failed)
    golden = dict(np.load(APPS_GOLDEN))
    sub = lambda p: {k[len(p) + 1:]: v for k, v in golden.items() if k.startswith(p + "_")}  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        paths = synthetic.write_app_inputs(tmp)
        n_loop, n_walk = LOOP_FRAMES, synthetic.APPS_WALK_FRAMES
        calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
        gt = np.loadtxt(paths["gt"]).reshape(-1, 4, 4)
        print(f"apps set-up (calibration directory, {n_loop} loop and {n_walk} walk capture "
              f"files): {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        walls = {}
        with planes_finite() as finite, timed_process(
                FrameToFrameOdometry, KeyframeSLAM, PbMapGraphSLAM) as ms:
            for name, argv, frames in (
                ("odometry", [str(paths["walk"]), *calib, "--out", str(tmp / "odo")], n_walk),
                ("odometry --keyframe", [str(paths["walk"]), *calib, "--keyframe"], n_walk),
            ):
                _reset_counts()
                t0 = time.perf_counter()
                traj = odometry.main(argv)
                walls[name] = (time.perf_counter() - t0, frames, ms[:])
                ms.clear()
                gate(check_app_launches, _counts(), frames, f"apps: {name}")
                ref = golden["odometry_kf_trajectory" if "keyframe" in name else "odometry_trajectory"]
                if "keyframe" in name:
                    gate(_gate_gaps, f"apps: {name} trajectory", traj, ref, KF_TOL_M, KF_TOL_RAD)
                else:
                    steps = lambda t: np.linalg.inv(t[:-1]) @ t[1:]  # noqa: E731
                    gate(_gate_gaps, f"apps: {name} per-frame steps", steps(traj), steps(ref),
                         GOLDEN_TOL_M, GOLDEN_TOL_RAD)
            gate(check_app_files, tmp / "odo", ("trajectory.txt", "trajectory.ply"), "apps: odometry")

            _reset_counts()
            t0 = time.perf_counter()
            slam = kf_slam.main([str(paths["loop"]), *calib, "--gt", str(paths["gt"]),
                                 "--out", str(tmp / "kf")])
            walls["kf_slam"] = (time.perf_counter() - t0, n_loop, ms[:])
            ms.clear()
            gate(check_app_launches, _counts(), n_loop, "apps: kf_slam")
            # the app's events are deferred, the golden's synchronous: its
            # optimized trajectory carries the gate (see check_keyframe_run)
            gate(check_keyframe_run, keyframe_record(slam, gt), sub("kf_slam"), "apps: kf_slam",
                 raw_trajectory=False)
            gate(check_app_files, tmp / "kf", APP_OUT_FILES, "apps: kf_slam")
            del slam

            _reset_counts()
            t0 = time.perf_counter()
            with recorded_plane_ba() as ba:
                slam = kf_slam.main([str(paths["loop"]), *calib, "--gt", str(paths["gt"]),
                                     "--pbmap", "--plane-ba"])
            walls["kf_slam --pbmap --plane-ba"] = (time.perf_counter() - t0, n_loop, ms[:])
            ms.clear()
            gate(check_app_launches, _counts(), n_loop, "apps: kf_slam --pbmap")
            # the app's events are deferred; the golden's are synchronous (a
            # deferred reference run is a race): the events' decisions are
            # printed, the tracker's gated
            gate(check_pbmap_run, pbmap_record(slam, gt), sub("pbmap"), "apps: kf_slam --pbmap",
                 events=False)
            gate(check_plane_ba, ba, sub("pbmap"), "apps: kf_slam --pbmap --plane-ba")
            map_bad = int(_non_finite(slam.map.planes))
            print(f"apps: kf_slam --pbmap: the map's plane sets hold {map_bad} non-finite entries")
            if map_bad:
                failed.append("the PbMap map's plane sets hold non-finite entries")
            del slam
        gate(check_planes_finite, finite, "apps (phase j)")
        peak = torch.cuda.max_memory_allocated() / 2**20
        for name, (wall, frames, times) in walls.items():
            print(f"apps: {name}: process median {statistics.median(times[1:]):.3f} ms per frame "
                  f"after the first (all {np.round(times, 1).tolist()}); main {wall:.2f} s for "
                  f"{frames} frames, {1e3 * wall / frames:.1f} ms per frame with its set-up and "
                  f"export, on {smi}")
        print(f"apps: peak device memory of the phase {peak:.1f} MiB, on {smi}")

        # the kf_slam app's tracked solves (after the timed runs)
        app_cfg = synthetic.config()
        ref_builder = FrameBuilder(load_calibration(paths["calib"] / "Extrinsics", None), app_cfg)
        load_reference_maps(ref_builder)
        gate(check_tracked_solves, ref_builder, loop_raws(n_loop), sub("kf_slam_track_verify"),
             "apps: kf_slam")
        del ref_builder

        syn = tmp / "synth"
        grabber.main(["synth", str(syn), "--frames", "2", "--trajectory", "loop",
                      "--room", "octagon"])
        ds = SequenceDataset(syn)
        poses = grabber.synth_trajectory_poses("loop", 2)
        same = [np.array_equal(r.rgb, c.rgb) and np.array_equal(r.depth_mm, c.depth_mm)
                and r.timestamp == c.timestamp
                for r, c in zip(ds, (grabber.synth_capture(i, 0, pose=poses[i], room="octagon")
                                     for i in range(2)))]
        print(f"apps: grabber synth wrote {ds.indices} and gt_poses.txt; read back equal {same}")
        if ds.indices != [1, 2] or not all(same) or not (syn / "gt_poses.txt").is_file():
            failed.append("grabber synth: the captures do not read back")
    if failed:
        raise AssertionError(f"phase j: {len(failed)} gates failed: " + " | ".join(failed))


# ------------------------------------------------------------- phase k
#
# The long map: the loop at `synthetic.long_config` (capacity 4 keyframes
# and 8 edges, LM-PCG from 4 keyframes, a partition every 2 keyframes), so
# a run grows the map twice, solves on a live map with LM-PCG and
# partitions it into areas.  Synchronous events against the golden's
# synchronous run (the gates of phase i); then deferred events with each
# due partition held at its SSO snapshot until a later keyframe is
# promoted: the case where the map grows under a deferred partition.


def hold_partitions(slam) -> list:
    """Make a keyframe event whose partition is due wait at its SSO
    snapshot (the one 2-D square tensor it awaits) until a later keyframe
    has been promoted, and record each partition as (snapshot, live
    keyframes then, the live keyframes' areas before, the areas written):
    the list is returned."""
    held, log = {}, []  # held: generator -> live keyframes when first asked (kept
    # alive as the key, so that no later generator can reuse its id)
    base, apply = slam._phase_ready, slam._apply_partition

    def ready(marker):
        gen, struct = slam._pending[0][:2]
        if not any(torch.is_tensor(x) and x.ndim == 2 and x.shape[0] == x.shape[1]
                   for x in struct):
            return base(marker)
        return slam._n_kf_host > held.setdefault(gen, slam._n_kf_host)

    def recorded(sso_f):
        before = slam.map.area[: slam._n_kf_host].cpu().numpy()
        areas = apply(sso_f)
        log.append((np.asarray(sso_f), slam._n_kf_host, before, np.asarray(areas)))
        return areas

    slam._phase_ready = ready
    slam._apply_partition = recorded
    return log


def check_held_partitions(log: list, cfg, what: str) -> None:
    """Each partition of a held run: the keyframes its snapshot covers are
    labelled as the spectral partition of that snapshot labels them, every
    later keyframe keeps its area, and at least one partition ran on a map
    that had grown under it."""
    grown = 0
    for sso, n_kf, before, areas in log:
        n_cov = min(n_kf, len(sso))
        grown += n_cov < n_kf
        m = sso[:n_cov, :n_cov].astype(np.float64)
        want = recursive_spectral_partition(np.maximum(m, m.T), cfg.map.sso_partition_threshold)
        if not np.array_equal(areas[:n_cov], want):
            raise AssertionError(f"{what}: a partition's covered areas {areas[:n_cov].tolist()} "
                                 f"are not its snapshot's {want.tolist()}")
        if not np.array_equal(areas[n_cov:], before[n_cov:]):
            raise AssertionError(f"{what}: keyframes beyond the snapshot changed area: "
                                 f"{before[n_cov:].tolist()} -> {areas[n_cov:].tolist()}")
    print(f"{what}: {len(log)} partitions, {grown} of them on a map that grew under them")
    if not grown:
        raise AssertionError(f"{what}: no partition met a grown map")


def check_long_phase(smi: str) -> None:
    """Phase k: KeyframeSLAM and PbMapGraphSLAM over the loop with small
    capacities (map growth, LM-PCG on a live map, several partitions)."""
    from rgbd360_tpu_torch.slam.pbmap_slam import PbMapGraphSLAM

    failed: list = []
    gate = _gate_collector(failed)
    golden = dict(np.load(APPS_GOLDEN))
    sub = lambda p: {k[len(p) + 1:]: v for k, v in golden.items() if k.startswith(p + "_")}  # noqa: E731
    cfg = synthetic.long_config(synthetic.config())
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    raws = loop_raws(LOOP_FRAMES)
    gt = synthetic.loop_poses(LOOP_FRAMES)
    torch.cuda.reset_peak_memory_stats()
    for name, cls, record in (("kf", KeyframeSLAM, keyframe_record),
                              ("pb", PbMapGraphSLAM, pbmap_record)):
        what = f"long map ({cls.__name__})"
        for tag in ("sync", "async"):
            if f"long_{name}_{tag}_raised" in golden:
                print(f"{what}, JAX golden with {tag} events: raised "
                      f"{golden[f'long_{name}_{tag}_raised']}")
        slam = cls(builder, keyframe_config(cfg, False))
        _reset_counts()
        with planes_finite() as finite:
            t0 = time.perf_counter()
            for raw in raws:
                slam.process(raw)
            slam.flush()
            wall = time.perf_counter() - t0
        gate(check_app_launches, _counts(), LOOP_FRAMES, f"{what}, synchronous events")
        gate(check_planes_finite, finite, f"{what}, synchronous events")
        print(f"{what}, synchronous events: {1e3 * wall / LOOP_FRAMES:.1f} ms per frame; map "
              f"capacity {slam.map.kf_capacity} keyframes / {slam.map.edge_capacity} edges, "
              f"{int(slam.map.n_kf)} keyframes, {int(slam.map.n_areas)} areas, on {smi}")
        if slam.map.kf_capacity <= cfg.map.max_keyframes:
            failed.append(f"{what}: the map never grew")
        if name == "kf":
            branches = loop_branches(builder, keyframe_config(cfg, False), raws, gt)
            gate(check_loop_branches, branches, sub("long_kf_sync"), f"{what}, synchronous events")
            gate(check_keyframe_run, keyframe_record(slam, gt), sub("long_kf_sync"),
                 f"{what}, synchronous events", branches=branches)
        else:
            gate(check_pbmap_run, pbmap_record(slam, gt), sub("long_pb_sync"),
                 f"{what}, synchronous events")
        held = cls(builder, keyframe_config(cfg, True))
        log = hold_partitions(held)
        for raw in raws:
            held.process(raw)
        held.flush()
        pending = len(held._pending)
        print(f"{what}, deferred events with held partitions: completed, {pending} events "
              f"pending after flush(); {int(held.map.n_kf)} keyframes, areas "
              f"{held.map.area[: int(held.map.n_kf)].tolist()}")
        if pending:
            failed.append(f"{what}: events pending after flush()")
        gate(check_held_partitions, log, cfg, f"{what}, held partitions")
        del slam, held
    print(f"long map: peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, on {smi}")
    if failed:
        raise AssertionError(f"phase k: {len(failed)} gates failed: " + " | ".join(failed))


# ------------------------------------------------------------- phase l
#
# The pair-registration apps on capture files at full size
# (`register_pair`, `benchmark_registration`, `register_sequence`), held to
# `data/registration_golden.npz` (`tools/torch_port_golden.py
# --registration-only`: the reference's own `main` over the same files).
# PbMap: success and matches equal; its pose is printed beside the
# golden's, not gated: in the eightfold-symmetric room the walk's wall
# matches have several aliases (rotations and mirror images of the
# octagon) between which the greedy matcher's votes decide (printed), and
# the packages may take different ones.  So the apps that seed from PbMap
# run with the golden's PbMap results in place of their own
# (`recorded_registration(seeds)`), and what those seed is held on every
# run: GICP poses to ICP_TOL; the apps' own dense solves (bilinear and
# rig_joint included) within APP_DENSE_TOL of the NEAREST of the golden's
# solves of them from micrometre-jittered seeds (`_gate_branches`, phase
# i's rule: a solve that leaves a level through the accept-if-improved
# exit has several solutions within reach of rounding);
# `register_sequence`'s edges equal, its graph's leaves
# (`check_seq_graph`), chi2 within KF_CHI2_RTOL (the information matrices
# are the edges' Hessians, as in phase i), trajectory within SEQ_TRAJ_TOL
# of the golden's graph solved with the branches its edges matched and
# the app's information matrices (`branch_matched_trajectory`), its area
# labels the same partition; the port's solver on the golden's own
# graph (`check_graph_solver`).  The apps run through their `main`, on
# the port's own stitch maps; the golden's dense solves are solved again from
# its seeds on the reference's maps and held to the golden tolerance
# (`resolve_registration`).
REGISTRATION_GOLDEN = DATA / "registration_golden.npz"
REG_PAIR = (0, 5)  # the walk's captures 0.5 m apart (register_pair)
REG_BENCH_PAIR = (0, 2)  # benchmark_registration's pair
REG_EXTRA_PAIR = (0, 1)  # the occlusion modes and the pinhole solve
REG_WINDOW = 2
# ICP and GICP: a fixed iteration count with no accept test, so only the
# sums' order and the warp's rounding separate the packages (measured on
# the CPU at the tests' size: 5.5e-6 m); the bound is the golden's.
ICP_TOL_M, ICP_TOL_RAD = GOLDEN_TOL_M, GOLDEN_TOL_RAD
# The apps' own dense solves stitch with the port's maps, which differ
# from the reference's on the sensor-tie columns (phase i's LC_EDGE_TOL,
# for the same cause).  Measured on an H100 from the nearest branch:
# register_pair 1.53e-3 m, 1.19e-4 rad from the golden's PbMap pose
# (1.37e-3 m, 8.1e-5 rad from its own, 7e-13 m away: the seed picks the
# branch), the benchmark 5.3e-4 m, 1.1e-4 rad, register_sequence's edges
# 7.8e-4 m, 1.0e-4 rad; the golden's solves re-solved on the reference's
# maps lie within 1.9e-4 m of theirs.
APP_DENSE_TOL = LC_EDGE_TOL
# A sequence edge's information matrix (its solve's Hessian) against the
# golden's: the largest relative Frobenius gap over the edges.  The
# Hessian is taken at the solve's pose on the port's stitch maps (see
# APP_DENSE_TOL); measured 1.2e-2 on an H100 (2.5e-4 on the CPU at the
# tests' size).
SEQ_INFO_RTOL = 0.05
# `register_sequence`'s trajectory against `branch_matched_trajectory`
# with the app's information matrices: what is left are the edges' gaps to
# their branches (under APP_DENSE_TOL), which this inconsistent graph
# amplifies; measured on an H100 1.37e-3 m, 9.0e-5 rad (edges within
# 7.8e-4 m of their branches), 6.2e-5 m on the CPU at the tests' size.
SEQ_TRAJ_TOL = (5e-3, 1e-3)
BENCH_DENSE = ("dense_photo", "dense_depth", "dense_both", "dense_bilerp", "rig_joint")
BENCH_ICP = ("icp_point", "icp_plane", "gicp")
PAIR_OUT_FILES = ("poses.json", "sphere1.png", "sphere2.png", "aligned_pair.ply")
SEQ_OUT_FILES = ("trajectory.txt", "areas.txt")
GRAPH_LEAVES = ("poses", "vmask", "edges_ij", "rel", "info", "emask")


def greedy_votes(ref, trg, cfg, mode) -> list:
    """The two largest votes of each step of `match_planes`'s greedy loop
    (its operations, for one pair of plane sets) while it still picks a
    pair: at the step that decides between two aliases of the room, the
    two are close."""
    from rgbd360_tpu_torch.registration import planes as P

    cand = P.unary_compatibility(ref, trg, cfg, mode)
    cons = P.binary_consistency(ref, trg, cand, cfg)
    k1, k2 = cand.shape
    w = torch.sqrt(torch.clamp(ref.area[:, None], min=1e-3)
                   * torch.clamp(trg.area[None, :], min=1e-3))
    cons_flat = cons.reshape(k1 * k2, k1 * k2)
    rows = torch.arange(k1, device=cand.device)[:, None]
    cols = torch.arange(k2, device=cand.device)[None, :]
    steps = []
    for _ in range(cfg.max_matches):
        live_w = torch.where(cand, w, 0.0).flatten()
        votes = P._mv(cons_flat.to(torch.float32), live_w).reshape(cand.shape)
        votes = torch.where(cand, votes * w, -1.0).flatten()
        top = torch.topk(votes, min(2, votes.numel())).values.cpu().tolist()
        if top[0] <= 0:
            break
        steps.append(top)
        best = int(torch.argmax(votes))
        cand = (cand & cons_flat[best].reshape(cand.shape) & (rows != best // k2)
                & (cols != best % k2))
    return steps


def golden_seeds(golden: dict, poses: str, success: str) -> tuple:
    """The golden's PbMap results as `recorded_registration`'s seeds."""
    return np.reshape(golden[poses], (-1, 4, 4)), np.atleast_1d(golden[success])


@contextlib.contextmanager
def recorded_registration(seeds: tuple | None = None):
    """Record the results of the port's dense solves
    (`DenseAligner.align`, `RigDenseAligner.align`: pose, ill-posed flag;
    a call repeated on the same inputs, the benchmark's repeats, once, as
    the golden tool records the reference's) and PbMap registrations
    (`PlaneRegistration.register`: success, matches, pose, and each
    greedy step's two largest votes) while the apps run; yields {"dense": [...],
    "pbmap": [...], "votes": [...]}.  With `seeds` (`golden_seeds`), the
    k-th registration returns the golden's k-th pose and success in place
    of its own (which is recorded), so that what it seeds starts where the
    golden's did."""
    from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration
    from rgbd360_tpu_torch.registration.rig_dense import RigDenseAligner

    log, seen = {"dense": [], "pbmap": [], "votes": []}, set()
    saved = [(c, c.align) for c in (D.DenseAligner, RigDenseAligner)]
    register = PlaneRegistration.register

    def wrap(align):
        def recorded(self, src, trg, init_pose=None, method=D.PHOTO_DEPTH, occlusion=0):
            res = align(self, src, trg, init_pose, method, occlusion)
            seed = None if init_pose is None else torch.as_tensor(init_pose).cpu().numpy()
            key = (id(self), id(src), id(trg), method, occlusion,
                   None if seed is None else seed.tobytes())
            if key not in seen:
                seen.add(key)
                log["dense"].append((res.pose.cpu().numpy(), bool(res.ill_posed)))
            return res
        return recorded

    def recorded_register(self, ref, trg, mode=PLANAR_3DOF):
        res = register(self, ref, trg, mode)
        k = len(log["pbmap"])
        log["pbmap"].append((bool(res.success), int(res.n_matches), res.pose.cpu().numpy()))
        log["votes"].append(greedy_votes(ref, trg, self.cfg, mode))
        if seeds is None or k >= len(seeds[0]):
            return res
        dev = res.pose.device
        return dataclasses.replace(res, pose=torch.as_tensor(seeds[0][k], device=dev),
                                   success=torch.as_tensor(bool(seeds[1][k]), device=dev))

    for cls, align in saved:
        cls.align = wrap(align)
    PlaneRegistration.register = recorded_register
    try:
        yield log
    finally:
        for cls, align in saved:
            cls.align = align
        PlaneRegistration.register = register


def check_pbmap_results(log: dict, success, matches, poses, what: str, n: int | None = None):
    """The first `n` PbMap registrations of `log` (all by default) against
    the golden's: success and matches equal.  Their poses are printed
    beside the golden's, with each greedy step's two largest votes for
    those that took another alias than the golden (see the phase's
    comment)."""
    got = log["pbmap"][:n]
    s = np.array([g[0] for g in got])
    m = np.array([g[1] for g in got])
    gaps = [_pose_gaps(g[2][None], p[None]) for g, p in zip(got, np.reshape(poses, (-1, 4, 4)))]
    same = [dt <= PB_TOL_M and dr <= PB_TOL_RAD for dt, dr in gaps]
    print(f"{what}: PbMap success {s.tolist()} matches {m.tolist()} (golden "
          f"{np.atleast_1d(success).tolist()}, {np.atleast_1d(matches).tolist()}); poses within "
          f"PB_TOL of the golden's (its alias) {same}; gaps (m, rad) "
          f"{[(float(f'{dt:.3e}'), float(f'{dr:.3e}')) for dt, dr in gaps]}")
    for k, ok in enumerate(same):
        if not ok:
            votes = [[float(f"{v:.8g}") for v in step] for step in log["votes"][k]]
            print(f"{what}: registration {k} took another alias; each greedy step's two "
                  f"largest votes {votes}")
    if not (np.array_equal(s, np.atleast_1d(success)) and np.array_equal(m, np.atleast_1d(matches))):
        raise AssertionError(f"{what}: the PbMap results differ from the golden's")


def check_register_pair(rec: dict, log: dict, golden: dict, tag: str, what: str, gate) -> None:
    """One `register_pair --dense` run seeded with the golden's PbMap
    result: its own PbMap result, its GICP pose (ICP_TOL) and its dense
    solve (APP_DENSE_TOL of the nearest of the golden's branches)."""
    gate(check_pbmap_results, log, golden[f"{tag}_pb_success"], golden[f"{tag}_matches"],
         golden[f"{tag}_pbmap"], what)
    gate(_gate_gaps, f"{what} GICP", np.asarray(rec["icp"])[None], golden[f"{tag}_icp"][None],
         ICP_TOL_M, ICP_TOL_RAD)
    print(f"{what}: GICP rms {rec['icp_rms']:.6f} (golden {float(golden[f'{tag}_icp_rms']):.6f})")
    gate(_gate_branches, f"{what} dense (the app's own)", np.asarray(rec["dense"], np.float32)[None],
         golden[f"{tag}_branch_poses"][:, None], APP_DENSE_TOL)


def check_benchmark(results: dict, log: dict, golden: dict, what: str, gate) -> None:
    """`benchmark_registration`: PbMap's result, the ICP variants (from
    identity, ICP_TOL), and each dense method (from identity; `rig_joint`
    from the raw sensors) within APP_DENSE_TOL of the nearest of its
    branches."""
    gate(check_pbmap_results, log, golden["bench_pb_success"], golden["bench_pb_matches"],
         golden["bench_pbmap"], what, n=1)
    for name in BENCH_ICP:
        gate(_gate_gaps, f"{what} {name}", results[name][0][None], golden[f"bench_{name}"][None],
             ICP_TOL_M, ICP_TOL_RAD)
    if len(log["dense"]) != len(BENCH_DENSE):
        raise AssertionError(f"{what}: {len(log['dense'])} dense solves, not {len(BENCH_DENSE)}")
    gate(_gate_branches, f"{what} {', '.join(BENCH_DENSE)} (the app's own)",
         np.stack([results[name][0] for name in BENCH_DENSE]), golden["bench_dense_branch_poses"],
         APP_DENSE_TOL)


def check_register_sequence(traj, labels, log: dict, graph: dict, golden: dict, what: str,
                            gate, device) -> None:
    """`register_sequence` seeded with the golden's PbMap results: the
    same pairs registered (PbMap success and matches), the same edges
    kept, the same partition; its own dense solves (APP_DENSE_TOL of their
    nearest branches), its graph (`check_seq_graph`), its chi2
    (KF_CHI2_RTOL) and its trajectory (SEQ_TRAJ_TOL of
    `branch_matched_trajectory` with the app's information matrices); and the port's solver on the golden's
    own graph (`check_graph_solver`, on `device`)."""
    ill = np.array([d[1] for d in log["dense"]])
    pairs = golden["seq_pairs"]
    edges = pairs[~ill] if len(ill) == len(pairs) else None
    print(f"{what}: edges {None if edges is None else edges.tolist()} (golden "
          f"{golden['seq_edges'].tolist()}); areas {labels.tolist()} (golden "
          f"{golden['seq_labels'].tolist()})")
    if edges is None or not np.array_equal(edges, golden["seq_edges"]):
        raise AssertionError(f"{what}: the edges differ from the golden's")
    if not same_partition(labels, golden["seq_labels"]):
        raise AssertionError(f"{what}: areas {labels.tolist()}, golden {golden['seq_labels'].tolist()}")
    gate(check_graph_solver, golden, f"{what} graph solver", device)
    gate(check_pbmap_results, log, golden["seq_pb_success"], golden["seq_pb_matches"],
         golden["seq_pb_poses"], what)
    solves = np.stack([d[0] for d in log["dense"]])
    matched = gate(_gate_branches, f"{what} dense solves (the app's own)", solves,
                   golden["seq_branch_poses"], APP_DENSE_TOL)
    gate(check_seq_graph, graph["leaves"], solves[~ill], golden, what)
    rel = abs(graph["chi2"] - float(golden["seq_chi2"])) / max(float(golden["seq_chi2"]), 1e-12)
    print(f"{what}: the app's chi2 {graph['chi2']:.6f} (golden {float(golden['seq_chi2']):.6f}, "
          f"relative gap {rel:.3e}, tol {KF_CHI2_RTOL})")
    if rel > KF_CHI2_RTOL:
        raise AssertionError(f"{what}: chi2 leaves the tolerance")
    dt, dr = _pose_gaps(traj, golden["seq_trajectory"])
    print(f"{what}: trajectory {dt:.3e} m, {dr:.3e} rad from the golden's (its edges' "
          f"unjittered solves)")
    if matched is None:
        return
    info = graph["leaves"][GRAPH_LEAVES.index("info")][: int((~ill).sum())]
    for name, with_info in (("golden's", None), ("app's", info)):
        ref_traj = branch_matched_trajectory(golden, matched, ill, device, with_info)
        dt, dr = _pose_gaps(ref_traj, golden["seq_trajectory"])
        print(f"{what}: the golden's graph with the matched branches as its edges and the "
              f"{name} information matrices, solved: {dt:.3e} m, {dr:.3e} rad from the "
              f"golden's trajectory")
    gate(_gate_gaps, f"{what} trajectory against the golden's graph with the matched "
         f"branches and the app's information matrices", traj, ref_traj, *SEQ_TRAJ_TOL)


def branch_matched_trajectory(golden: dict, matched: np.ndarray, ill: np.ndarray,
                              device, info: np.ndarray | None = None) -> np.ndarray:
    """The trajectory the golden's sequence graph gives when each edge's
    `rel` is the golden's branch of it that the app's solve matched (the
    initial poses chained from them, as the app chains them) and, with
    `info`, the edges' information matrices are those given, solved by
    the port's `optimize_pose_graph` (held to the golden by
    `check_graph_solver`).  The graph is far from consistent (its edges,
    seeded by the room's PbMap aliases, disagree by metres), so its optimum
    is a compromise that moves with the edges' weights: the app's
    information matrices, within SEQ_INFO_RTOL of the golden's, move it by
    centimetres, and the app's trajectory is held against this solve with
    them, not against the golden's."""
    leaves = {k: np.array(golden[f"seq_graph_{k}"]) for k in GRAPH_LEAVES}
    live = np.flatnonzero(~ill)
    leaves["rel"][: len(live)] = golden["seq_branch_poses"][matched[live], live]
    if info is not None:
        leaves["info"][: len(live)] = info
    rel_of = {(int(i), int(j)): r for (i, j), r in zip(leaves["edges_ij"][: len(live)],
                                                      leaves["rel"][: len(live)])}
    poses0 = [np.eye(4)]
    for j in range(1, len(leaves["poses"])):
        poses0.append(poses0[-1] @ rel_of.get((j - 1, j), np.eye(4)))
    leaves["poses"] = np.stack(poses0).astype(np.float32)
    poses, _, _ = graph_ops.optimize_pose_graph(
        convert.pose_graph_from_numpy([leaves[k] for k in GRAPH_LEAVES], device))
    return poses.cpu().numpy()


def check_seq_graph(leaves: list, edge_poses: np.ndarray, golden: dict, what: str) -> None:
    """The graph `register_sequence` assembled against the golden's: the
    vertex mask, the edges' vertex pairs, the edge mask and the padded
    slots (identity `rel` and `info`) equal, which holds the edge capacity
    (a multiple of 8) too; each live edge's `rel` the app's own solve of it
    bit for bit (those are held to the golden's branches); the chained
    initial poses within KF_TOL; the information matrices within
    SEQ_INFO_RTOL, relative."""
    got = dict(zip(GRAPH_LEAVES, leaves))
    ref = {k: golden[f"seq_graph_{k}"] for k in GRAPH_LEAVES}
    for k in ("vmask", "edges_ij", "emask"):
        if got[k].shape != ref[k].shape or not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"{what} graph: {k} {got[k].tolist()}, golden {ref[k].tolist()}")
    live = ref["emask"]
    for k in ("rel", "info"):
        if not np.array_equal(got[k][~live], ref[k][~live]):
            raise AssertionError(f"{what} graph: the padded slots' {k} differ from the golden's")
    if not np.array_equal(got["rel"][live], edge_poses):
        raise AssertionError(f"{what} graph: the edges' rel are not the app's solves")
    info = np.abs(np.linalg.norm(got["info"][live] - ref["info"][live], axis=(1, 2))
                  / np.linalg.norm(ref["info"][live], axis=(1, 2))).max()
    print(f"{what} graph: vmask, edges_ij, emask and {int((~live).sum())} padded slots equal "
          f"the golden's; information matrices {info:.3e} relative (tol {SEQ_INFO_RTOL})")
    _gate_gaps(f"{what} graph: chained initial poses", got["poses"], ref["poses"],
               KF_TOL_M, KF_TOL_RAD)
    if not info <= SEQ_INFO_RTOL:
        raise AssertionError(f"{what} graph: the information matrices leave the tolerance")


def check_graph_solver(golden: dict, what: str, device) -> None:
    """The port's `optimize_pose_graph` on `device` on the golden's own
    sequence graph against the golden's solve of it: chi2 within
    SOLVER_CHI2_RTOL, poses within the golden tolerance (not
    SOLVER_POSE_TOL: this graph is far from consistent, its edges seeded
    by the room's PbMap aliases, and LM stops at its 10-iteration cap where
    the poses still move with rounding: 1.4e-4 m, 1.1e-4 rad measured on
    the CPU at the tests' size)."""
    leaves = [golden[f"seq_graph_{k}"] for k in GRAPH_LEAVES]
    poses, chi2, iters = graph_ops.optimize_pose_graph(convert.pose_graph_from_numpy(leaves, device))
    chi2 = float(chi2)
    rel = abs(chi2 - float(golden["seq_chi2"])) / max(float(golden["seq_chi2"]), 1e-12)
    dt, dr = _pose_gaps(poses.cpu().numpy(), golden["seq_solver_poses"])
    print(f"{what}: on the golden's graph chi2 {chi2:.6f} in {iters} LM iterations (golden "
          f"{float(golden['seq_chi2']):.6f} in {int(golden['seq_lm_iters'])}, relative gap "
          f"{rel:.3e}, tol {SOLVER_CHI2_RTOL}); poses {dt:.3e} m, {dr:.3e} rad (tol "
          f"{GOLDEN_TOL_M}, {GOLDEN_TOL_RAD})")
    if rel > SOLVER_CHI2_RTOL or dt > GOLDEN_TOL_M or dr > GOLDEN_TOL_RAD:
        raise AssertionError(f"{what}: leaves the tolerance")


def resolve_registration(builder, raws: list, golden: dict) -> dict:
    """The golden's dense solves solved again by the port from the golden's
    own seeds, on the same captures stitched with the reference's maps
    (`builder` holds them: the packages' maps differ on the sensor-tie
    columns, and a solve moves by millimetres with them, as in phase i's
    `check_tracked_solves`): `register_pair`'s (from its PbMap pose,
    nearest and bilinear sampling), the benchmark's dense methods (from
    identity) and `rig_joint` (raw sensors), `register_sequence`'s edges
    (from the golden's PbMap poses, identity where PbMap failed).  Returns
    {"pair": (1, 4, 4), "pair_bilinear": ..., "bench": (5, 4, 4),
    "seq": (n, 4, 4)} on the host."""
    from rgbd360_tpu_torch.ops.stitch import rgb_to_gray
    from rgbd360_tpu_torch.registration.rig_dense import RigDenseAligner, build_rig_pyramid

    cfg = builder.config.dense
    dev = builder.sensor.device
    pyrs: dict = {}

    def pyr(i):
        if i not in pyrs:
            pyrs[i] = builder.build_with_pyramid(RigFrame.from_raw(raws[i], dev))[1]
        return pyrs[i]

    def seed(pose):
        return torch.as_tensor(pose, dtype=torch.float32, device=dev)

    out = {}
    a, b = REG_PAIR
    for tag, bilinear in (("pair", False), ("pair_bilinear", True)):
        al = D.DenseAligner(dataclasses.replace(cfg, bilinear=bilinear))
        out[tag] = al.align(pyr(b), pyr(a), seed(golden[f"{tag}_pbmap"])).pose[None]
    a, b = REG_BENCH_PAIR
    poses = [D.DenseAligner(cfg).align(pyr(b), pyr(a), method=m).pose
             for m in (D.PHOTO_CONSISTENCY, D.DEPTH_CONSISTENCY, D.PHOTO_DEPTH)]
    poses.append(D.DenseAligner(dataclasses.replace(cfg, bilinear=True)).align(pyr(b), pyr(a)).pose)
    rigs = []
    for i in (a, b):
        rig = builder.undistort(RigFrame.from_raw(raws[i], dev))
        rigs.append(build_rig_pyramid(rgb_to_gray(rig.rgb), rig.depth, cfg))
    poses.append(RigDenseAligner(builder.k, builder.rt, cfg).align(rigs[1], rigs[0]).pose)
    out["bench"] = torch.stack(poses)
    eye = np.eye(4, dtype=np.float32)
    out["seq"] = torch.stack([
        D.DenseAligner(cfg).align(pyr(int(j)), pyr(int(i)), seed(p if ok else eye)).pose
        for (i, j), ok, p in zip(golden["seq_pairs"], golden["seq_pb_success"],
                                 golden["seq_pb_poses"])
    ])
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_resolved(got: dict, golden: dict, what: str, gate) -> None:
    """Each re-solved golden solve (`resolve_registration`) within
    GOLDEN_TOL of the nearest of the golden's jittered solves of it."""
    gate(_gate_branches, f"{what}: register_pair dense", got["pair"],
         golden["pair_branch_poses"][:, None])
    gate(_gate_branches, f"{what}: register_pair dense --bilinear", got["pair_bilinear"],
         golden["pair_bilinear_branch_poses"][:, None])
    gate(_gate_branches, f"{what}: benchmark {', '.join(BENCH_DENSE)}", got["bench"],
         golden["bench_dense_branch_poses"])
    gate(_gate_branches, f"{what}: register_sequence edges", got["seq"],
         golden["seq_branch_poses"])


@contextlib.contextmanager
def recorded_graph():
    """The graph `slam.graph.optimize_pose_graph` is given (its leaves on
    the host) and the final chi2 it returns (the app prints it and returns
    the trajectory): yields a dict filled when it runs."""
    saved, out = graph_ops.optimize_pose_graph, {}

    def record(g, *a, **kw):
        res = saved(g, *a, **kw)
        out.update(chi2=float(res[1]), leaves=convert.pose_graph_to_numpy(g))
        return res

    graph_ops.optimize_pose_graph = record
    try:
        yield out
    finally:
        graph_ops.optimize_pose_graph = saved


def registration_extras(paths: dict, walk: list) -> tuple:
    """The solves of phase l beside the apps, on the reference's stitch
    maps (the golden's `extra_*`): `DenseAligner.align` with occlusion 1
    and 2 on the walk's REG_EXTRA_PAIR, and the pinhole
    `DenseAligner(intrinsics=K)` on sensor 0's raw 240x320 pair.  Returns
    (poses (3, 4, 4), the pinhole pyramid's K1/K2 launches)."""
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame
    from rgbd360_tpu_torch.ops.stitch import rgb_to_gray

    cfg = synthetic.config()
    builder = FrameBuilder(load_calibration(paths["calib"] / "Extrinsics", None), cfg)
    load_reference_maps(builder)
    raws = [read_rig_frame(walk[i]) for i in REG_EXTRA_PAIR]
    pyrs = [builder.build_with_pyramid(RigFrame.from_raw(r))[1] for r in raws]
    aligner = D.DenseAligner(cfg.dense)
    poses = [aligner.align(pyrs[1], pyrs[0], occlusion=occ).pose for occ in (1, 2)]
    dev = builder.sensor.device
    _reset_counts()
    sensor = [D.build_frame_pyramid(
        rgb_to_gray(torch.from_numpy(r.rgb[0]).to(dev)),
        torch.from_numpy(r.depth_mm[0]).to(dev).to(torch.float32) * 0.001,
        cfg.dense, spherical=False) for r in raws]
    launches = _counts()
    poses.append(D.DenseAligner(cfg.dense, intrinsics=builder.k).align(sensor[1], sensor[0]).pose)
    return torch.stack(poses).cpu().numpy(), launches


def check_registration_phase(smi: str) -> None:
    """Phase l: the registration apps (`register_pair`,
    `benchmark_registration`, `register_sequence`) on capture files at
    full size, the occlusion modes and the pinhole solve, the rig pyramid
    and ICP's host syncs."""
    import tempfile

    from rgbd360_tpu_torch.apps import benchmark_registration, register_pair, register_sequence
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame
    from rgbd360_tpu_torch.ops.pyramid import build_depth_pyramid
    from rgbd360_tpu_torch.ops.stitch import rgb_to_gray
    from rgbd360_tpu_torch.registration.icp import GICP, ICPAligner
    from rgbd360_tpu_torch.registration.rig_dense import build_rig_pyramid

    failed: list = []
    gate = _gate_collector(failed)
    golden = dict(np.load(REGISTRATION_GOLDEN))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        paths = synthetic.write_app_inputs(tmp, loop_frames=0)
        walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                      key=lambda p: int(p.stem.rsplit("_", 1)[1]))
        calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
        print(f"registration set-up (calibration directory, {len(walk)} walk capture files): "
              f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        walls = {}
        pair = [str(walk[i]) for i in REG_PAIR]
        for tag, extra in (("pair", ["--out", str(tmp / "pair")]), ("pair_bilinear", ["--bilinear"])):
            what = f"registration: register_pair --dense {' '.join(extra[:1])}".rstrip()
            _reset_counts()
            t0 = time.perf_counter()
            with recorded_registration(golden_seeds(golden, f"{tag}_pbmap",
                                                    f"{tag}_pb_success")) as log:
                rec = register_pair.main(pair + calib + ["--dense"] + extra)
            walls[what] = time.perf_counter() - t0
            gate(check_app_launches, _counts(), 2, what)
            check_register_pair(rec, log, golden, tag, what, gate)
        gate(check_app_files, tmp / "pair", PAIR_OUT_FILES, "registration: register_pair")

        what = "registration: benchmark_registration"
        _reset_counts()
        t0 = time.perf_counter()
        with recorded_registration() as log:
            results = benchmark_registration.main(
                [str(walk[i]) for i in REG_BENCH_PAIR] + calib + ["--repeats", "3"])
        walls[what] = time.perf_counter() - t0
        # two sphere pyramids and two rig pyramids
        gate(check_app_launches, _counts(), 4, what)
        gate(check_benchmark, results, log, golden, what, gate)
        bench_ms = {name: float(r[1]) for name, r in results.items()}

        what = "registration: register_sequence"
        _reset_counts()
        t0 = time.perf_counter()
        seeds = golden_seeds(golden, "seq_pb_poses", "seq_pb_success")
        with recorded_registration(seeds) as log, recorded_graph() as graph:
            traj, labels = register_sequence.main(
                [str(paths["walk"])] + calib + ["--window", str(REG_WINDOW), "--out",
                                                str(tmp / "seq")])
        walls[what] = time.perf_counter() - t0
        gate(check_app_launches, _counts(), len(walk), what)
        gate(check_register_sequence, traj, labels, log, graph, golden, what, gate,
             torch.device("cuda"))
        gate(check_app_files, tmp / "seq", SEQ_OUT_FILES, what)
        peak = torch.cuda.max_memory_allocated() / 2**20

        # the golden's dense solves again, on the reference's stitch maps
        ref_builder = FrameBuilder(load_calibration(paths["calib"] / "Extrinsics", None),
                                   synthetic.config())
        load_reference_maps(ref_builder)
        t0 = time.perf_counter()
        resolved = resolve_registration(ref_builder, [read_rig_frame(p) for p in walk], golden)
        print(f"registration: the golden's {sum(len(v) for v in resolved.values())} dense solves "
              f"re-solved in {time.perf_counter() - t0:.2f} s")
        check_resolved(resolved, golden, "registration: re-solved", gate)
        del ref_builder

        poses, launches = registration_extras(paths, walk)
        gate(check_app_launches, launches, 2, "registration: pinhole pyramids", solves=False)
        gate(_gate_branches, "registration: occlusion 1, occlusion 2, pinhole (sensor 0)",
             poses, golden["extra_branch_poses"])

        # the rig pyramid: 1 K1 + 4 K2 and no other device op; ICP's loop
        # reads nothing back
        builder = FrameBuilder(load_calibration(paths["calib"] / "Extrinsics", None),
                               synthetic.config())
        rig = builder.undistort(RigFrame.from_raw(read_rig_frame(walk[0])))
        gray = rgb_to_gray(rig.rgb)
        gate(check_pyramid_stage, lambda: build_rig_pyramid(gray, rig.depth, builder.config.dense),
             builder.config.dense.pyramid_levels, "rig pyramid (8x240x320)")
        sphere = builder.build(rig)
        dp = build_depth_pyramid(sphere.sphere_depth, 4)
        icp = ICPAligner(builder.config.dense, variant=GICP)
        icp.align(dp, dp)
        torch.cuda.synchronize()
        syncs = _count_syncs(lambda: icp.align(dp, dp))
        print(f"registration: GICP align (4 levels x 10 iterations): {syncs} host syncs "
              f"(sync debug mode)")
        if syncs:
            failed.append(f"the ICP loop synchronized with the host {syncs} times")

        def profiled_icp() -> None:
            wall, busy, ops, waits, _ = _profile(lambda: icp.align(dp, dp))
            print(f"registration: GICP align, profiled: {ops} device ops, device busy "
                  f"{busy:.3f} ms, wall {wall:.3f} ms, idle share {1 - busy / wall:.3f}, "
                  f"{waits} host waits, on {smi}")

        _DEFERRED.append(profiled_icp)

    for name, wall in walls.items():
        print(f"{name}: main {wall:.2f} s with its set-up and export, on {smi}")
    print(f"registration: benchmark_registration ms per call (CUDA-synchronized, mean of 3): "
          + json.dumps({k: round(v, 3) for k, v in bench_ms.items()}) + f", on {smi}")
    print(f"registration: peak device memory of the apps {peak:.1f} MiB, on {smi}")
    if failed:
        raise AssertionError(f"phase l: {len(failed)} gates failed: " + " | ".join(failed))


# ------------------------------------------------------------- phase m
#
# The extras on the card at full size: the parallax-refined stitch, the
# odometry app with `--parallax-refine`, the calibration suite, the rawlog,
# PbMap and stereo I/O, the viewer and the labeling app, held to
# `data/extras_golden.npz` (`tools/torch_port_golden.py --extras-only`:
# the reference's own functions and apps over the same inputs).  The
# scenes below are plain numpy, shared by the golden tool, the CPU tests
# and the phase, so all three see the very same inputs.
EXTRAS_GOLDEN = DATA / "extras_golden.npz"
STITCH_SAMPLE = 2048  # sphere pixels of the refined stitch's golden sample
LABEL_FRAME = 1  # the walk's `sphere_images_1.bin`, labelled by `labelize apply`
LABELS = {"0": "floor", "1": "ceiling", "2": {"name": "wall", "level": "object"}}
CAL_PAIR = (0, 1)  # `calibrate pair`, `fim` and `online --sensors`
LASER_RT = (0.05, -0.03, 0.08, 0.02, -0.04, 0.03)  # twist (v, w) of the laser on the rig
TOF_RT = (0.10, -0.04, 0.02, 0.05, -0.3, 0.15)  # twist of ToF camera B in camera A
TOF_SHAPE = (60, 80)  # the ToF range images
RANSAC_INLIERS, RANSAC_OUTLIERS, RANSAC_HYPOTHESES = 900, 300, 512


def se3_exp_np(xi) -> np.ndarray:
    """float64 SE(3) exponential of a twist (v, w) (the laser solver's)."""
    from rgbd360_tpu_torch.calibration.laser import _exp_se3

    return _exp_se3(np.asarray(xi, np.float64))


def perturbed_rt(rt: np.ndarray, seed: int = 3) -> np.ndarray:
    """The extrinsics (S, 4, 4) with every sensor but 0 moved by a seeded
    twist (1 cm, 0.02 rad standard deviations): `calibrate solve`'s seed."""
    rng = np.random.default_rng(seed)
    out = np.array(rt, np.float64)
    for s in range(1, len(out)):
        out[s] = out[s] @ se3_exp_np(np.concatenate([rng.normal(0, 0.01, 3),
                                                     rng.normal(0, 0.02, 3)]))
    return out


def octagon_planes(radius: float = synthetic.ROOM_RADIUS, half_height: float = 1.7):
    """(normals (10, 3), ds (10,)) of the octagon room seen from the walk's
    first pose, n . x + d = 0 in the rig frame: 8 walls and the two caps
    (`apps.grabber._octagon_hit`'s room)."""
    phis = (np.arange(8) + 0.5) * (np.pi / 4)
    walls = np.stack([np.zeros(8), np.sin(phis), np.cos(phis)], axis=-1)
    normals = np.vstack([walls, [[1.0, 0, 0], [-1.0, 0, 0]]])
    return normals, np.concatenate([np.full(8, -radius), [-half_height, -half_height]])


def laser_observations(normals: np.ndarray, ds: np.ndarray, n_rays: int = 361) -> list:
    """One 2D range scan ray-cast against the planes from the laser pose
    LASER_RT (`calibrate laser`'s input; the reference's
    `tests/test_apps.py::test_calibrate_laser_app` scene)."""
    from rgbd360_tpu_torch.io.rawlog import Obs2DRangeScan

    rt = se3_exp_np(LASER_RT)
    aperture = float(np.pi)
    ang = -aperture / 2 + np.arange(n_rays) * (aperture / (n_rays - 1))
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_rays)], -1) @ rt[:3, :3].T
    denom = dirs @ normals.T
    s = -(rt[:3, 3] @ normals.T + ds)[None, :] / np.where(np.abs(denom) > 1e-6, denom, 1e-6)
    s = np.where((np.abs(denom) > 0.1) & (s > 0.3), s, np.inf)
    rng_m = s.min(axis=1)
    hit = np.isfinite(rng_m)
    return [Obs2DRangeScan(sensor_label="LASER", aperture=aperture, right_to_left=True,
                           max_range=20.0, ranges=np.where(hit, rng_m, 0.0).astype(np.float32),
                           validity=hit.astype(np.uint8))]


def tof_observations(n_frames: int = 8, seed: int = 0) -> list:
    """Paired range images of a tilted wall from ToF cameras A (`KINECT`)
    and B (`CAM3D`, at TOF_RT in A), with gray intensity images, one pair
    per frame (`calibrate tof`'s input, the reference's
    `ToFCalibrator.cpp` protocol); cameras use `calibration.tof`'s default
    pinhole for TOF_SHAPE."""
    from rgbd360_tpu_torch.io.rawlog import Obs3DRangeScan, unix_to_mrpt_timestamp

    rng = np.random.default_rng(seed)
    h, w = TOF_SHAPE
    f = 525.0 * w / 640.0
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([(u - (w - 1) / 2.0) / f, (v - (h - 1) / 2.0) / f, np.ones_like(u)], -1)
    rt = se3_exp_np(TOF_RT)
    gray = (np.add.outer(np.arange(h), np.arange(w)) * 2 % 256).astype(np.uint8)
    obs = []
    for k in range(n_frames):
        n_a = np.array([*rng.uniform(-0.5, 0.5, 2), -1.0])
        n_a /= np.linalg.norm(n_a)
        d_a = rng.uniform(1.5, 3.0)
        n_b, d_b = n_a @ rt[:3, :3], d_a + n_a @ rt[:3, 3]
        ts = unix_to_mrpt_timestamp(1000.0 + k)
        for label, n, d in (("KINECT", n_a, d_a), ("CAM3D", n_b, d_b)):
            z = -d / (rays @ n)
            z = z + rng.normal(0, 0.003, z.shape)
            z = np.where((z > 0.3) & (z < 10.0), z, 0.0).astype(np.float32)
            obs.append(Obs3DRangeScan(sensor_label=label, timestamp=ts, range_image=z,
                                      intensity_image=gray))
    return obs


def ransac_scene(seed: int = 3) -> np.ndarray:
    """(N, 3) float32: RANSAC_INLIERS noisy points on a tilted plane
    (n . x + 1.7 = 0) and RANSAC_OUTLIERS uniform ones (the reference's
    `tests/test_calibration.py` scene, smaller)."""
    rng = np.random.default_rng(seed)
    n = np.array([0.2, -0.5, 0.84])
    n /= np.linalg.norm(n)
    basis = np.linalg.svd(n[None, :])[2][1:]
    pts_in = (-1.7 * n + rng.uniform(-2, 2, (RANSAC_INLIERS, 2)) @ basis
              + rng.normal(0, 0.004, (RANSAC_INLIERS, 3)))
    return np.vstack([pts_in, rng.uniform(-4, 4, (RANSAC_OUTLIERS, 3))]).astype(np.float32)


def gray_observations(raws: list, t0: float = 1e9) -> list:
    """Rawlog observations of rig captures with GRAY intensity images (a
    gray `CImage` rides raw, with no JPEG codec): per capture k and sensor
    i, `RGBD<i+1>` with the construction-spec pose, the depth in metres and
    the BGR->gray of its image, stamped t0 + k seconds."""
    from rgbd360_tpu_torch.calibration.spec import construction_spec_rt
    from rgbd360_tpu_torch.io.rawlog import Obs3DRangeScan, unix_to_mrpt_timestamp

    obs = []
    for k, raw in enumerate(raws):
        poses = construction_spec_rt(raw.rgb.shape[0])
        bgr = raw.rgb.astype(np.float32)
        gray = np.round(0.114 * bgr[..., 0] + 0.587 * bgr[..., 1]
                        + 0.299 * bgr[..., 2]).astype(np.uint8)
        obs += [Obs3DRangeScan(sensor_label=f"RGBD{i + 1}",
                               timestamp=unix_to_mrpt_timestamp(t0 + k),
                               sensor_pose=poses[i],
                               range_image=raw.depth_mm[i].astype(np.float32) * 0.001,
                               intensity_image=gray[i])
                for i in range(raw.rgb.shape[0])]
    return obs


def extras_calibration(cfg):
    """The synthetic rig's calibration without its CLAMS model (the
    extrinsics of the apps' calibration directory, `--no-intrinsics`)."""
    return dataclasses.replace(synthetic.calibration(cfg.rig), clams_multipliers=None,
                               clams_counts=None)


def write_tof_laser_inputs(root: Path) -> dict:
    """`calibrate tof`'s and `laser`'s inputs under `root`: `tof.rawlog`,
    `laser.rawlog`, `planes.json` (the octagon's planes) and `guess.txt`
    (identity)."""
    root.mkdir(parents=True, exist_ok=True)
    from rgbd360_tpu_torch.io.rawlog import write_rawlog

    normals, ds = octagon_planes()
    paths = {k: root / v for k, v in (("tof", "tof.rawlog"), ("laser", "laser.rawlog"),
                                       ("planes", "planes.json"), ("guess", "guess.txt"))}
    write_rawlog(paths["tof"], tof_observations())
    write_rawlog(paths["laser"], laser_observations(normals, ds))
    paths["planes"].write_text(json.dumps([{"n": n.tolist(), "d": float(d)}
                                           for n, d in zip(normals, ds)]))
    np.savetxt(paths["guess"], np.eye(4))
    return paths


def write_perturbed_calibration(root: Path, rig) -> np.ndarray:
    """A calibration directory `root/Extrinsics` of the rig's extrinsics
    moved by `perturbed_rt`; returns them."""
    rt = perturbed_rt(synthetic.calibration(rig).rt)
    ext = root / "Extrinsics"
    ext.mkdir(parents=True, exist_ok=True)
    for s, m in enumerate(rt, start=1):
        np.savetxt(ext / f"Rt_0{s}.txt", m, fmt="%.9g")
    return rt



# The refined stitch on the reference's maps against the golden's sample:
# the two packages compute each ray's sensor coordinates with different
# rounding (PyTorch rounds the 3x3 products without fused multiply-adds,
# and its sin/cos differ by ulps between the CPU and the card), so a
# truncated index can land on the neighbouring integer: measured on the
# CPU 1 pixel of 614,400 at full size (1.6e-6), none at the tests' size.
STITCH_FLIP_FRAC = 1e-3
# The refined depth where both packages sampled the same pixel: one
# square root of sums of products of the same gathered depth, ulps apart
# (measured 2.1e-7 relative on the CPU).
STITCH_DEPTH_RTOL = 1e-5
# The reference's own gates on the refined sphere (`tests/test_frame.py::
# test_parallax_refined_stitch_accuracy`), at full size.
STITCH_GAIN, STITCH_ERR_M, STITCH_COV = 0.2, 0.01, 0.02
# The control planes of `calibrate collect`: the same per-sensor clouds
# (no stitch map enters) segmented by both packages; a matched plane's
# normal and offset differ by the segmentation's rounding (measured on the
# CPU at subsample 2: 5.5e-4 rad, 2.3e-3 m; phase g's plane normal
# tolerance), its weight (the smaller inlier count) by a few pixels.
CP_NORMAL_TOL, CP_D_TOL, CP_W_RTOL = PLANE_TOL_RAD, 5e-3, 0.02
# A calibration solved by the port against the reference's on the same
# control planes (float32 LM with the same steps): measured 7.4e-6 on the
# CPU at the tests' size.
CAL_SAME_TOL = (1e-4, 1e-4)
# ... and on the port's own control planes (CP_* apart): the solve moves
# with its inputs.
CAL_OWN_TOL = (5e-3, 5e-3)
# The rig recovered from a perturbed seed against the true (construction
# spec) rig: the reference's rotation bound (`tests/test_calibration.py:
# 94-95`, 0.01 rad); its translation bound there is 0.02 m, but on this
# scene both packages recover the ring's translations only to 1.4-3.1 cm
# (the matched control planes' offsets disagree by 5-8 mm per pair even
# under the true extrinsics, `calibrate eval`, and the ring chains them;
# measured on the CPU at full size, the golden 3.12e-2 m), so the bound is
# CAL_TRUTH_M, and the golden's own gap is printed beside it.
CAL_TRUTH_RAD, CAL_TRUTH_M = 0.01, 0.05
# `calibrate tof`: the port's RANSAC draws its own hypotheses, the
# least-squares refit then lands both on the same inliers' plane.
TOF_TOL = (2e-3, 2e-3)
# The laser and ToF extrinsics against their truth: the reference's bounds
# (`tests/test_apps.py:307-308`, `tests/test_calibration.py:288-289`).
LASER_TRUTH = (0.03, 0.02)
TOF_TRUTH = (0.01, np.radians(0.5))
# RANSAC on the golden's index triples: the winning plane within float32
# rounding of the (N, H) product and the cross product; the vote counts
# and inlier masks may differ on points within rounding of the threshold.
RANSAC_TOL, RANSAC_FLIPS = 1e-5, 2
LABEL_LEVELS = ("plane", "object", "context")


def _twist_gap(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(translation m, rotation rad) of inv(a) @ b for single 4x4s."""
    return _pose_gaps(np.asarray(a)[None], np.asarray(b)[None])


def _relative_gaps(rt: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """Largest gap over sensors of the sensor-0-relative extrinsics."""
    rel = lambda r: np.linalg.inv(r[0])[None] @ r  # noqa: E731
    return _pose_gaps(rel(np.asarray(rt, np.float64)), rel(np.asarray(ref, np.float64)))


def refined_builder(builder: FrameBuilder) -> FrameBuilder:
    """`builder` with `sphere.parallax_refine` on (its buffers shared)."""
    import copy

    out = copy.copy(builder)
    out.config = builder.config.replace(sphere=dataclasses.replace(
        builder.config.sphere, parallax_refine=True))
    return out


def check_refined_sample(builder: FrameBuilder, raw, golden: dict, what: str) -> dict:
    """The refined build (`FrameBuilder.build` with `parallax_refine`) and
    `refine_stitch_maps` of one capture on `builder`'s maps (the
    reference's) against the golden's sample; returns the gaps."""
    from rgbd360_tpu_torch.ops import stitch as stitch_ops

    frame = RigFrame.from_raw(raw, builder.sensor.device)
    sphere = refined_builder(builder).build(frame)
    plain = builder.build(frame)
    rig = builder.config.rig
    maps = stitch_ops.refine_stitch_maps(builder.maps, plain.sphere_depth, builder.rt_inv,
                                         builder.k, rig.height, rig.width)
    idx = torch.as_tensor(golden["stitch_sample"].astype(np.int64), device=builder.sensor.device)
    u = maps.u.reshape(-1)[idx].cpu().numpy()
    v = maps.v.reshape(-1)[idx].cpu().numpy()
    d = sphere.sphere_depth.reshape(-1)[idx].cpu().numpy()
    same = (u == golden["stitch_u"]) & (v == golden["stitch_v"])
    flips = float(np.mean(~same))
    ref_d = golden["stitch_depth"]
    rel = np.abs(d - ref_d)[same] / np.maximum(np.abs(ref_d[same]), 1e-6)
    zero_ok = bool(np.array_equal(d[same] > 0, ref_d[same] > 0))
    worst = float(rel.max()) if rel.size else 0.0
    print(f"{what}: refined maps differ from the golden's on {int((~same).sum())} of "
          f"{len(same)} sampled pixels ({flips:.2e}, tol {STITCH_FLIP_FRAC}); refined depth "
          f"elsewhere {worst:.2e} relative (tol {STITCH_DEPTH_RTOL}), same zeros {zero_ok}")
    if flips > STITCH_FLIP_FRAC or worst > STITCH_DEPTH_RTOL or not zero_ok:
        raise AssertionError(f"{what}: the refined stitch leaves the golden's tolerance")
    return {"flips": flips, "depth_rtol": worst}


def octagon_errors(builder: FrameBuilder, raw) -> dict:
    """Mean absolute radial error against the analytic octagon (walk
    capture 0's pose) and coverage of the plain and the refined sphere of
    `raw` on `builder` (its own maps)."""
    from rgbd360_tpu_torch.apps.grabber import _octagon_hit
    from rgbd360_tpu_torch.ops import camera

    frame = RigFrame.from_raw(raw, builder.sensor.device)
    out = {}
    for tag, b in (("plain", builder), ("refined", refined_builder(builder))):
        d = b.build(frame).sphere_depth
        rays = camera.sphere_rays(*d.shape).numpy()
        gt = _octagon_hit(np.zeros(3), rays, synthetic.ROOM_RADIUS)
        d = d.cpu().numpy()
        m = (d > 0) & np.isfinite(gt)
        out[f"err_{tag}"] = float(np.mean(np.abs(d - gt)[m]))
        out[f"cov_{tag}"] = float(np.mean(d > 0))
    return out


def check_octagon(got: dict, golden: dict, what: str, absolute: bool = True) -> None:
    """The refined sphere against the analytic room: under STITCH_GAIN of
    the plain sphere's error and under STITCH_ERR_M, coverage within
    STITCH_COV (`absolute`: the reference's full-size gates); and each
    error within 5% of the golden's (the reference on its own maps)."""
    e_p, e_r = got["err_plain"], got["err_refined"]
    print(f"{what}: mean radial error vs the analytic octagon plain {e_p:.5f} m, refined "
          f"{e_r:.5f} m (golden {float(golden['stitch_err_plain']):.5f}, "
          f"{float(golden['stitch_err_refined']):.5f}); coverage {got['cov_plain']:.4f}, "
          f"{got['cov_refined']:.4f}")
    if absolute and not (e_r < STITCH_GAIN * e_p and e_r < STITCH_ERR_M
                         and abs(got["cov_plain"] - got["cov_refined"]) < STITCH_COV):
        raise AssertionError(f"{what}: the refined sphere misses the reference's gates")
    for tag in ("plain", "refined"):
        ref = float(golden[f"stitch_err_{tag}"])
        if abs(got[f"err_{tag}"] - ref) > 0.05 * ref:
            raise AssertionError(f"{what}: {tag} error {got[f'err_{tag}']} is not the golden's {ref}")


def check_refined_steps(traj: np.ndarray, golden: dict, what: str) -> None:
    """The odometry app's steps with `--parallax-refine`: each within the
    golden tolerance of the golden's step or of the nearest of its solve's
    jittered re-solves (phase i's rule)."""
    traj = np.asarray(traj, np.float64)
    steps = np.linalg.inv(traj[:-1]) @ traj[1:]
    cands = np.concatenate([golden["odo_steps"][None], golden["odo_branch_steps"]])
    worst, picks = (0.0, 0.0), []
    for i in range(len(steps)):
        gaps = [_twist_gap(steps[i], c[i]) for c in cands]
        j = min(range(len(gaps)), key=lambda b: gaps[b][0] / GOLDEN_TOL_M + gaps[b][1] / GOLDEN_TOL_RAD)
        picks.append(j)
        worst = (max(worst[0], gaps[j][0]), max(worst[1], gaps[j][1]))
    print(f"{what}: axial steps {np.round(steps[:, 0, 3], 5).tolist()} (golden "
          f"{np.round(golden['odo_steps'][:, 0, 3], 5).tolist()}); nearest of the golden's step "
          f"(0) and its {len(cands) - 1} jittered solves {picks}: {worst[0]:.3e} m, "
          f"{worst[1]:.3e} rad (tol {GOLDEN_TOL_M}, {GOLDEN_TOL_RAD})")
    if np.abs(steps[:, 0, 3] - STEP_M).max() > STEP_TOL_M:
        raise AssertionError(f"{what}: axial steps leave {STEP_M} +- {STEP_TOL_M} m")
    if worst[0] > GOLDEN_TOL_M or worst[1] > GOLDEN_TOL_RAD:
        raise AssertionError(f"{what}: steps leave the golden's tolerance")


def _assigned(rows: np.ndarray, golden: np.ndarray) -> np.ndarray:
    """`rows` reordered within each sensor pair to the golden's rows they
    are closest to (a one-to-one assignment on the normals and offsets):
    a frame's greedy matcher may take equally good plane pairs in another
    order, and the consensus trim keeps the accumulated order."""
    from scipy.optimize import linear_sum_assignment

    out = np.empty_like(golden)
    for key in {tuple(r) for r in golden[:, :2].tolist()}:
        gi = np.flatnonzero((golden[:, :2] == key).all(axis=1))
        ri = np.flatnonzero((rows[:, :2] == key).all(axis=1))
        cost = np.abs(rows[ri][:, None, 2:10] - golden[gi][None, :, 2:10]).sum(axis=-1)
        r, c = linear_sum_assignment(cost)
        out[gi[c]] = rows[ri[r]]
    return out


def check_control_planes(rows: np.ndarray, golden: np.ndarray, what: str) -> None:
    """`calibrate collect`'s control planes (rows a b n_a d_a n_b d_b w)
    against the golden's: the same count per pair, then each golden row
    against the port's row assigned to it (`_assigned`): normals within
    CP_NORMAL_TOL rad, offsets within CP_D_TOL m, weights within
    CP_W_RTOL."""
    rows, golden = np.atleast_2d(rows), np.atleast_2d(golden)
    count = lambda r: Counter(map(tuple, r[:, :2].astype(int).tolist()))  # noqa: E731
    got_c, ref_c = count(rows), count(golden)
    print(f"{what}: {len(rows)} control planes, per pair {sorted(got_c.items())} (golden "
          f"{len(golden)}, {sorted(ref_c.items())})")
    if got_c != ref_c:
        raise AssertionError(f"{what}: the pairs' control-plane counts differ from the golden's")
    rows = _assigned(rows, golden)
    ang = lambda a, b: np.arctan2(np.linalg.norm(np.cross(a, b), axis=1), np.sum(a * b, axis=1))  # noqa: E731
    gaps = (max(ang(rows[:, 2:5], golden[:, 2:5]).max(), ang(rows[:, 6:9], golden[:, 6:9]).max()),
            np.abs(rows[:, [5, 9]] - golden[:, [5, 9]]).max(),
            (np.abs(rows[:, 10] - golden[:, 10]) / golden[:, 10]).max())
    print(f"{what}: normals {gaps[0]:.3e} rad (tol {CP_NORMAL_TOL}), offsets {gaps[1]:.3e} m "
          f"(tol {CP_D_TOL}), weights {gaps[2]:.3e} relative (tol {CP_W_RTOL})")
    if gaps[0] > CP_NORMAL_TOL or gaps[1] > CP_D_TOL or gaps[2] > CP_W_RTOL:
        raise AssertionError(f"{what}: control planes leave the tolerance")


def check_rig(rt, ref, tol: tuple, what: str, relative: bool = False) -> None:
    """Extrinsics (S, 4, 4) or one 4x4 against `ref` within tol (m, rad);
    `relative`: sensor-0-relative (the rig's gauge)."""
    rt, ref = np.asarray(rt, np.float64), np.asarray(ref, np.float64)
    if rt.ndim == 2:
        rt, ref = rt[None], ref[None]
    dt, dr = _relative_gaps(rt, ref) if relative else _pose_gaps(rt, ref)
    print(f"{what}: {dt:.3e} m, {dr:.3e} rad (tol {tol[0]}, {tol[1]})")
    if dt > tol[0] or dr > tol[1]:
        raise AssertionError(f"{what}: leaves the tolerance")


def check_fim(table: np.ndarray, golden: np.ndarray, what: str) -> None:
    """`calibrate fim`'s table: the eigenvalues never decrease as
    correspondences accumulate, and the last row's eigenvalues within 1%
    of the golden's."""
    table = np.asarray(table)
    inc = all(np.all(np.diff(table[:, c]) >= -1e-9) for c in (3, 6))
    gap = float(np.max(np.abs(table[-1, 1:7] - golden[-1, 1:7])
                       / np.maximum(np.abs(golden[-1, 1:7]), 1e-6)))
    print(f"{what}: {len(table)} rows (golden {len(golden)}), largest eigenvalues never "
          f"decrease {inc}; last row's eigenvalues {gap:.3e} relative to the golden's")
    if not inc or len(table) != len(golden) or gap > 0.01:
        raise AssertionError(f"{what}: the FIM table leaves the tolerance")


def check_eval(rows: dict, golden: np.ndarray, what: str) -> None:
    """`calibrate eval`'s table against the golden's: the same pairs and
    counts; conditioning within 2%, residuals within 1e-4 / CP_D_TOL."""
    got = np.asarray([[a, b, *v] for (a, b), v in sorted(rows.items())], np.float64)
    ok = got.shape == golden.shape and np.array_equal(got[:, :3], golden[:, :3])
    gaps = (np.abs(got[:, 3] - golden[:, 3]) / golden[:, 3]).max() if ok else np.inf
    res = np.abs(got[:, 4:] - golden[:, 4:]).max(axis=0) if ok else [np.inf, np.inf]
    print(f"{what}: {len(got)} pairs, conditioning {gaps:.3e} relative, rotation residual "
          f"{res[0]:.3e}, translation residual {res[1]:.3e} m from the golden's")
    if not ok or gaps > 0.02 or res[0] > 1e-4 or res[1] > CP_D_TOL:
        raise AssertionError(f"{what}: the evaluation leaves the tolerance")


def check_ransac(golden: dict, device, what: str) -> None:
    """The port's RANSAC core on the golden's index triples, and the public
    `ransac_plane` with its own hypotheses, on `ransac_scene()`."""
    from rgbd360_tpu_torch.ops import ransac

    pts_np = ransac_scene()
    pts = torch.as_tensor(pts_np, device=device)
    valid = torch.ones(len(pts), dtype=torch.bool, device=device)
    idx = torch.as_tensor(golden["ransac_idx"].astype(np.int64), device=device)
    n, d, count = ransac._ransac_plane_core(pts, valid, idx, 0.03)
    inl = ((torch.abs(pts @ n + d) < 0.03) & valid).cpu().numpy()
    n, d, count = n.cpu().numpy(), float(d), int(count)
    gap = max(np.abs(n - golden["ransac_n"]).max(), abs(d - float(golden["ransac_d"])))
    flips = int(np.sum(inl != golden["ransac_inliers"]))
    print(f"{what}: core on the golden's {len(idx)} triples: plane {gap:.2e} from the golden's "
          f"(tol {RANSAC_TOL}), count {count} (golden {int(golden['ransac_count'])}), inlier "
          f"mask differs on {flips} points (tol {RANSAC_FLIPS})")
    if gap > RANSAC_TOL or flips > RANSAC_FLIPS or abs(count - int(golden["ransac_count"])) > RANSAC_FLIPS:
        raise AssertionError(f"{what}: the RANSAC core leaves the golden's tolerance")
    pn, pd, pinl = ransac.ransac_plane(pts_np, dist_threshold=0.03, device=device)
    cos = float(np.dot(pn, golden["ransac_plane_n"]))
    dd = abs(pd - float(golden["ransac_plane_d"]))
    frac = (float(pinl[:RANSAC_INLIERS].mean()), float(pinl[RANSAC_INLIERS:].mean()))
    print(f"{what}: ransac_plane with its own hypotheses: normal . golden's {cos:.6f}, offset "
          f"{dd:.2e} m apart, inliers {frac[0]:.3f} of the plane's points, {frac[1]:.3f} of "
          f"the outliers")
    if cos < 0.9999 or dd > 0.01 or frac[0] < 0.98 or frac[1] > 0.05 or pd < 0:
        raise AssertionError(f"{what}: ransac_plane misses the plane")


def check_labels(stats: dict, golden: dict, what: str) -> None:
    ref = json.loads(str(golden["label_stats"]))
    got = {lv: stats.get(lv, {}) for lv in LABEL_LEVELS}
    print(f"{what}: label statistics {got} (golden {ref})")
    if got != ref:
        raise AssertionError(f"{what}: label statistics differ from the golden's")


def check_pbmap_roundtrip(path: Path, planes, what: str) -> None:
    """The .pbmap `view_frame --planes` wrote, read back field by field
    against the plane set it came from."""
    from rgbd360_tpu_torch.io.pbmap import planeset_to_pbplanes, read_pbmap

    want, got = planeset_to_pbplanes(planes), read_pbmap(path)
    fields = ("normal", "center", "ppal_dir", "color_nrgb", "hist_h", "polygon")
    same = len(want) == len(got) and all(
        np.array_equal(np.asarray(getattr(a, f), np.float32), getattr(b, f))
        for a, b in zip(want, got) for f in fields
    ) and all(a.num_observations == b.num_observations for a, b in zip(want, got))
    print(f"{what}: {len(got)} planes read back from {path.name}, equal {same}")
    if not same:
        raise AssertionError(f"{what}: the PbMap read back differs")


def check_gif(path: Path, frames: int, shape: tuple, what: str) -> None:
    """The GIF's header, size, frame count (image descriptors after a
    graphic control extension) and trailer."""
    import struct

    data = path.read_bytes()
    w, h = struct.unpack_from("<HH", data, 6)
    n = data.count(b"\x21\xf9\x04")
    print(f"{what}: {path.name} {len(data)} bytes, {w}x{h}, {n} frames, header "
          f"{data[:6]!r}, trailer {data[-1:]!r}")
    if data[:6] != b"GIF89a" or data[-1:] != b"\x3b" or (h, w) != tuple(shape) or n < frames:
        raise AssertionError(f"{what}: not a valid {frames}-frame GIF")


def run_rawlog(raws: list, tmp: Path, builder, calib: list) -> dict:
    """`load_rawlog` on a rawlog of the captures with gray images: with
    `--to-bin` (read back) and as a sphere export."""
    from rgbd360_tpu_torch.apps import load_rawlog
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame
    from rgbd360_tpu_torch.io.rawlog import write_rawlog

    log = tmp / "walk.rawlog"
    write_rawlog(log, gray_observations(raws))
    n_bin = load_rawlog.main([str(log), "--out", str(tmp / "bins"), "--to-bin"] + calib,
                             builder=builder)
    back = [read_rig_frame(tmp / "bins" / f"sphere_images_{i + 1}.bin") for i in range(n_bin)]
    n_sph = load_rawlog.main([str(log), "--out", str(tmp / "rl")] + calib, builder=builder)
    return {"n_bin": n_bin, "n_sphere": n_sph, "back": back, "out": tmp / "rl",
            "exported": sorted(p.name for p in (tmp / "rl").iterdir())}


def check_rawlog(got: dict, raws: list, what: str) -> None:
    depth = [np.array_equal(b.depth_mm, r.depth_mm) for b, r in zip(got["back"], raws)]
    gray = [bool(np.all(b.rgb[..., 0] == b.rgb[..., 1]) and np.all(b.rgb[..., 1] == b.rgb[..., 2]))
            for b in got["back"]]
    sizes = [(got["out"] / n).stat().st_size for n in got["exported"]]
    print(f"{what}: --to-bin wrote {got['n_bin']} captures, depth equal {depth}, gray replicated "
          f"to 3 channels {gray}; the sphere export rendered {got['n_sphere']}: "
          f"{got['exported']}")
    if got["n_bin"] != len(raws) or not all(depth) or not all(gray) or got["n_sphere"] != len(raws):
        raise AssertionError(f"{what}: the rawlog round trip fails")
    if len(got["exported"]) < 2 * len(raws) or min(sizes) == 0:
        raise AssertionError(f"{what}: the sphere export is empty")


def run_stereo(builder, raws: list, tmp: Path) -> dict:
    """Each capture's refined sphere depth written as a depth-only stereo
    frame and read back; both read-back spheres tracked through
    `TrackerBase.make_state_from_sphere` (the gray of the built sphere, the
    depth of the file) and aligned (photo + depth)."""
    from rgbd360_tpu_torch.io.stereo import read_stereo_frame, write_stereo_depth

    b = refined_builder(builder)
    tracker = FrameToFrameOdometry(b)
    states, equal = [], []
    for i, raw in enumerate(raws):
        sphere = b.build(RigFrame.from_raw(raw, b.sensor.device))
        depth = sphere.sphere_depth.cpu().numpy()
        write_stereo_depth(tmp / f"stereo_{i}.bin", depth)
        frame = read_stereo_frame(tmp / f"stereo_{i}.bin")
        equal.append(frame.rgb is None and np.array_equal(frame.depth, depth))
        _reset_counts()
        states.append(tracker.make_state_from_sphere(
            sphere.sphere_gray, torch.as_tensor(frame.depth, device=b.sensor.device)))
        launches = _counts()
    res = tracker.aligner.align(states[1].pyramid, states[0].pyramid)
    return {"equal": equal, "launches": launches, "pose": res.pose.cpu().numpy(),
            "planes": int(states[0].planes.valid.sum())}


def check_stereo(got: dict, what: str, launches: bool = True) -> None:
    """`run_stereo`'s round trip and alignment; with `launches` (on the
    card), one state's pyramid is 1 K1 + 4 K2 launches."""
    step = float(got["pose"][0, 3])
    print(f"{what}: depth read back equal {got['equal']}; {got['planes']} planes from the "
          f"sphere; the pair's axial step {step:.5f} m")
    if launches:
        check_app_launches(got["launches"], 1, f"{what}: one state's pyramid", solves=False)
    if not all(got["equal"]) or not np.isfinite(got["pose"]).all() or abs(step - STEP_M) > STEP_TOL_M:
        raise AssertionError(f"{what}: the stereo round trip or its tracking fails")


def run_calibrate(paths: dict, tmp: Path, builder, calib: list, rig,
                  golden_cp: np.ndarray) -> dict:
    """The `calibrate` sub-commands as phase m runs them (see
    `torch_port_golden.calibrate_jax`) on the rig `rig`, with `builder`
    (None: the app's own from `--calib`), plus `solve` and `pair` on the
    golden's own control planes `golden_cp` (rows as `cal_cp`).  `calib`
    is `--calib DIR --no-intrinsics` and any further flags (`--device`),
    which every sub-command but `tof` also takes."""
    from rgbd360_tpu_torch.apps import calibrate

    cp = str(tmp / "cp.txt")
    pair = [str(v) for v in CAL_PAIR]
    write_perturbed_calibration(tmp / "pert", rig)
    ins = write_tof_laser_inputs(tmp / "extras")
    pert = ["--calib", str(tmp / "pert"), "--no-intrinsics"] + calib[3:]
    run = lambda argv: calibrate.main(argv, builder=builder)  # noqa: E731
    walls, out = {}, {}

    def timed(name, argv):
        t0 = time.perf_counter()
        res = run(argv)
        walls[name] = time.perf_counter() - t0
        return res

    timed("collect", ["collect", str(paths["loop"]), "--out", cp] + calib)
    out["cp"] = np.loadtxt(cp)
    out["solve"] = timed("solve", ["solve", cp, "--out", str(tmp / "rt")] + pert)
    out["pair"] = timed("pair", ["pair", cp, "--sensors", *pair] + calib)
    out["eval"] = timed("eval", ["eval", cp] + calib)
    out["fim"] = timed("fim", ["fim", cp, "--sensors", *pair, "--out", str(tmp / "fim.csv")] + calib)
    out["online"] = timed("online", ["online", str(paths["loop"]), "--sensors", *pair,
                                     "--threshold-conditioning", "100000"] + calib)
    out["tof"] = timed("tof", ["tof", str(ins["tof"]), "--out", str(tmp / "tof.txt")] + calib[3:])
    out["laser"] = timed("laser", ["laser", str(ins["laser"]), "--planes", str(ins["planes"]),
                                   "--guess", str(ins["guess"])] + calib)
    walk0 = sorted(paths["walk"].glob("sphere_images_*.bin"))[0]
    out["viz"] = timed("viz", ["viz", str(walk0), "--out", str(tmp / "viz")] + calib)
    out["viz_files"] = {p.name: p.stat().st_size for p in (tmp / "viz").iterdir()}
    np.savetxt(tmp / "golden_cp.txt", golden_cp)
    out["solve_golden_cp"] = run(["solve", str(tmp / "golden_cp.txt")] + pert)
    out["pair_golden_cp"] = run(["pair", str(tmp / "golden_cp.txt"), "--sensors", *pair] + calib)
    out["walls"] = walls
    return out


def check_viz(files: dict, what: str) -> None:
    print(f"{what}: {files}")
    if sorted(files) != ["rig_by_sensor.ply", "stitch_seams.png"] or min(files.values()) <= 1000:
        raise AssertionError(f"{what}: files missing or empty")


def check_calibrate(got: dict, golden: dict, rig, what: str, gate, rig_truth: bool = True) -> None:
    """`run_calibrate`'s results against the golden (see the tolerances
    above), the laser and ToF extrinsics against their truth, and with
    `rig_truth` (at full size) the solved rig against the true one."""
    gate(check_control_planes, got["cp"], golden["cal_cp"], f"{what} collect")
    true_rt = synthetic.calibration(rig).rt.astype(np.float64)
    gate(check_rig, got["solve_golden_cp"], golden["cal_solve_rt"], CAL_SAME_TOL,
         f"{what} solve on the golden's control planes vs the golden's")
    gate(check_rig, got["pair_golden_cp"], golden["cal_pair_rt"], CAL_SAME_TOL,
         f"{what} pair on the golden's control planes vs the golden's")
    gate(check_rig, got["solve"], golden["cal_solve_rt"], CAL_OWN_TOL,
         f"{what} solve vs the golden's")
    gate(check_rig, got["pair"], golden["cal_pair_rt"], CAL_OWN_TOL, f"{what} pair vs the golden's")
    gate(check_eval, got["eval"], golden["cal_eval"], f"{what} eval")
    gate(check_fim, got["fim"], golden["cal_fim"], f"{what} fim")
    gate(check_rig, got["online"], golden["cal_online_rt"], CAL_OWN_TOL,
         f"{what} online --sensors {CAL_PAIR} vs the golden's", True)
    gate(check_rig, got["tof"], golden["cal_tof_rt"], TOF_TOL, f"{what} tof vs the golden's")
    gate(check_rig, got["laser"], golden["cal_laser_rt"], CAL_SAME_TOL,
         f"{what} laser vs the golden's")
    gate(check_viz, got["viz_files"], f"{what} viz")
    gate(check_rig, got["laser"], se3_exp_np(LASER_RT), LASER_TRUTH, f"{what} laser vs the truth")
    gate(check_rig, got["tof"], se3_exp_np(TOF_RT), TOF_TRUTH, f"{what} tof vs the truth")
    ref_gap = _relative_gaps(golden["cal_solve_rt"], true_rt)
    print(f"{what} solve: the golden's own gap to the true rig {ref_gap[0]:.3e} m, "
          f"{ref_gap[1]:.3e} rad")
    if rig_truth:
        gate(check_rig, got["solve"], true_rt, (CAL_TRUTH_M, CAL_TRUTH_RAD),
             f"{what} solve vs the true rig (sensor-0 relative)", True)


def run_labelize(paths: dict, tmp: Path, builder, calib: list) -> dict:
    from rgbd360_tpu_torch.apps import labelize

    store, labels = str(tmp / "store.json"), tmp / "labels.json"
    labels.write_text(json.dumps(LABELS))
    walk = str(paths["walk"])
    labelize.main(["apply", walk, "--frame", str(LABEL_FRAME), "--labels", str(labels),
                   "--store", store] + calib, builder=builder)
    labelize.main(["propagate", walk, "--store", store] + calib, builder=builder)
    return labelize.main(["stats", "--store", store])


def run_view(paths: dict, tmp: Path, builder, calib: list, cfg) -> dict:
    """`view_frame` on walk capture 0 with `--planes --cloud`, its .pcd
    cloud with the paired .pbmap, and `--sequence --video` over the walk,
    with `builder` (None: the app's own from `--calib`; a builder of the
    same calibration at `cfg` then segments the frame again for the PbMap
    round trip)."""
    from rgbd360_tpu_torch.apps import view_frame

    walk0 = sorted(paths["walk"].glob("sphere_images_*.bin"))[0]
    out = tmp / "view"
    f, = view_frame.main([str(walk0), "--out", str(out), "--planes", "--cloud"] + calib,
                         builder=builder)
    seg = builder or FrameBuilder(load_calibration(paths["calib"] / "Extrinsics", None,
                                                   rig=cfg.rig), cfg, device=f.sphere_depth.device)
    planes = seg.segment_planes(f)
    pano = view_frame.main([str(out / f"{walk0.stem}_cloud.pcd"), "--out", str(tmp / "pano")]
                           + calib)
    frames = view_frame.main([str(paths["walk"]), "--out", str(tmp / "seq"), "--sequence",
                              "--video"] + calib, builder=builder)
    return {"out": out, "stem": walk0.stem, "planes": planes, "pano_px": int((pano > 0).any(-1).sum()),
            "frames": len(frames), "gif": tmp / "seq" / "sequence.gif",
            "shape": tuple(f.sphere_depth.shape)}


def check_view(got: dict, what: str) -> None:
    stem = got["stem"]
    check_app_files(got["out"], [f"{stem}_{s}" for s in ("rgb.png", "depth.png", "planes.png",
                                                          "planes.pbmap", "cloud.ply",
                                                          "cloud.pcd")], what)
    check_pbmap_roundtrip(got["out"] / f"{stem}_planes.pbmap", got["planes"], what)
    print(f"{what}: the .pcd panorama covers {got['pano_px']} pixels")
    if got["pano_px"] == 0:
        raise AssertionError(f"{what}: the .pcd panorama is empty")
    check_gif(got["gif"], got["frames"], got["shape"], f"{what} --sequence --video")


def check_extras_phase(smi: str) -> None:
    """Phase m: the extras on the card at full size, against
    `data/extras_golden.npz`."""
    import tempfile

    from rgbd360_tpu_torch.apps import odometry
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame

    failed: list = []
    gate = _gate_collector(failed)
    golden = dict(np.load(EXTRAS_GOLDEN))
    cfg = synthetic.config()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        paths = synthetic.write_app_inputs(tmp)
        walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                      key=lambda p: int(p.stem.rsplit("_", 1)[1]))
        raws = [read_rig_frame(p) for p in walk]
        calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
        print(f"extras set-up (calibration directory, loop and walk capture files): "
              f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        cal = extras_calibration(cfg)
        own = FrameBuilder(cal, cfg)
        ref = FrameBuilder(cal, cfg)
        load_reference_maps(ref)
        t0 = time.perf_counter()
        gate(check_refined_sample, ref, raws[0], golden, "extras: refined stitch (reference maps)")
        gate(check_octagon, octagon_errors(own, raws[0]), golden, "extras: refined stitch")
        walls["refined stitch checks"] = time.perf_counter() - t0
        del ref

        # the plain app first, then the refined one, each `process` timed
        # (after the first frame) in this one call
        frame_ms = {}
        for name, flag in (("odometry", []), ("odometry --parallax-refine", ["--parallax-refine"])):
            _reset_counts()
            t0 = time.perf_counter()
            with timed_process(FrameToFrameOdometry) as ms:
                traj = odometry.main([str(paths["walk"])] + calib + flag)
            walls[name] = time.perf_counter() - t0
            frame_ms[name] = statistics.median(ms[1:])
            gate(check_app_launches, _counts(), len(walk), f"extras: {name}")
        gate(check_refined_steps, traj, golden, "extras: odometry --parallax-refine")
        print(f"extras: odometry `process` per frame after the first (median of "
              f"{len(walk) - 1}): plain {frame_ms['odometry']:.1f} ms, --parallax-refine "
              f"{frame_ms['odometry --parallax-refine']:.1f} ms, on {smi}")

        t0 = time.perf_counter()
        got = run_calibrate(paths, tmp, None, calib, cfg.rig, golden["cal_cp"])
        walls["calibrate (9 sub-commands)"] = time.perf_counter() - t0
        print(f"extras: calibrate walls (s) " + json.dumps(
            {k: round(v, 3) for k, v in got["walls"].items()}) + f", on {smi}")
        check_calibrate(got, golden, cfg.rig, "extras: calibrate", gate)

        t0 = time.perf_counter()
        rl = run_rawlog(raws[:2], tmp, None, calib)
        walls["load_rawlog (--to-bin and export)"] = time.perf_counter() - t0
        gate(check_rawlog, rl, raws[:2], "extras: load_rawlog")

        t0 = time.perf_counter()
        view = run_view(paths, tmp, None, calib, cfg)
        walls["view_frame (3 runs)"] = time.perf_counter() - t0
        gate(check_view, view, "extras: view_frame")

        t0 = time.perf_counter()
        stats = run_labelize(paths, tmp, None, calib)
        walls["labelize (apply, propagate, stats)"] = time.perf_counter() - t0
        gate(check_labels, stats, golden, "extras: labelize")

        t0 = time.perf_counter()
        gate(check_stereo, run_stereo(own, raws[:2], tmp), "extras: stereo")
        walls["stereo"] = time.perf_counter() - t0
        gate(check_ransac, golden, own.sensor.device, "extras: ransac")
        phase_s = time.perf_counter() - t_phase
        peak = torch.cuda.max_memory_allocated() / 2**20
    for name, wall in walls.items():
        print(f"extras: {name} {wall:.2f} s, on {smi}")
    print(f"extras: phase m {phase_s:.1f} s after its set-up; peak device memory {peak:.1f} MiB, "
          f"on {smi}")
    if failed:
        raise AssertionError(f"phase m: {len(failed)} gates failed: " + " | ".join(failed))


# ------------------------------------------------------------- phase n

ENTRY_GOLDEN = DATA / "entry_golden.npz"
# The sharded tracker against the synchronous single-device run: the
# reference's own bound (`tests/test_parallel.py`, its dryrun's 0.01 m is
# looser): the sharded run solves the graph with distributed LM-PCG where
# the single one solves it with dense LM, agreeing to the solvers'
# tolerance, not bit for bit.  Measured on an H100 (worlds 1 and 2):
# 2.9e-4 m.  Not tightened: the tracked solves those poses seed are
# multi-stable at the centimetre (KF_TOL_M's note), so a tighter bound
# would gate their seed sensitivity, not the sharding.
SHARDED_TOL_M = 5e-3
# The sharded stages against their single-device counterparts.  The
# reference's own bounds (`tests/test_parallel.py`) are chi2 0.05 relative
# and poses 5e-3 for the pose graph, 1e-5 for planar BA; measured on an
# H100 (2 gloo ranks): chi2 equal, poses 2.2e-6 (dense LM) and 0 (LM-PCG),
# planar BA 3.6e-7.  So the pose graph is held to 1e-4 in both.
STAGE_CHI2_RTOL, STAGE_POSE_TOL, STAGE_BA_TOL = 1e-4, 1e-4, 1e-5
# A sweep of a block of pairs against the sweep of all of them: the same
# per-pair math in batched products of another batch size.
PAIR_SWEEP_RTOL = 1e-5
# `entry()` against the reference's at 320x1920: test_entry_forward_twin's
# bounds (pose, Hessian relative to its norm, error relative).
ENTRY_TOL = (1e-4, 1e-3, 1e-3)
RANKS_TIMEOUT_S = 600  # for a whole group of spawned ranks
SCAN_QUERY = 5
_PHASE_I: dict = {}  # phase i's captures and synchronous run, for phase n


def run_sharded_keyframe(slam, raws, gt, mesh) -> dict:
    """`run_keyframe` on a rank: the record, `process_ms`, the pending
    events after each frame, the collectives each frame made, and whether
    every rank agrees on the trajectory and on the event schedule."""
    from rgbd360_tpu_torch.parallel import multihost
    from rgbd360_tpu_torch.parallel.sharded import COLLECTIVES

    ms, pending, coll = [], [], []
    for raw in raws:
        c0 = sum(COLLECTIVES.values())
        t0 = time.perf_counter()
        slam.process(raw)
        if slam.device.type == "cuda":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        pending.append(len(slam._pending))
        coll.append(sum(COLLECTIVES.values()) - c0)
    slam.flush()
    out = keyframe_record(slam, gt)
    out.update(process_ms=np.array(ms), pending_after=np.array(pending),
               collectives=np.array(coll), left_pending=len(slam._pending),
               deterministic=slam._deterministic_polls)
    out["agree_trajectory"] = multihost.all_hosts_agree(float(out["trajectory"].sum()), mesh)
    out["agree_schedule"] = multihost.all_hosts_agree(float(np.sum(pending)), mesh)
    return out


def _load_raws(path: str) -> list:
    with np.load(path) as f:
        rgb, depth = f["rgb"], f["depth"]
    return [RawRigFrame(rgb=a, depth_mm=b) for a, b in zip(rgb, depth)]


def sharded_tracker_rank(mesh, raws_path: str, sub: int, levels: int, modes: tuple) -> dict:
    """One rank of the sharded tracker: `KeyframeSLAM(mesh=)` over the
    loop's captures, once per event mode in `modes` ("sync", "async"), on
    the rank's device; each run's record and kernel launches, and the
    rank's peak memory.  With "async" in a world of more than one, rank 0
    also runs the single-device tracker (no mesh) with deferred events:
    in this world it polls on the same deterministic cadence (the
    reference's TRACKER_WORKER compares the two so), so it is what the
    sharded deferred run is held to ("async_single")."""
    cfg = synthetic.config(sub, levels)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device=mesh.device)
    raws = _load_raws(raws_path)
    gt = synthetic.loop_poses(len(raws))
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {}
    for mode in modes:
        slam = KeyframeSLAM(builder, keyframe_config(cfg, mode == "async"), mesh=mesh)
        _reset_counts()
        out[mode] = run_sharded_keyframe(slam, raws, gt, mesh)
        out[mode]["launches"] = _counts()
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    if "async" in modes and mesh.size > 1 and mesh.rank == 0:
        single = KeyframeSLAM(builder, keyframe_config(cfg, True))
        out["async_single"] = run_keyframe(single, raws, gt)
        out["async_single"].update(deterministic=single._deterministic_polls,
                                   left_pending=len(single._pending))
    return out


def _walk_pairs(builder, n_pairs: int, sub: int):
    """Level-0 inputs of the walk's first `n_pairs` consecutive pairs: the
    source gray and depth (B, H, W), the targets' packs (B, H, W, 6) and a
    seeded small pose per pair."""
    frames = [RigFrame.from_raw(raw, device=builder.sensor.device)
              for raw in synthetic_raws(n_pairs + 1, sub)]
    pyrs = [builder.build_with_pyramid(f)[1] for f in frames]
    dev = builder.sensor.device
    src_g = torch.stack([p.gray[0] for p in pyrs[1:]])
    src_d = torch.stack([p.depth[0] for p in pyrs[1:]])
    pack = torch.stack([D._pack_target({k: getattr(p, k)[0] for k in D._CHANNELS})
                        for p in pyrs[:-1]])
    twists = np.random.default_rng(11).normal(0, 0.01, (n_pairs, 6)).astype(np.float32)
    twists[:, 0] += STEP_M
    return src_g, src_d, pack, se3.se3_exp(torch.from_numpy(twists).to(dev))


BA_ITERS = 12  # the reference's sharded planar BA test


def box_plane_ba_problem(device, n_kf: int = 8, noise: float = 0.003, perturb: float = 0.05,
                         seed: int = 2):
    """The reference's sharded planar BA test problem (`tests/test_plane_ba.py`
    `_make_problem(n_kf=8, noise=0.003, perturb=0.05, seed=2)`, the same
    draws): a 6x8x3 m box room's six planes seen from a walk of `n_kf`
    keyframes with noisy observations, the poses and planes perturbed."""
    from rgbd360_tpu_torch.slam.plane_ba import PlaneBAProblem, predict_plane

    rng = np.random.default_rng(seed)
    planes_gt = np.array([[1, 0, 0, 3.0], [-1, 0, 0, 3.0], [0, 1, 0, 1.5], [0, -1, 0, 1.5],
                          [0, 0, 1, 4.0], [0, 0, -1, 4.0]], np.float32)

    def exp(xi):
        return se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()

    gt = [np.eye(4)]
    for _ in range(n_kf - 1):
        gt.append(gt[-1] @ exp([0.25, 0.02, 0.1, 0.01, 0.06, 0.0]))
    gt = np.stack(gt).astype(np.float32)
    obs_kf, obs_pl, obs = [], [], []
    for i in range(n_kf):
        for k in range(len(planes_gt)):
            pred = predict_plane(torch.from_numpy(gt[i]), torch.from_numpy(planes_gt[k])).numpy()
            pred = pred + rng.normal(0, noise, 4).astype(np.float32)
            pred[:3] /= np.linalg.norm(pred[:3])
            obs_kf.append(i)
            obs_pl.append(k)
            obs.append(pred)
    poses0 = np.stack([gt[i] @ exp(rng.normal(0, perturb, 6)) for i in range(n_kf)]
                      ).astype(np.float32)
    poses0[0] = gt[0]
    planes0 = planes_gt + rng.normal(0, perturb, planes_gt.shape).astype(np.float32)
    planes0[:, :3] /= np.linalg.norm(planes0[:, :3], axis=1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PlaneBAProblem(poses=t(poses0), planes=t(planes0), obs_kf=t(obs_kf, torch.int64),
                          obs_pl=t(obs_pl, torch.int64), obs=t(np.stack(obs)),
                          w=t(np.full(len(obs), 100.0)))


def _gap(a, b) -> float:
    a, b = (x.detach().cpu().double() if isinstance(x, torch.Tensor) else
            torch.as_tensor(np.asarray(x, np.float64)) for x in (a, b))
    return float((a - b).abs().max())


def sharded_stages_rank(mesh, raws_path: str, sub: int, levels: int, seq: dict) -> dict:
    """One rank of the stage checks: each sharded stage at the phase's size
    on this rank's mesh beside its single-device counterpart on the same
    inputs, the times of both, and (`seq`) `register_sequence --sharded`
    and `GraphOptimizerBackend("sharded")`."""
    from rgbd360_tpu_torch.apps import register_sequence
    from rgbd360_tpu_torch.parallel import sharded as S
    from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, match_against_keyframes
    from rgbd360_tpu_torch.slam.graph_backend import GraphOptimizerBackend
    from rgbd360_tpu_torch.slam.plane_ba import optimize_plane_ba

    cfg = synthetic.config(sub, levels)
    dev = mesh.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device=dev)
    out = {}

    def timed(name, fn):
        sync()
        c0 = sum(S.COLLECTIVES.values())
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        out[f"{name}_collectives"] = sum(S.COLLECTIVES.values()) - c0
        return res

    # the pair sweep on 4 level-0 pairs of the walk (each timed after a
    # first call)
    src_g, src_d, pack, poses = _walk_pairs(builder, 4, sub)
    gray, pts, valid = D._flat_points(src_d, src_g, cfg.dense)
    pair_sharded = lambda: S.sharded_pair_align(  # noqa: E731
        mesh, src_g, src_d, pack, poses, cfg.dense, D.PHOTO_DEPTH)
    pair_single = lambda: D._hess_grad_packed(  # noqa: E731
        gray, pts, valid, pack, poses, cfg.dense, D.PHOTO_DEPTH)
    pair_sharded(), pair_single()
    sh = timed("pair_sharded", pair_sharded)
    h, g, st = timed("pair_single", pair_single)
    out["pair"] = [_gap(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(sh, (h, g, st["mean_err"]))]
    del src_g, src_d, pack, gray, pts, valid

    # the scan and the relocaliser over a filled capacity-64 map
    raws = _load_raws(raws_path)
    gt = synthetic.loop_poses(len(raws))
    tracker = KeyframeSLAM(builder, cfg)
    states = [tracker.make_state(r) for r in raws]
    m = filled_map(cfg, states, gt, SCAN_KEYFRAMES, dev)
    gate = torch.arange(m.kf_capacity, device=dev) < m.n_kf
    q = states[SCAN_QUERY].planes
    scan_sharded = lambda: fetch(S.sharded_plane_scan(  # noqa: E731
        mesh, m.planes, q, gate, cfg.matcher, PLANAR_3DOF))
    scan_single = lambda: fetch(match_against_keyframes(m.planes, q, gate, cfg.matcher))  # noqa: E731
    scan_sharded(), scan_single()
    scan = timed("scan_sharded", scan_sharded)
    single = timed("scan_single", scan_single)
    out["scan_equal"] = [bool(torch.equal(a, b)) for a, b in zip(scan, single)]
    out["scan_gaps"] = [_gap(a, b) for a, b in zip(scan, single)]
    pose_q = m.opt_poses[SCAN_QUERY].cpu().numpy()
    lc = [fetch(LoopCloser(cfg, mesh=mm).scan_dispatch(m, q, pose_q, int(m.n_kf) - 1))
          for mm in (mesh, None)]
    out["lc_candidates"] = [[x.numpy() for x in c[:2]] for c in lc]
    rel = [Relocalizer(cfg, mesh=mm).relocalize(m, q) for mm in (mesh, None)]
    out["reloc"] = [(r.success, r.kf, r.n_matches, r.pose) for r in rel]

    # the pose-graph solvers on phase i's capacity-256 ring (DCS for LM-PCG),
    # its edge slots shuffled (seeded) so that every rank's block holds live
    # edges (in slot order the live ones fill the first half)
    leaves, loop_mask, _ = synthetic.ring_graph(200, 256, 512)
    perm = np.random.default_rng(3).permutation(len(loop_mask))
    leaves = leaves[:2] + [a[perm] for a in leaves[2:]]
    loop_mask = loop_mask[perm]
    ring = convert.pose_graph_from_numpy(leaves, dev)
    lm = torch.from_numpy(loop_mask).to(dev)
    cg: list = []
    for name, shard, one in (
        ("graph", lambda: S.distributed_pose_graph(mesh, ring, 10),
         lambda: graph_ops.optimize_pose_graph(ring, 10)),
        ("pcg", lambda: S.distributed_pose_graph_pcg(mesh, ring, 10, loop_mask=lm, cg_counts=cg),
         lambda: graph_ops.optimize_pose_graph_pcg(ring, 10, loop_mask=lm)),
    ):
        p_s, c_s, it_s = timed(f"{name}_sharded", shard)
        p_1, c_1, it_1 = timed(f"{name}_single", one)
        out[name] = dict(chi2=float(c_s), chi2_single=float(c_1), iters=it_s, iters_single=it_1,
                         gaps=_pose_gaps(p_s.cpu().numpy(), p_1.cpu().numpy()))
    out["pcg"]["cg"] = cg

    # planar BA on the reference's own sharded test problem
    prob = box_plane_ba_problem(dev)
    b_s = timed("ba_sharded", lambda: S.distributed_plane_ba(mesh, prob, BA_ITERS))
    b_1 = timed("ba_single", lambda: optimize_plane_ba(prob, BA_ITERS))
    out["ba"] = dict(obs=int(prob.obs.shape[0]), iters=(b_s[3], b_1[3]),
                     chi2=(float(b_s[2]), float(b_1[2])),
                     gaps=(_gap(b_s[0], b_1[0]), _gap(b_s[1], b_1[1])))

    # GraphOptimizerBackend("sharded") against the dense backend, ring 64
    leaves, _, _ = synthetic.ring_graph(48, 64, 512)
    res = []
    for backend, mm in (("sharded", mesh), ("dense", None)):
        gb = GraphOptimizerBackend(64, 512, backend=backend, mesh=mm, device=dev)
        for i in np.flatnonzero(leaves[1]):
            gb.add_vertex(leaves[0][i])
        for e in np.flatnonzero(leaves[5]):
            gb.add_edge(int(leaves[2][e][0]), int(leaves[2][e][1]), leaves[3][e], leaves[4][e])
        chi2, iters = gb.optimize()
        res.append((chi2, iters, gb.get_poses()))
    out["backend"] = dict(chi2=(res[0][0], res[1][0]), iters=(res[0][1], res[1][1]),
                          gaps=_pose_gaps(res[0][2], res[1][2]))

    # register_sequence --sharded over the walk's files, PbMap seeded as
    # phase l, its builder the one `--calib --no-intrinsics` gives
    app_builder = FrameBuilder(load_calibration(Path(seq["calib"]) / "Extrinsics", None,
                                                rig=cfg.rig), cfg, device=dev)
    with recorded_registration(seq["seeds"]):
        traj, labels = timed("register_sequence_sharded", lambda: register_sequence.main(
            [seq["walk"], "--calib", seq["calib"], "--no-intrinsics", "--window",
             str(REG_WINDOW), "--sharded"], builder=app_builder))
    out["seq"] = dict(traj=traj, labels=labels)
    out["collectives_total"] = dict(S.COLLECTIVES)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else 0.0
    return out


def check_sharded_run(got: dict, single: dict, golden: dict, what: str, deferred: bool) -> None:
    """A sharded tracker run against the single-device run of the same loop
    with the same event schedule (the synchronous one, or with deferred
    events the one on the same deterministic poll cadence) and against the
    golden: the same decisions, both trajectories within SHARDED_TOL_M of
    the single run's and within KF_TOL_M / KF_TOL_RAD of the golden's (a
    deferred run's optimized trajectory only: the golden's events are
    synchronous, and a deferred run samples each frame before or after its
    keyframe's correction lands); nothing pending; every rank agreeing."""
    check_keyframe_decisions(got, single, f"{what} vs the single-device run")
    if got["left_pending"]:
        raise AssertionError(f"{what}: {got['left_pending']} events pending after flush()")
    problems = []
    for k in ("trajectory", "optimized_trajectory"):
        dt, dr = _pose_gaps(got[k], single[k])
        print(f"{what}: {k} {dt:.3e} m, {dr:.3e} rad from the single-device run's "
              f"(tol {SHARDED_TOL_M} m)")
        if dt > SHARDED_TOL_M:
            problems.append(f"{k} {dt:.3e} m from the single-device run's")
        if not deferred or k == "optimized_trajectory":
            gt_, gr_ = _pose_gaps(got[k], golden[k])
            print(f"{what}: {k} {gt_:.3e} m, {gr_:.3e} rad from the golden's "
                  f"(tol {KF_TOL_M}, {KF_TOL_RAD})")
            if gt_ > KF_TOL_M or gr_ > KF_TOL_RAD:
                problems.append(f"{k} leaves the golden's tolerance")
    if not (got["agree_trajectory"] and got["agree_schedule"]):
        problems.append("the ranks disagree on the trajectory or the event schedule")
    if problems:
        raise AssertionError(f"{what}: " + "; ".join(problems))


def check_deterministic_single(det: dict, syn: dict) -> None:
    """The single-device run with deferred events on the deterministic
    poll cadence against the synchronous run: its events run a fixed
    number of poll sites after their keyframes, on the map and the
    tracker's state of then, so its decisions are printed beside the
    synchronous run's (phase i holds the readiness-polled deferred run to
    them); nothing pending, and the optimized trajectory within
    ASYNC_SYNC_TOL_M of the synchronous one's (the reference's
    deferred-vs-synchronous bound)."""
    what = "single-device run, deferred events on the deterministic cadence"
    if not det["deterministic"]:
        raise AssertionError(f"{what}: the poll schedule is not the deterministic one")
    if det["left_pending"]:
        raise AssertionError(f"{what}: {det['left_pending']} events pending after flush()")
    extra = {tuple(e) for e in det["edges"].tolist()} ^ {tuple(e) for e in syn["edges"].tolist()}
    print(f"{what}: {describe_decisions(det)}; edges (i, j, is_lc) not in both it and the "
          f"synchronous run {sorted(extra)}")
    d = np.linalg.norm(det["optimized_trajectory"][:, :3, 3]
                       - syn["optimized_trajectory"][:, :3, 3], axis=1).max()
    print(f"{what}: optimized trajectory {d:.3e} m from the synchronous run's "
          f"(tol {ASYNC_SYNC_TOL_M})")
    if d > ASYNC_SYNC_TOL_M:
        raise AssertionError(f"{what}: the optimized trajectory leaves the synchronous one's")


def _frame_ms(run: dict) -> tuple[float, float]:
    kf = run["keyframe"].copy()
    kf[0] = False
    tracked = ~kf
    tracked[0] = False
    ms = run["process_ms"]
    return statistics.median(ms[tracked]), statistics.median(ms[kf])


def check_stages(st: dict) -> None:
    """The sharded stages of a rank against their single-device
    counterparts (see the module constants for the bounds)."""
    problems = []
    print(f"sharded_pair_align, 4 level-0 walk pairs: Hessian, gradient, error "
          f"{['%.3e' % g for g in st['pair']]} of their scale from the unsharded sweep's "
          f"(tol {PAIR_SWEEP_RTOL}); {st['pair_sharded_ms']:.3f} ms sharded, "
          f"{st['pair_single_ms']:.3f} ms single")
    if max(st["pair"]) > PAIR_SWEEP_RTOL:
        problems.append("the sharded pair sweep leaves the unsharded one")
    print(f"sharded_plane_scan over {SCAN_KEYFRAMES} keyframes: bit-equal per output "
          f"{st['scan_equal']} (gaps {['%.3e' % g for g in st['scan_gaps']]}), "
          f"{st['scan_sharded_ms']:.3f} ms sharded ({st['scan_sharded_collectives']} collective), "
          f"{st['scan_single_ms']:.3f} ms single; LoopCloser candidates sharded "
          f"{st['lc_candidates'][0][0].tolist()} single {st['lc_candidates'][1][0].tolist()}; "
          f"Relocalizer keyframe {st['reloc'][0][1]} / {st['reloc'][1][1]}")
    if not (st["scan_equal"][0] and st["scan_equal"][4]) or max(st["scan_gaps"]) > 1e-5:
        problems.append("the sharded scan's counts or poses differ from the single one's")
    if not all(np.array_equal(a, b) for a, b in zip(*st["lc_candidates"])):
        problems.append("the sharded loop closer picks other candidates")
    (s1, k1, n1, p1), (s2, k2, n2, p2) = st["reloc"]
    if (s1, k1, n1) != (s2, k2, n2) or np.abs(p1 - p2).max() > 1e-5 or not s1:
        problems.append("the sharded relocaliser picks another keyframe or pose")
    for name, label in (("graph", "distributed_pose_graph vs optimize_pose_graph"),
                        ("pcg", "distributed_pose_graph_pcg vs optimize_pose_graph_pcg (DCS)")):
        r = st[name]
        rel = abs(r["chi2"] - r["chi2_single"]) / max(abs(r["chi2_single"]), 1e-12)
        print(f"{label}, ring at capacity 256: chi2 {r['chi2']:.5f} / {r['chi2_single']:.5f} "
              f"(relative {rel:.3e}, tol {STAGE_CHI2_RTOL}), poses {r['gaps'][0]:.3e} m, "
              f"{r['gaps'][1]:.3e} rad (tol {STAGE_POSE_TOL}), LM {r['iters']} / "
              f"{r['iters_single']}" + (f", CG {r['cg']}" if "cg" in r else "")
              + f"; {st[name + '_sharded_ms']:.1f} ms sharded ({st[name + '_sharded_collectives']}"
              f" collectives), {st[name + '_single_ms']:.1f} ms single")
        if rel > STAGE_CHI2_RTOL or max(r["gaps"]) > STAGE_POSE_TOL:
            problems.append(f"{name} leaves the single-device solve")
    b = st["ba"]
    print(f"distributed_plane_ba vs optimize_plane_ba (the reference test's box room, "
          f"{b['obs']} observations, {BA_ITERS} LM iterations): "
          f"poses {b['gaps'][0]:.3e}, planes {b['gaps'][1]:.3e} (tol {STAGE_BA_TOL}), chi2 "
          f"{b['chi2']}, LM {b['iters']}; {st['ba_sharded_ms']:.1f} ms sharded "
          f"({st['ba_sharded_collectives']} collectives), {st['ba_single_ms']:.1f} ms single")
    if max(b["gaps"]) > STAGE_BA_TOL:
        problems.append("the sharded planar BA leaves the single-device one")
    g = st["backend"]
    print(f"GraphOptimizerBackend sharded vs dense (ring 64): chi2 {g['chi2']}, LM {g['iters']}, "
          f"poses {g['gaps'][0]:.3e} m, {g['gaps'][1]:.3e} rad")
    if max(g["gaps"]) > STAGE_POSE_TOL or g["iters"][0] != g["iters"][1]:
        problems.append("the sharded graph backend leaves the dense one")
    if problems:
        raise AssertionError("sharded stages: " + "; ".join(problems))


def check_entry(smi: str) -> None:
    """`entry()` at 320x1920 on the card against the reference's, with
    exactly 2 K1 + 4 K2 launches (two 3-level pyramids)."""
    from rgbd360_tpu_torch.entry import entry

    golden = np.load(ENTRY_GOLDEN)
    fn, args = entry()
    fn(*args)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = fn(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _counts()
    _require_launches(counts, "entry()")
    dp = np.abs(res.pose.cpu().numpy() - golden["pose"]).max()
    dh = np.abs(res.hessian.cpu().numpy() - golden["hessian"]).max() / np.abs(golden["hessian"]).max()
    de = abs(float(res.error) - float(golden["error"])) / abs(float(golden["error"]))
    print(f"entry() at 320x1920: pose {dp:.3e}, Hessian {dh:.3e} of its norm, error {de:.3e} "
          f"relative from the reference's (tol {ENTRY_TOL}); iterations "
          f"{res.iters.cpu().numpy().tolist()} (reference {golden['iters'].tolist()}); "
          f"{ms:.3f} ms, on {smi}")
    if _pyramid_counts(counts) != {"fused_gradients": 2, "fused_pyr_down": 4}:
        raise AssertionError(f"entry(): two 3-level pyramids are not 2 K1 + 4 K2 launches: {counts}")
    if dp > ENTRY_TOL[0] or dh > ENTRY_TOL[1] or de > ENTRY_TOL[2] or bool(res.ill_posed):
        raise AssertionError("entry() leaves the reference's forward step")


def check_decoder(walk, smi: str) -> None:
    """The native decoder over the walk's files: byte-equal to the Python
    reader, and both readers' ms per file (median of 5 per file)."""
    from rgbd360_tpu_torch.io import native
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame

    native.load()
    ms = {"native": [], "python": []}
    for p in walk:
        a, b = native.read_rig_frame(p), read_rig_frame(p)
        if not (a.rgb.tobytes() == b.rgb.tobytes() and a.depth_mm.tobytes() == b.depth_mm.tobytes()
                and a.timestamp == b.timestamp):
            raise AssertionError(f"the native decoder's {p.name} differs from the Python reader's")
        for name, fn in (("native", native.read_rig_frame), ("python", read_rig_frame)):
            ms[name].append(statistics.median(_host_ms_cpu(lambda: fn(p), 5)))
    print(f"capture decoder over {len(walk)} walk files (8x240x320): byte-equal; ms per file "
          f"native {np.round(ms['native'], 3).tolist()}, Python {np.round(ms['python'], 3).tolist()}"
          f" (medians of 5), on {smi}")


def _host_ms_cpu(fn, reps: int) -> list[float]:
    """Host-clock times of `reps` calls of a host-only function."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def check_sharded_phase(smi: str) -> None:
    """Phase n: the sharded tracker on a world of 1 (NCCL) and of 2 (gloo,
    both ranks on the card), the sharded stages on 2 ranks against their
    single-device counterparts, `register_sequence --sharded`, the entry
    and the multi-rank dry run, and the native decoder."""
    import tempfile

    from rgbd360_tpu_torch.apps import register_sequence
    from rgbd360_tpu_torch.entry import dryrun_multichip
    from rgbd360_tpu_torch.parallel.spawn import run_ranks

    failed: list = []
    gate = _gate_collector(failed)
    t_phase = time.perf_counter()
    golden = dict(np.load(KEYFRAME_GOLDEN))
    sync_golden = {k[len("loop_sync_"):]: v for k, v in golden.items() if k.startswith("loop_sync_")}
    cfg = synthetic.config()
    if "syn" not in _PHASE_I:  # phase n alone: its own synchronous single-device run
        builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
        _PHASE_I["raws"] = loop_raws(LOOP_FRAMES)
        _PHASE_I["syn"] = run_keyframe(KeyframeSLAM(builder, keyframe_config(cfg, False)),
                                       _PHASE_I["raws"], synthetic.loop_poses(LOOP_FRAMES))
        gate(check_keyframe_decisions, _PHASE_I["syn"], sync_golden,
             "synchronous single-device run vs JAX golden")
        del builder
    syn, raws = _PHASE_I["syn"], _PHASE_I["raws"]
    reg_golden = dict(np.load(REGISTRATION_GOLDEN))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raws_path = str(tmp / "loop.npz")
        np.savez(raws_path, rgb=np.stack([r.rgb for r in raws]),
                 depth=np.stack([r.depth_mm for r in raws]))
        paths = synthetic.write_app_inputs(tmp / "apps", loop_frames=0)
        walk = sorted(paths["walk"].glob("sphere_images_*.bin"),
                      key=lambda p: int(p.stem.rsplit("_", 1)[1]))
        seeds = golden_seeds(reg_golden, "seq_pb_poses", "seq_pb_success")
        seq = {"walk": str(paths["walk"]), "calib": str(paths["calib"]), "seeds": seeds}
        print(f"sharded set-up (loop captures to file, calibration and walk files): "
              f"{time.perf_counter() - t_phase:.2f} s")

        # the sharded tracker: a world of 1 on NCCL, a world of 2 on gloo
        runs = {}
        for world, backend, modes in ((1, "nccl", ("sync",)), (2, "gloo", ("sync", "async"))):
            t0 = time.perf_counter()
            runs[world] = run_ranks(sharded_tracker_rank, world, backend, "cuda:0",
                                    args=(raws_path, 1, cfg.dense.pyramid_levels, modes),
                                    timeout=RANKS_TIMEOUT_S)
            print(f"sharded tracker, world {world} ({backend}, {modes}): "
                  f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        det = runs[2][0]["async_single"]
        gate(check_deterministic_single, det, syn)
        for world, ranks in runs.items():
            for mode in ("sync", "async"):
                if mode not in ranks[0]:
                    continue
                what = f"sharded tracker (world {world}, {mode} events)"
                got = ranks[0][mode]
                for r, other in enumerate(ranks[1:], 1):
                    if not np.array_equal(other[mode]["trajectory"], got["trajectory"]):
                        failed.append(f"{what}: rank {r}'s trajectory differs from rank 0's")
                for r, rank in enumerate(ranks):
                    _require_launches(rank[mode]["launches"], f"{what}, rank {r}")
                gate(check_sharded_run, got, det if mode == "async" else syn, sync_golden, what,
                     mode == "async")
                tr, kf = _frame_ms(got)
                kf_frames = got["keyframe"].copy()
                kf_frames[0] = False
                print(f"{what}: process median {tr:.3f} ms per tracked frame, {kf:.3f} ms per "
                      f"keyframe frame; collectives per keyframe frame (its event included, "
                      f"{'on gloo each a host round trip' if world > 1 else 'NCCL, no host sync'})"
                      f" {got['collectives'][kf_frames].tolist()}, per tracked frame "
                      f"{sorted(set(got['collectives'][~kf_frames].tolist()))}; pending events "
                      f"after each frame {got['pending_after'].tolist()}; peak memory per rank "
                      f"{[round(rank['peak_mib'], 1) for rank in ranks]} MiB, on {smi}")
                if mode == "async":
                    if not got["deterministic"]:
                        failed.append(f"{what}: the poll schedule is not the deterministic one")
                    if not (got["pending_after"] > 0).any():
                        failed.append(f"{what}: no event in flight across a frame boundary")
        sy, de = _frame_ms(syn), _frame_ms(det)
        print(f"synchronous single-device run (phase i): {sy[0]:.3f} ms per tracked frame, "
              f"{sy[1]:.3f} ms per keyframe frame; deferred on the deterministic cadence (rank 0 "
              f"of 2, alone on the card): {de[0]:.3f} / {de[1]:.3f} ms, on {smi}")

        # the stages, the apps, on 2 ranks
        t0 = time.perf_counter()
        stages = run_ranks(sharded_stages_rank, 2, "gloo", "cuda:0",
                           args=(raws_path, 1, cfg.dense.pyramid_levels, seq),
                           timeout=RANKS_TIMEOUT_S)
        print(f"sharded stages on 2 ranks: {time.perf_counter() - t0:.1f} s with the ranks' start; "
              f"collectives by kind {stages[0]['collectives_total']}; peak memory per rank "
              f"{[round(s['peak_mib'], 1) for s in stages]} MiB")
        gate(check_stages, stages[0])
        with recorded_registration(seeds):
            traj, labels = register_sequence.main(
                [seq["walk"], "--calib", seq["calib"], "--no-intrinsics", "--window",
                 str(REG_WINDOW)])
        for r, st in enumerate(stages):
            d = np.abs(st["seq"]["traj"] - traj).max()
            print(f"register_sequence --sharded (rank {r} of 2) vs unsharded: trajectory {d:.3e} "
                  f"(tol {SHARDED_TOL_M}), areas {st['seq']['labels'].tolist()} / "
                  f"{labels.tolist()}; {st['register_sequence_sharded_ms']:.1f} ms")
            if d > SHARDED_TOL_M or not np.array_equal(st["seq"]["labels"], labels):
                failed.append(f"register_sequence --sharded (rank {r}) leaves the unsharded run")

        gate(check_entry, smi)
        t0 = time.perf_counter()
        dry = dryrun_multichip(2, "gloo", "cuda:0", timeout=RANKS_TIMEOUT_S)
        print(f"dryrun_multichip(2, gloo, cuda:0): {time.perf_counter() - t0:.1f} s")
        for r, d in enumerate(dry):
            _require_launches(d["launches"], f"dryrun_multichip rank {r}")
        gate(check_decoder, walk, smi)
    print(f"phase n command time {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError(f"phase n: {len(failed)} gates failed: " + " | ".join(failed))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the port.")
    parser.add_argument("--phases", default="bcodefgijklmn",
                        help="the phases to run (a, the build and h always run); a partial "
                             "run prints no result lines")
    phases = parser.parse_args(argv).phases
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.cuda.set_device(0)

    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built from {_build.SRC_DIR} in {time.perf_counter() - t0:.2f} s")
    probe_degenerate_eigh()
    rng = np.random.default_rng(0)
    if "b" in phases:
        k1 = check_k1(rng)
    if "c" in phases:
        k2 = check_k2(rng)
    if "o" in phases:
        neq = check_normal_equations()
    if "d" in phases:
        t0 = time.perf_counter()
        sl = check_slice()
        print(f"phase d took {time.perf_counter() - t0:.1f} s")
    if "e" in phases or "f" in phases:
        t0 = time.perf_counter()
        setup = _synthetic_setup(
            BATCH_FRAMES, batch_dense_config(synthetic.config()), reference_maps=True
        )
        torch.cuda.synchronize()
        print(f"batch set-up (calibration maps, synthetic captures): "
              f"{time.perf_counter() - t0:.2f} s")
    for phase, check in (("e", lambda: check_batch(*setup, smi)),
                         ("f", lambda: check_targets(*setup)),
                         ("g", lambda: check_odometry_phase(smi)),
                         ("i", lambda: check_keyframe_phase(smi)),
                         ("j", lambda: check_apps_phase(smi)),
                         ("k", lambda: check_long_phase(smi)),
                         ("l", lambda: check_registration_phase(smi)),
                         ("m", lambda: check_extras_phase(smi)),
                         ("n", lambda: check_sharded_phase(smi))):
        if phase in phases:
            t0 = time.perf_counter()
            check()
            print(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for job in _DEFERRED_PYRAMIDS + _DEFERRED:
        job()
    print(f"phase h took {time.perf_counter() - t0:.1f} s")
    if set("bcodefgijklmn") - set(phases):
        print(f"partial run (phases {phases}): no result lines")
        return 0

    print(f"fast reciprocal of K1 against IEEE division over its whole range: "
          f"{k1['rcp_mismatches']} mismatches")
    # each kernel at the main path's level-0 launch (one tracked odometry
    # frame): K1 grouped over the frame's 10 stacks with the seam masks, K2
    # over the first level transition (gray + depth); every shape under `shapes`
    keys = ("ms", "warm_ms", "call_ms", "plain_ms", "plain_call_ms", "bound_ms", "bound_by",
            "library_ms", "bytes")

    def entry(name, source, replaces, launches, res, main):
        shapes = [dict(name=r["name"], shape=list(r["shape"]), **{k: r[k] for k in keys})
                  for r in res["rows"] if "ms" in r]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    **{k: res[k] for k in ("max_abs_err", "max_rel_err") if k in res},
                    shape=list(main["shape"]), **{k: main[k] for k in keys}, shapes=shapes)

    print(json.dumps({"card": smi, "pyramid": sl["pyramid"]}))
    print(json.dumps({"kernels": [
        entry("fused_gradients", "rgbd360_tpu_torch/csrc/fused_gradients.cu",
              "rgbd360_tpu/ops/pallas_kernels.py:148", TOTAL_LAUNCHES["fused_gradients"],
              k1, k1["groups"][1]),
        entry("fused_pyr_down", "rgbd360_tpu_torch/csrc/pyr_down.cu",
              "rgbd360_tpu/ops/pallas_kernels.py:90", TOTAL_LAUNCHES["fused_pyr_down"],
              k2, k2["transitions"][(1, *LEVEL_SHAPES[0])]),
        entry("normal_equations", "rgbd360_tpu_torch/csrc/normal_equations.cu",
              "rgbd360_tpu/registration/dense.py:545",
              TOTAL_LAUNCHES["normal_equations"], neq, neq["main"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
