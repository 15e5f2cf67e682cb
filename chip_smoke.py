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
   lower bound), one profiled frame with its host waits and device-to-host
   copies as the profiler sees them, and one profile of each of its stages
   (the bilateral and the connected-component scans alone).
h. the measurements that need `torch.profiler` (the kernels' device times
   of phases b and c, the profiled pyramid of phase d), put off until every
   host-clock timing is taken: once a process has profiled once
   its kernel launches cost more host time (measured on an H100: `process`
   100-119 ms per tracked frame in a fresh process, 129-192 ms after one
   profile), which would be read as the port's.
Phases e and f stitch with the reference builder's maps
(`data/reference_stitch_maps.npz`, see `load_reference_maps`), and each
pose must lie on one of the golden's branches (see `_gate_branches`).

The last two lines are a JSON line of per-kernel results (launch counts
summed over the gated runs of phases d-g, each counted from 0; times,
bytes, bounds and the library call's time at the main path's level-0
shapes, and per shape under `shapes`) and the contract line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
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
from rgbd360_tpu_torch.ops import _build, hopper_kernels as HK, se3
from rgbd360_tpu_torch.ops import segmentation as seg_ops
from rgbd360_tpu_torch.ops.bilateral import bilateral_depth
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.slam.odometry import FrameToFrameOdometry, fetch
from rgbd360_tpu_torch.utils.trace import StageTimer

DATA = Path(__file__).resolve().parent / "rgbd360_tpu_torch" / "data"
GOLDEN = DATA / "smoke_golden.npz"
BATCH_GOLDEN = DATA / "batch_golden.npz"
REFERENCE_MAPS = DATA / "reference_stitch_maps.npz"
ODOMETRY_GOLDEN = DATA / "odometry_golden.npz"
N_FRAMES = 6
BATCH_FRAMES = 5  # keyframe 0 and a batch of 4
YAW_HYPOTHESES = 8
LEVEL_SHAPES = [(320, 1920), (160, 960), (80, 480), (40, 240), (20, 120)]
TRANSITION_SHAPES = LEVEL_SHAPES[:-1]
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
MIN_DEPTH, MAX_DEPTH = 0.3, 20.0  # DenseRegConfig's valid depth range
# The card's peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


TOTAL_LAUNCHES: Counter = Counter()  # over the gated runs of every phase


def _reset_counts() -> None:
    K1.launches = 0
    K2.launches = 0


def _counts() -> dict:
    return {"fused_gradients": K1.launches, "fused_pyr_down": K2.launches}


def _require_launches(counts: dict, phase: str) -> None:
    print(f"{phase}: kernel launches {counts}")
    missing = [k for k, n in counts.items() if n == 0]
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
                    timed: bool = True) -> dict:
    """`kernel()` against `plain()` bit for bit; with `timed`, both (and
    `library()`, one PyTorch call for the same function) timed: per call by
    CUDA events now, device time by the profiler with the L2 cold and warm
    in phase h (the row is filled in then, so `kernel`, `plain` and
    `library` must hold their inputs, not a loop's variables)."""
    got, ref = _flat(kernel()), _flat(plain())
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() if a.numel() else 0.0 for a, b in zip(got, ref))
    if len(got) != len(ref) or not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{name} differs from its plain version at {shape}: "
                             f"max |diff| {err}")
    row = dict(name=name, shape=shape, max_abs_err=err)
    if not timed:
        print(f"{name} {shape}: bit-equal")
        return row
    bound_ms, bound_by = _bound(nbytes, flops)
    row.update(call_ms=_median_ms(kernel), plain_call_ms=_median_ms(plain, reps=10, warmup=2),
               bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    print(f"{name} {shape}: bit-equal; per call {row['call_ms']:.4f} ms, plain "
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


def _gate_branches(what, got: np.ndarray, branches: np.ndarray) -> np.ndarray:
    """Each pose of `got` (n, 4, 4) within the golden tolerance of the
    nearest of the golden's branches (P, n, 4, 4); returns the matched
    branch of each element."""
    matched, worst = [], (0.0, 0.0)
    for i in range(len(got)):
        gaps = [_pose_gaps(got[i : i + 1], b[i : i + 1]) for b in branches]
        j = min(range(len(gaps)),
                key=lambda b: gaps[b][0] / GOLDEN_TOL_M + gaps[b][1] / GOLDEN_TOL_RAD)
        matched.append(j)
        worst = (max(worst[0], gaps[j][0]), max(worst[1], gaps[j][1]))
    to0 = _pose_gaps(got, branches[0])
    spread = max(_pose_gaps(b, branches[0])[0] for b in branches)
    print(f"{what}: nearest golden branches {matched}: max gap {worst[0]:.3e} m "
          f"(tol {GOLDEN_TOL_M}), {worst[1]:.3e} rad (tol {GOLDEN_TOL_RAD}); to the "
          f"unjittered golden {to0[0]:.3e} m, {to0[1]:.3e} rad; the golden's "
          f"{len(branches)} branches spread over {spread:.3e} m")
    if worst[0] > GOLDEN_TOL_M or worst[1] > GOLDEN_TOL_RAD:
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

    pyramid = check_pyramid_stage(builder, frames[0])
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


def check_pyramid_stage(builder, frame) -> dict:
    """One frame's pyramid is 1 K1 launch and 4 K2 launches, and (in phase
    h) a profiled pyramid runs nothing else on the device (no `bmm` pair, no
    seam multiply, no stack copy).  Returns its wall ms; phase h adds its
    device ops and busy ms."""
    sphere = builder.build(frame)
    builder.pyramid(sphere)
    _reset_counts()
    builder.pyramid(sphere)
    counts = _counts()
    levels = builder.config.dense.pyramid_levels
    if counts != {"fused_gradients": 1, "fused_pyr_down": levels - 1}:
        raise AssertionError(f"one pyramid launched {counts}, not 1 K1 and {levels - 1} K2")
    pyr_ms = statistics.median(_host_ms(lambda: builder.pyramid(sphere), reps=30))
    print(f"pyramid stage: launches {counts}; wall {pyr_ms:.3f} ms (median of 30)")
    out = dict(wall_ms=pyr_ms)

    def profiled() -> None:
        # the profiler now and then drops device events: a profile that shows
        # fewer ops than were launched is taken again, and none may show more
        names: list = []
        for _ in range(5):
            wall, busy, ops, _, _ = _profile(lambda: builder.pyramid(sphere), names)
            if ops >= levels:
                break
        foreign = [n for n in names
                   if "fused_gradients_kernel" not in n and "level_down_kernel" not in n]
        if ops != levels or foreign:
            raise AssertionError(f"the pyramid stage launched {levels} kernels and its profile "
                                 f"shows {ops} device ops, {foreign} not K1's or K2's")
        print(f"pyramid stage, profiled: {ops} device ops (all K1's and K2's kernels), device "
              f"busy {busy:.4f} ms, wall {wall:.3f} ms")
        out.update(device_ops=ops, busy_ms=busy)

    _DEFERRED.append(profiled)
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


REGIONS = {"build", "stitch", "cloud", "pyramid", "segment", "register", "align"}


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
    run = track_odometry(builder, raws)
    _require_launches(_counts(), "odometry")
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
    timer = StageTimer(sync=True)
    track_odometry(builder, raws, timer)
    print(f"odometry stages (StageTimer(sync=True), {N_FRAMES} frames):\n{timer.report()}")
    print(f"odometry: PbMap register {1e3 * timer.times['register'] / timer.counts['register']:.3f} "
          f"ms per tracked frame (StageTimer)")

    tracker = FrameToFrameOdometry(builder)
    tracker.process(raws[0])
    syncs = [_count_syncs(lambda r=r: tracker.process(r)) for r in raws[1:]]
    planes = builder.build_full(frame)[2]
    parts = {"build_full": _count_syncs(lambda: builder.build_full(frame)),
             "register": _count_syncs(lambda: fetch(tracker.plane_reg.register(planes, planes)))}
    print(f"odometry: host syncs per tracked frame (sync debug mode, a lower bound) "
          f"{syncs}; of which build_full {parts['build_full']}, register + fetch "
          f"{parts['register']}")

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


def main() -> int:
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
    rng = np.random.default_rng(0)
    k1 = check_k1(rng)
    k2 = check_k2(rng)
    t0 = time.perf_counter()
    sl = check_slice()
    print(f"phase d took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    setup = _synthetic_setup(
        BATCH_FRAMES, batch_dense_config(synthetic.config()), reference_maps=True
    )
    torch.cuda.synchronize()
    print(f"batch set-up (calibration maps, synthetic captures): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check_batch(*setup, smi)
    print(f"phase e took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_targets(*setup)
    print(f"phase f took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_odometry_phase(smi)
    print(f"phase g took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for job in _DEFERRED:
        job()
    print(f"phase h took {time.perf_counter() - t0:.1f} s")

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
                    launches=launches, max_abs_err=res["max_abs_err"],
                    shape=list(main["shape"]), **{k: main[k] for k in keys}, shapes=shapes)

    print(json.dumps({"card": smi, "pyramid": sl["pyramid"]}))
    print(json.dumps({"kernels": [
        entry("fused_gradients", "rgbd360_tpu_torch/csrc/fused_gradients.cu",
              "rgbd360_tpu/ops/pallas_kernels.py:148", TOTAL_LAUNCHES["fused_gradients"],
              k1, k1["groups"][1]),
        entry("fused_pyr_down", "rgbd360_tpu_torch/csrc/pyr_down.cu",
              "rgbd360_tpu/ops/pallas_kernels.py:90", TOTAL_LAUNCHES["fused_pyr_down"],
              k2, k2["transitions"][(1, *LEVEL_SHAPES[0])]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
