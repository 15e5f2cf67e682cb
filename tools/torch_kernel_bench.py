"""Time the port's CUDA kernels (K1 `fused_gradients`, K2 `fused_pyr_down`
/ `fused_level_down`) and the pyramid stage on one CUDA device.

    python3 tools/torch_kernel_bench.py [--root DIR] [--label NAME] [--out-dir DIR]

`--root DIR` imports `rgbd360_tpu_torch` from another checkout (for an old
against new comparison in one call: unpack the parent commit with
`git archive <parent> | tar -x -C build/parent` and run this script once
per tree, in turns).  The script only uses entry points both trees have,
and feature-detects the newer ones (`fused_gradients_levels`, the
`device=` argument of `FrameBuilder`), so it also runs against a tree
from before the kernels were redesigned.  The timing helpers and the input
generators are `chip_smoke.py`'s (the one beside this script, whatever
`--root` says).

Per kernel and path shape it prints the device time (`torch.profiler`,
mean of 20 launches: cold, with a 128 MB pass over another buffer between
launches to flush the 50 MB L2, and warm, back to back), the CUDA-event
median of 30 calls (host launch included), the bytes the function must move
(each input read once, each output written once), the bound at the card's
3.35 TB/s and the share of that bound.  Before them, in a process that has
not profiled yet, the pyramid stage (`build_frame_pyramid` of one frame, 5
levels, seam masks): unprofiled wall and `build_with_pyramid` (medians of
30), then device ops, device busy time and profiled wall.  Everything is also written to
`<out-dir>/kernel_bench_<label>.json` (by default under `build/`).  The
first output line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load_smoke():
    """`chip_smoke.py` beside this script, by its path: with `--root` the
    package comes from another checkout, the helpers do not."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def _row(S, name, shape, fn, nbytes) -> dict:
    """Time fn (device time cold and warm, per call) and print it with its
    bound; `S` is the smoke module."""
    cold, ops = S._device_time(fn, cold=True)
    warm, _ = S._device_time(fn, cold=False)
    us_cold, us_warm, ms = 1e3 * cold, 1e3 * warm, S._median_ms(fn)
    bound_us = 1e6 * nbytes / S.HBM_BYTES_PER_S
    print(f"{name} {'x'.join(map(str, shape))}: device {us_cold:.2f} us cold, "
          f"{us_warm:.2f} us warm ({ops:.0f} device ops), per call {ms:.4f} ms; "
          f"{nbytes / 1e6:.2f} MB, bound {bound_us:.2f} us, share {bound_us / us_cold:.2f} "
          f"cold / {bound_us / us_warm:.2f} warm")
    return dict(name=name, shape=list(shape), device_us_cold=us_cold, device_us_warm=us_warm,
                device_ops=ops, event_ms=ms, bytes=nbytes, bound_us=bound_us,
                share_cold=bound_us / us_cold, share_warm=bound_us / us_warm)


def bench_kernels(S, HK, pyr_ops, rng) -> list[dict]:
    rows = []
    for h, w in S.LEVEL_SHAPES:
        for c in (2, 8):
            x = S._plateau_inputs(c, h, w, rng)
            rows.append(_row(S, "K1 fused_gradients", (c, h, w),
                             lambda: HK.fused_gradients(x), S._k1_bytes([x])))
    for h, w in S.TRANSITION_SHAPES:
        for c in (1, 4):
            x, d = S._plateau_inputs(c, h, w, rng), S._depth_inputs(c, h, w, rng)
            nbytes = 5 * c * h * w  # 4 bytes in, a quarter of that out
            rows.append(_row(S, "K2 fused_pyr_down_circular", (c, h, w),
                             lambda: HK.fused_pyr_down_circular(x), nbytes))
            rows.append(_row(
                S, "level transition (gray + depth)", (c, h, w),
                lambda: pyr_ops.fused_level_down(x, d, S.MIN_DEPTH, S.MAX_DEPTH), 2 * nbytes))
    return rows


def bench_group(S, HK, rng) -> list[dict]:
    """The gradients of a whole pyramid (B frames): ONE grouped launch with
    the masks in the store where the tree has it, else the per-level form
    it replaced (stack, launch, two mask multiplies per level)."""
    rows = []
    for b in (1, 4):
        grays = [S._plateau_inputs(b, h, w, rng) for h, w in S.LEVEL_SHAPES]
        depths = [S._depth_inputs(b, h, w, rng) for h, w in S.LEVEL_SHAPES]
        masks = S._seam_like_masks(S.LEVEL_SHAPES, rng)
        stacks = [x for pair in zip(grays, depths) for x in pair]
        masks2 = [m for m in masks for _ in range(2)]
        nbytes = S._k1_bytes(stacks, masks2)
        if hasattr(HK, "fused_gradients_levels"):
            name = "K1 grouped, masks in the store"
            fn = lambda: HK.fused_gradients_levels(stacks, masks2)
        else:
            name = "K1 per level (stack, launch, mask multiplies)"

            def fn():
                out = []
                for g, d, m in zip(grays, depths, masks):
                    sx, sy = HK.fused_gradients(torch.stack([g, d]).reshape(-1, *g.shape[-2:]))
                    mf = m.to(sx.dtype)
                    out.append((sx * mf, sy * mf))
                return out

        rows.append(_row(S, name, (b, "5 levels"), fn, nbytes))
    return rows


def bench_pyramid(S) -> dict:
    """The pyramid stage and `build_with_pyramid` of one synthetic frame."""
    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame

    cfg = synthetic.config()
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    if "device" not in inspect.signature(FrameBuilder.__init__).parameters:
        builder = builder.to("cuda")
    rgb, d = synthetic.captures(1)[0]
    frame = RigFrame(torch.from_numpy(rgb).cuda(), torch.from_numpy(d).cuda())
    sphere = builder.build(frame)
    fn = lambda: builder.pyramid(sphere)
    for _ in range(3):
        fn()
    # the host-clock walls first: a profiler run makes every later
    # launch of the process cost more host time
    out = dict(pyramid_wall_ms=statistics.median(S._host_ms(fn, reps=30)),
               build_with_pyramid_ms=statistics.median(
                   S._host_ms(lambda: builder.build_with_pyramid(frame), reps=30)))
    names: list = []
    wall_profiled, busy, ops, _, _ = S._profile(fn, names)
    kinds = dict(Counter(n[:60] for n in names))
    out.update(pyramid_device_ops=ops, pyramid_busy_ms=busy,
               pyramid_wall_profiled_ms=wall_profiled, pyramid_kernels=kinds)
    print(f"pyramid stage: {ops} device ops, busy {busy:.4f} ms, wall "
          f"{out['pyramid_wall_ms']:.3f} ms (median of 30), profiled {wall_profiled:.3f} ms; "
          f"build_with_pyramid {out['build_with_pyramid_ms']:.3f} ms (median of 30)")
    print(f"pyramid stage kernels: {json.dumps(kinds)}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--label", default="change")
    p.add_argument("--out-dir", default="build/kernel_bench")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bench: no CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    S = _load_smoke()
    from rgbd360_tpu_torch.ops import hopper_kernels as HK, pyramid as pyr_ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"tree {Path(args.root).resolve()} ({args.label}), torch {torch.__version__}")
    rng = np.random.default_rng(0)
    out = dict(card=smi, label=args.label, pyramid=bench_pyramid(S))
    out["kernels"] = bench_kernels(S, HK, pyr_ops, rng)
    out["groups"] = bench_group(S, HK, rng)
    dest = Path(args.out_dir)
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"kernel_bench_{args.label}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
