"""Semantic plane labeling (twin of `rgbd360_tpu/apps/labelize.py`; reference
`Labelization/LabelizeFrame360.cpp` and `LabelizeSequence.cpp`) — GUI
replaced by overlay renders + JSON label input.

Subcommands:
  render     — export plane-overlay PNGs with plane indices for inspection
  apply      — assign labels to planes of a frame from a JSON mapping
               {"3": "wall", "5": {"name": "table", "level": "object"}}
  propagate  — register consecutive frames and propagate labels along
               matched planes (the reference's label voting)
  stats      — per-label counts

Usage:
    python -m rgbd360_tpu_torch.apps.labelize render DATASET --calib C --out DIR
    python -m rgbd360_tpu_torch.apps.labelize apply DATASET --calib C --frame 1 \
        --labels labels.json --store store.json
    python -m rgbd360_tpu_torch.apps.labelize propagate DATASET --calib C --store store.json
    python -m rgbd360_tpu_torch.apps.labelize stats --store store.json

Frames are built, segmented and registered on the CUDA device unless
`--device` names another; a `builder` given to `main` replaces the one
made from `--calib` (a test's small rig).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
)


def _builder_and_ds(args, builder=None):
    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.dataset import SequenceDataset

    if builder is None:
        builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    return builder, SequenceDataset(args.dataset)


def cmd_render(args, builder=None):
    from rgbd360_tpu_torch.apps.view_frame import render_plane_overlay
    from rgbd360_tpu_torch.utils.viz import save_png

    builder, ds = _builder_and_ds(args, builder)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    for i, raw in enumerate(ds):
        f = builder.build_from_raw(raw)
        ps = builder.segment_planes(f)
        img = render_plane_overlay(f, ps, builder)
        save_png(outdir / f"frame_{ds.indices[i]}_planes.png", img)
        ids = np.where(ps.valid.cpu().numpy())[0].tolist()
        centers = np.round(ps.center.cpu().numpy()[ids], 2).tolist()
        areas = np.round(ps.area.cpu().numpy()[ids], 2).tolist()
        meta = [
            {"plane": int(k), "center": c, "area": a}
            for k, c, a in zip(ids, centers, areas)
        ]
        json.dump(meta, open(outdir / f"frame_{ds.indices[i]}_planes.json", "w"), indent=1)
        print(f"frame {ds.indices[i]}: {len(ids)} planes -> overlay + metadata")


def cmd_apply(args, builder=None):
    from rgbd360_tpu_torch.slam.labeling import LabelStore

    builder, ds = _builder_and_ds(args, builder)
    store = (
        LabelStore.load(args.store)
        if Path(args.store).exists()
        else LabelStore(capacity=builder.config.seg.max_planes)
    )
    mapping = json.load(open(args.labels))
    for plane_str, spec in mapping.items():
        if isinstance(spec, str):
            name, level = spec, "plane"
        else:
            name, level = spec["name"], spec.get("level", "plane")
        store.set_label(args.frame, int(plane_str), name, level)
        print(f"frame {args.frame} plane {plane_str} <- {name} ({level})")
    store.save(args.store)
    return store


def cmd_propagate(args, builder=None):
    from rgbd360_tpu_torch.registration.planes import ODOMETRY_6DOF, PlaneRegistration
    from rgbd360_tpu_torch.slam.labeling import LabelStore

    builder, ds = _builder_and_ds(args, builder)
    store = LabelStore.load(args.store)
    reg = PlaneRegistration(builder.config.matcher)
    plane_sets = {}
    for i, raw in enumerate(ds):
        f = builder.build_from_raw(raw)
        plane_sets[ds.indices[i]] = builder.segment_planes(f)

    frames = sorted(plane_sets)
    for a, b in zip(frames[:-1], frames[1:]):
        res = reg.register(plane_sets[a], plane_sets[b], mode=ODOMETRY_6DOF)
        pairs = res.pairs.cpu().numpy()
        store.propagate(a, b, pairs)
        n_prop = sum(
            1 for i_, j_ in pairs if i_ >= 0 and store.labels_for(b)[0, j_] >= 0
        )
        print(f"{a} -> {b}: {int(res.n_matches)} matches, {n_prop} labeled planes in {b}")
    store.save(args.store)
    return store


def cmd_stats(args, builder=None):
    from rgbd360_tpu_torch.slam.labeling import LabelStore, label_statistics

    store = LabelStore.load(args.store)
    out = {}
    for level in ("plane", "object", "context"):
        stats = label_statistics(store, level)
        if stats:
            print(f"{level}: {stats}")
            out[level] = stats
    return out


def main(argv=None, builder=None):
    """Parse `argv` and run the sub-command; returns its result."""
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render")
    pr.add_argument("dataset")
    pr.add_argument("--out", required=True)
    add_calib_args(pr)
    add_device_arg(pr)
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("apply")
    pa.add_argument("dataset")
    pa.add_argument("--frame", type=int, required=True)
    pa.add_argument("--labels", required=True)
    pa.add_argument("--store", required=True)
    add_calib_args(pa)
    add_device_arg(pa)
    pa.set_defaults(fn=cmd_apply)

    pp = sub.add_parser("propagate")
    pp.add_argument("dataset")
    pp.add_argument("--store", required=True)
    add_calib_args(pp)
    add_device_arg(pp)
    pp.set_defaults(fn=cmd_propagate)

    pst = sub.add_parser("stats")
    pst.add_argument("--store", required=True)
    pst.set_defaults(fn=cmd_stats)

    args = p.parse_args(argv)
    return args.fn(args, builder)


if __name__ == "__main__":
    main()
