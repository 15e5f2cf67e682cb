"""Offline frame/sequence viewer (twin of `rgbd360_tpu/apps/view_frame.py`;
reference `Visualization/LoadFrame360.cpp`, `LoadSphere.cpp`,
`LoadSequence.cpp` — PCL windows replaced by file export).

Modes: sphere PNGs, point cloud PLY/PCD, plane overlays with the
mrpt-binary plane set, a whole sequence (with an animated GIF), and a saved
PCD cloud (with its paired .pbmap) re-rendered as a panorama.

Usage:
    python -m rgbd360_tpu_torch.apps.view_frame FRAME.bin --calib C --out DIR
        [--planes] [--cloud] [--device cpu]
    python -m rgbd360_tpu_torch.apps.view_frame DATASET_DIR --calib C --out DIR
        --sequence [--video]
    python -m rgbd360_tpu_torch.apps.view_frame CLOUD.pcd --calib C --out DIR

It runs on the CUDA device unless `--device` names another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from rgbd360_tpu_torch.apps._common import add_calib_args, add_device_arg, frame_config, load_calib

_COLORS = np.array(
    [
        [255, 80, 80], [80, 255, 80], [80, 120, 255], [255, 255, 80],
        [255, 80, 255], [80, 255, 255], [255, 160, 40], [160, 80, 255],
    ]
)
_SEG_STEPS = 80  # points drawn along each polygon edge


def _edge_points(poly: np.ndarray) -> np.ndarray:
    """(len(poly), _SEG_STEPS, 3) points along each edge of a closed
    polygon, in the reference's float64 arithmetic."""
    t = np.linspace(0, 1, _SEG_STEPS)[:, None]
    return np.stack([poly[i][None] * (1 - t) + poly[(i + 1) % len(poly)][None] * t
                     for i in range(len(poly))])


def _project_edges(edges: list, h: int, w: int, device) -> list:
    """The sphere pixel (row, col) of every edge point of every polygon:
    one `camera.sphere_project` call on `device` for all of them."""
    from rgbd360_tpu_torch.ops import camera

    if not edges:
        return []
    flat = np.concatenate([e.reshape(-1, 3) for e in edges])
    rc, _ = camera.sphere_project(torch.as_tensor(flat, dtype=torch.float32, device=device), h, w)
    rc = rc.cpu().numpy()
    out, k = [], 0
    for e in edges:
        out.append(rc[k:k + e.shape[0] * e.shape[1]].reshape(e.shape[0], e.shape[1], 2))
        k += e.shape[0] * e.shape[1]
    return out


def render_plane_overlay(frame, planes, builder):
    """RGB sphere image with each valid plane's hull polygon drawn in."""
    img = frame.sphere_rgb.cpu().numpy()[..., ::-1].copy()
    h, w = img.shape[:2]
    hull = planes.hull.cpu().numpy()
    ks = np.flatnonzero(planes.valid.cpu().numpy())
    for k, rc in zip(ks, _project_edges([_edge_points(hull[k]) for k in ks], h, w,
                                        frame.sphere_rgb.device)):
        color = _COLORS[k % len(_COLORS)]
        for seg in rc:
            ok = (seg[:, 0] >= 0) & (seg[:, 0] < h)
            rr = seg[ok, 0].astype(int).clip(0, h - 1)
            cc = seg[ok, 1].astype(int) % w
            for dr in (-1, 0, 1):
                img[(rr + dr).clip(0, h - 1), cc] = color
    return img


def export_frame(builder, raw, outdir: Path, tag: str, planes=False, cloud=False):
    """Build one raw capture on the builder's device and write
    `<tag>_rgb.png`, `<tag>_depth.png`, with `planes` the overlay PNG and
    the mrpt-binary `.pbmap`, with `cloud` the sphere cloud as PLY and PCD.
    Returns the built frame."""
    from rgbd360_tpu_torch.ops import camera
    from rgbd360_tpu_torch.utils.viz import bgr_to_rgb, depth_to_gray, save_ply, save_png

    f = builder.build_from_raw(raw)
    rgb = f.sphere_rgb.cpu().numpy()
    depth = f.sphere_depth.cpu().numpy()
    save_png(outdir / f"{tag}_rgb.png", bgr_to_rgb(rgb))
    save_png(outdir / f"{tag}_depth.png", depth_to_gray(depth))
    msg = [f"{tag}: sphere {tuple(rgb.shape)}"]
    if planes:
        from rgbd360_tpu_torch.io.pbmap import planeset_to_pbplanes, write_pbmap

        ps = builder.segment_planes(f)
        n = int(ps.valid.sum())
        save_png(outdir / f"{tag}_planes.png", render_plane_overlay(f, ps, builder))
        # mrpt-binary plane set next to the cloud, the reference's
        # Frame360::save pairing (`include/Frame360.h:313,321`)
        write_pbmap(outdir / f"{tag}_planes.pbmap", planeset_to_pbplanes(ps))
        msg.append(f"{n} planes (.png + .pbmap)")
    if cloud:
        from rgbd360_tpu_torch.io.pcd import write_pcd

        pts = camera.sphere_backproject(f.sphere_depth).cpu().numpy()
        m = depth > 0
        npts = save_ply(outdir / f"{tag}_cloud.ply", pts, rgb[..., ::-1], m)
        # PCL interchange, like the reference's Frame360::save
        # (`include/Frame360.h:321` writes sphereCloud .pcd)
        write_pcd(outdir / f"{tag}_cloud.pcd", pts.reshape(-1, 3)[m.reshape(-1)],
                  rgb[..., ::-1].reshape(-1, 3)[m.reshape(-1)])
        msg.append(f"{npts} cloud points (.ply + .pcd)")
    print("  ".join(msg))
    return f


def _pbmap_for(pcd: Path, explicit) -> Path | None:
    """The plane set paired with a saved cloud: `explicit`, else the first
    that exists of <tag>_planes.pbmap, this tool's own export naming
    (<base>_cloud.pcd + <base>_planes.pbmap) and the reference's
    (sphereCloud_i.pcd + spherePlanes_i.pbmap, `Frame360.h:213`)."""
    if explicit is not None:
        return Path(explicit)
    tag = pcd.stem
    names = [f"{tag}_planes.pbmap"]
    if tag.endswith("_cloud"):
        names.append(f"{tag[: -len('_cloud')]}_planes.pbmap")
    if "Cloud" in tag:
        names.append(f"{tag.replace('Cloud', 'Planes')}.pbmap")
    return next((c for n in names if (c := pcd.with_name(n)).exists()), None)


def view_pcd(path, outdir: Path, pbmap=None, device=None) -> np.ndarray:
    """Saved-cloud viewer (reference `Visualization/LoadSphere.cpp`): the
    cloud re-rendered as a 320x1920 panorama PNG with its paired plane
    set's polygons drawn in, projected on `device` (the card when None).
    Returns the panorama."""
    from rgbd360_tpu_torch import resolve_device
    from rgbd360_tpu_torch.io.pcd import read_pcd
    from rgbd360_tpu_torch.ops import camera
    from rgbd360_tpu_torch.utils.viz import save_png

    device = resolve_device(device)
    xyz, rgb = read_pcd(path)
    h, w = 320, 1920
    rc, rho = camera.sphere_project(torch.as_tensor(xyz, dtype=torch.float32, device=device), h, w)
    rc, rho = rc.cpu().numpy(), rho.cpu().numpy()
    valid = np.isfinite(rc).all(axis=1) & (rho > 1e-6)
    img = np.zeros((h, w, 3), np.uint8)
    rr = rc[valid, 0].astype(int).clip(0, h - 1)
    cc = rc[valid, 1].astype(int) % w
    img[rr, cc] = rgb[valid] if rgb is not None else 200
    tag = Path(path).stem
    pbmap_path = _pbmap_for(Path(path), pbmap)
    n_pl = 0
    if pbmap_path is not None:
        from rgbd360_tpu_torch.io.pbmap import read_pbmap

        pb = read_pbmap(pbmap_path)
        n_pl = len(pb)
        drawn = [(k, np.asarray(pl.polygon, np.float32)) for k, pl in enumerate(pb)]
        drawn = [(k, poly) for k, poly in drawn if len(poly) >= 2]
        for (k, _), src in zip(drawn, _project_edges([_edge_points(p) for _, p in drawn],
                                                     h, w, device)):
            color = _COLORS[k % len(_COLORS)]
            for seg in src:
                ok = (seg[:, 0] >= 0) & (seg[:, 0] < h)
                img[seg[ok, 0].astype(int).clip(0, h - 1), seg[ok, 1].astype(int) % w] = color
    save_png(outdir / f"{tag}_pano.png", img)
    r = np.linalg.norm(xyz, axis=1)
    extra = f", {n_pl} pbmap planes" if pbmap_path is not None else ""
    print(
        f"{tag}: {len(xyz)} points{extra}, radius median "
        f"{np.median(r):.2f} m (min {r.min():.2f}, max {r.max():.2f}) "
        f"-> {outdir / f'{tag}_pano.png'}"
    )
    return img


def run(builder, inp, outdir, planes=False, cloud=False, sequence=False, video=False,
        fps: float = 10.0) -> list:
    """View a capture file, or every capture of a directory (`sequence`,
    or when `inp` is a directory), on the builder's device; with `video`
    the sequence's sphere RGB frames also go to `sequence.gif`.  Returns
    the built frames."""
    from rgbd360_tpu_torch.io.bin_format import read_rig_frame
    from rgbd360_tpu_torch.io.dataset import SequenceDataset
    from rgbd360_tpu_torch.utils.viz import bgr_to_rgb, save_gif

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if not (sequence or Path(inp).is_dir()):
        return [export_frame(builder, read_rig_frame(inp), outdir, Path(inp).stem, planes, cloud)]
    ds = SequenceDataset(inp)
    frames, gif = [], []
    for i, raw in enumerate(ds):
        f = export_frame(builder, raw, outdir, f"frame_{ds.indices[i]}", planes, cloud)
        frames.append(f)
        if video:
            gif.append(bgr_to_rgb(f.sphere_rgb.cpu().numpy()))
    if gif:
        save_gif(outdir / "sequence.gif", gif, fps=fps)
        print(f"wrote {outdir / 'sequence.gif'} ({len(gif)} frames)")
    return frames


def main(argv=None, builder=None):
    """Parse `argv` and view; `builder` replaces the one made from
    `--calib` (a test's small rig)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help=".bin frame, dataset directory or .pcd cloud")
    p.add_argument("--out", required=True)
    p.add_argument("--planes", action="store_true")
    p.add_argument("--cloud", action="store_true")
    p.add_argument("--sequence", action="store_true")
    p.add_argument("--video", action="store_true",
                   help="also write sequence.gif of the sphere RGB frames "
                   "(the reference sequence viewer's save-video mode, "
                   "LoadSequence.cpp:59-65)")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument(
        "--pbmap",
        default=None,
        help="with a .pcd input: paired mrpt-binary plane set to overlay "
        "(reference load_PbMap_Cloud, Frame360.h:213); defaults to "
        "<input>_planes.pbmap when that file exists",
    )
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    if str(args.input).endswith(".pcd"):
        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        return view_pcd(args.input, outdir, args.pbmap, args.device)

    from rgbd360_tpu_torch.core.frame import FrameBuilder

    if builder is None:
        builder = FrameBuilder(load_calib(args), frame_config(args), device=args.device)
    return run(builder, args.input, args.out, args.planes, args.cloud, args.sequence,
               args.video, args.fps)


if __name__ == "__main__":
    main()
