"""Batch graph registration of a sphere sequence (twin of
`rgbd360_tpu/apps/register_sequence.py`; reference
`Registration/RegisterGraphSphere.cpp`).

Offline batch mode: build every frame (in batches of 4), register each
frame to its `--window` predecessors (a PbMap seed, then a dense solve),
build the pose graph, optimize it, partition it into areas by
co-visibility, and export the trajectory and the areas.

Usage:
    python -m rgbd360_tpu_torch.apps.register_sequence DATASET_DIR --calib CALIB_DIR
        [--out DIR] [--window 2] [--sharded] [--device cpu]
    torchrun --nproc-per-node N -m rgbd360_tpu_torch.apps.register_sequence ... --sharded

It runs on the CUDA device unless `--device` names another.  `--sharded`
solves the graph with the edge-sharded distributed optimizer
(`parallel.sharded.distributed_pose_graph`) over every rank of the job: a
world of one when started plainly, the torchrun job's ranks otherwise, each
on card LOCAL_RANK (unless `--device` names one) in an NCCL process group
(gloo with `--device cpu`).  Every rank registers the whole sequence;
rank 0 writes `--out`.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from rgbd360_tpu_torch.apps._common import (
    add_calib_args,
    add_device_arg,
    frame_config,
    load_calib,
    save_trajectory_txt,
)

BATCH_SIZE = 4


def run(ds, builder, window: int = 2, out=None, mesh=None):
    """Register the frames of `ds` (a `SequenceDataset`) on the builder's
    device and optimize their graph (sharded over `mesh`'s ranks when
    given): returns (trajectory (N, 4, 4), area labels (N,)), and with
    `out` writes `trajectory.txt` and `areas.txt` (rank 0 of a mesh)."""
    from rgbd360_tpu_torch.core.frame import RigFrame, SphereFrame
    from rgbd360_tpu_torch.registration import dense as D
    from rgbd360_tpu_torch.registration.planes import PLANAR_3DOF, PlaneRegistration
    from rgbd360_tpu_torch.slam.graph import PoseGraph, optimize_pose_graph
    from rgbd360_tpu_torch.slam.topological import recursive_spectral_partition

    n = len(ds)
    if n < 2:
        raise SystemExit("need at least 2 frames")
    device = builder.sensor.device

    # build the frames in batches: one stitch gather per batch
    pyrs, planes = [], []
    raws = list(ds)
    for b0 in range(0, n, BATCH_SIZE):
        chunk = raws[b0 : b0 + BATCH_SIZE]
        frames = builder.build(RigFrame(
            rgb=torch.from_numpy(np.stack([r.rgb for r in chunk])).to(device),
            depth=torch.from_numpy(np.stack([r.depth_mm for r in chunk])).to(device),
        ))
        for k in range(len(chunk)):
            sphere = SphereFrame(**{f: v[k] for f, v in vars(frames).items()})
            pyrs.append(builder.pyramid(sphere))
            planes.append(builder.segment_planes(sphere))

    aligner = D.DenseAligner(builder.config.dense)
    reg = PlaneRegistration(builder.config.matcher)
    eye = torch.eye(4, device=device)

    # pairwise registrations
    edges = []
    for j in range(1, n):
        for back in range(1, min(window, j) + 1):
            i = j - back
            pb = reg.register(planes[i], planes[j], mode=PLANAR_3DOF)
            seed = pb.pose if bool(pb.success) else eye
            res = aligner.align(pyrs[j], pyrs[i], seed, method=D.PHOTO_DEPTH)
            if bool(res.ill_posed):
                continue
            edges.append((i, j, res.pose.cpu().numpy(), res.hessian.cpu().numpy(),
                          float(res.sso), float(res.av_depth_residual)))
            print(f"edge {i}->{j}: |t|={np.linalg.norm(edges[-1][2][:3, 3]):.3f} "
                  f"avd={float(res.av_depth_residual):.2f} sso={float(res.sso):.2f}")

    # assemble and optimize the graph; the edge capacity is padded to a
    # multiple of 8, the reference's shape
    e_cap = max(((len(edges) + 7) // 8) * 8, 8)
    poses0 = [np.eye(4)]
    rel_of = {(i, j): rel for i, j, rel, *_ in edges}
    for j in range(1, n):
        poses0.append(poses0[-1] @ rel_of.get((j - 1, j), np.eye(4)))
    edges_ij = np.full((e_cap, 2), -1, np.int32)
    rel = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
    info = np.tile(np.eye(6, dtype=np.float32), (e_cap, 1, 1))
    for e, (i, j, r, h, *_) in enumerate(edges):
        edges_ij[e], rel[e], info[e] = (i, j), r, h

    def on_device(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    g = PoseGraph(
        poses=on_device(np.stack(poses0), torch.float32),
        vmask=torch.ones(n, dtype=torch.bool, device=device),
        edges_ij=on_device(edges_ij),
        rel=on_device(rel),
        info=on_device(info),
        emask=torch.arange(e_cap, device=device) < len(edges),
    )
    if mesh is not None:
        from rgbd360_tpu_torch.parallel.sharded import distributed_pose_graph

        poses, chi2, iters = distributed_pose_graph(mesh, g)
    else:
        poses, chi2, iters = optimize_pose_graph(g)
    print(f"graph: {n} vertices, {len(edges)} edges, chi2={float(chi2):.4f} "
          f"({int(iters)} LM iters)")

    # topological partition from the co-visibility
    sso = np.zeros((n, n))
    for i, j, _, _, s, _ in edges:
        sso[i, j] = sso[j, i] = s
    labels = recursive_spectral_partition(sso)
    print(f"areas: {labels.max() + 1} -> {labels.tolist()}")

    traj = poses[:n].cpu().numpy()
    if out and (mesh is None or mesh.rank == 0):
        outdir = Path(out)
        outdir.mkdir(parents=True, exist_ok=True)
        save_trajectory_txt(outdir / "trajectory.txt", traj)
        np.savetxt(outdir / "areas.txt", labels, fmt="%d")
        print(f"saved to {outdir}")
    return traj, labels


def main(argv=None, builder=None):
    """Parse `argv` and run; a given `builder` replaces the one made from
    `--calib` (and its device `--device`)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset")
    p.add_argument("--out", default=None)
    p.add_argument("--window", type=int, default=2,
                   help="register each frame to this many predecessors")
    p.add_argument("--sharded", action="store_true",
                   help="use the mesh-sharded distributed optimizer over the job's ranks")
    add_calib_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    from rgbd360_tpu_torch.core.frame import FrameBuilder
    from rgbd360_tpu_torch.io.dataset import SequenceDataset

    device = args.device if builder is None else str(builder.sensor.device)
    mesh, joined = None, False
    if args.sharded:
        from rgbd360_tpu_torch.parallel import multihost
        from rgbd360_tpu_torch.parallel.sharded import make_mesh

        if device is None and os.environ.get("LOCAL_RANK"):
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        on_cpu = device is not None and torch.device(device).type == "cpu"
        if device is not None and not on_cpu and torch.device(device).index is not None:
            torch.cuda.set_device(torch.device(device))
        # a process group of the caller's stays the caller's to end
        joined = not torch.distributed.is_initialized() and multihost.initialize(
            backend="gloo" if on_cpu else "nccl")
        mesh = make_mesh(device=device)
    if builder is None:
        builder = FrameBuilder(load_calib(args), frame_config(args), device=device)
    try:
        return run(SequenceDataset(args.dataset), builder, window=args.window,
                   out=args.out, mesh=mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
