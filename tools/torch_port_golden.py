"""Write the JAX golden that `chip_smoke.py` holds the port against.

Runs the reference package (`rgbd360_tpu`) on the CPU over exactly the
smoke's slice: the synthetic sequence of `rgbd360_tpu_torch.synthetic`
(full size: 8x240x320 rig, 320x1920 sphere, 5 levels, `DenseRegConfig()`),
`FrameBuilder.build_with_pyramid` per frame and `DenseAligner.align` per
consecutive pair with a constant-velocity seed.  Per-pair poses,
Hessians, errors, iteration counts, SSO and ill-posed flags go to
`rgbd360_tpu_torch/data/smoke_golden.npz`, so the card machine, which has
no jax, needs only that file.

    JAX_PLATFORMS=cpu python tools/torch_port_golden.py
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rgbd360_tpu.core.frame import FrameBuilder, RigFrame  # noqa: E402
from rgbd360_tpu.registration import dense as D  # noqa: E402
from rgbd360_tpu_torch import synthetic  # noqa: E402

OUT = ROOT / "rgbd360_tpu_torch" / "data" / "smoke_golden.npz"


def track_pairs_jax(n_frames: int, subsample: int = 1, pyramid_levels: int = 5) -> dict:
    """The reference's run of the smoke's slice (see the module doc)."""
    cfg = synthetic.config(subsample, pyramid_levels)
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg)
    aligner = D.DenseAligner(cfg.dense)
    pyrs = [
        builder.build_with_pyramid(RigFrame(jnp.asarray(rgb), jnp.asarray(d)))[1]
        for rgb, d in synthetic.captures(n_frames, subsample)
    ]
    seed = jnp.eye(4)
    out = {k: [] for k in ("poses", "hessians", "errors", "iters", "ill_posed", "sso")}
    for i in range(1, n_frames):
        res = jax.device_get(
            aligner.align(pyrs[i], pyrs[i - 1], seed, method=D.PHOTO_DEPTH)
        )
        seed = jnp.asarray(res.pose)
        out["poses"].append(res.pose)
        out["hessians"].append(res.hessian)
        out["errors"].append(res.error)
        out["iters"].append(res.iters)
        out["ill_posed"].append(res.ill_posed)
        out["sso"].append(res.sso)
    return {k: np.asarray(v) for k, v in out.items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    res = track_pairs_jax(args.frames)
    np.savez(args.out, **res)
    print(f"wrote {args.out}")
    print("axial steps (m):", res["poses"][:, 0, 3].tolist())
    print("iterations per level:", res["iters"].tolist())


if __name__ == "__main__":
    main()
