"""Distribution bring-up probe on the card: the three collectives of
`parallel/sharded.py` on CUDA tensors in a world of 2 on gloo (both ranks on
card 0) and of 1 on NCCL, with the latency of one all-reduce of 8 floats
and of 1 MiB (mean of 50); the native decoder's build; `entry()` against
its golden with its launch counts; `dryrun_multichip(2, "gloo", "cuda:0")`.

    python3 tools/torch_dist_probe.py
"""

import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rgbd360_tpu_torch.parallel import multihost as MH, sharded as S  # noqa: E402
from rgbd360_tpu_torch.parallel.spawn import run_ranks  # noqa: E402


def collectives(mesh) -> dict:
    """Each collective on this rank's device, and the all-reduce latency."""
    dev = mesh.device
    x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * mesh.rank
    out = {
        "psum": S.psum(mesh, x),
        "all_gather": S.all_gather(mesh, x[:3]),
        "all_gather_bool": S.all_gather(mesh, torch.tensor([mesh.rank == 0], device=dev)),
        "all_gather_int": S.all_gather(
            mesh, torch.tensor([mesh.rank + 5], dtype=torch.int32, device=dev)),
        "psum_scatter": S.psum_scatter(mesh, torch.ones(4, device=dev)),
        "agree": MH.all_hosts_agree(1.5, mesh),
        "hosts": MH.hosts_mesh().shape,
    }
    for n in (8, 262144):
        y = torch.ones(n, device=dev)
        for _ in range(3):
            S.psum(mesh, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            S.psum(mesh, y)
        torch.cuda.synchronize()
        out[f"all_reduce_ms_{n}"] = 1e3 * (time.perf_counter() - t0) / 50
    return out


def main() -> None:
    from rgbd360_tpu_torch.entry import dryrun_multichip, entry
    from rgbd360_tpu_torch.io import native
    from rgbd360_tpu_torch.ops import _build, hopper_kernels as HK

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda)
    print("g++", shutil.which("g++"), "nvcc", shutil.which("nvcc"))
    t = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t:.2f} s")
    for world, backend in ((2, "gloo"), (1, "nccl")):
        t = time.perf_counter()
        runs = run_ranks(collectives, world, backend, "cuda:0", timeout=120)
        print(f"world {world} ({backend}), {time.perf_counter() - t:.1f} s with the ranks' start:",
              runs)
    t = time.perf_counter()
    native.load()
    print(f"native decoder built in {time.perf_counter() - t:.2f} s")
    golden = np.load(ROOT / "rgbd360_tpu_torch" / "data" / "entry_golden.npz")
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    HK.fused_gradients.launches = HK.fused_pyr_down.launches = 0
    res = fn(*args)
    print("entry(): pose", np.abs(res.pose.cpu().numpy() - golden["pose"]).max(),
          "from the golden; launches", HK.fused_gradients.launches, HK.fused_pyr_down.launches)
    t = time.perf_counter()
    dryrun_multichip(2, "gloo", "cuda:0", timeout=300)
    print(f"dry run {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
