"""Count the host syncs of the small linear-algebra and SE(3) calls the
port's solvers make, on the card (PyTorch's sync debug mode, a lower
bound): a 6x6 `det`, `solve_ex`, `cholesky_ex`, `cholesky_solve`,
`lu_factor_ex` (single and batched), `eigh`, `se3_exp`, and a tensor made
from a host list.  A loop that must not read the device back (ICP, a
masked GN step) can use only the calls that count 0.

    python3 tools/torch_sync_probe.py

Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import warnings

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from rgbd360_tpu_torch.ops import se3  # noqa: E402


def count_syncs(fn) -> int:
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sync_probe: no CUDA device")
    dev = torch.device("cuda")
    a = torch.randn(6, 6, device=dev)
    h = a @ a.T + torch.eye(6, device=dev)
    g = torch.randn(6, device=dev)
    h2 = torch.stack([h, h])
    calls = {
        "det": lambda: torch.linalg.det(h),
        "det batched (2)": lambda: torch.linalg.det(h2),
        "solve_ex": lambda: torch.linalg.solve_ex(h, g[:, None]),
        "solve_ex batched (2)": lambda: torch.linalg.solve_ex(h2, g[None, :, None].expand(2, 6, 1)),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(h),
        "cholesky_solve": lambda: torch.cholesky_solve(g[:, None], torch.linalg.cholesky_ex(h)[0]),
        "lu_factor_ex": lambda: torch.linalg.lu_factor_ex(h),
        "eigh": lambda: torch.linalg.eigh(h),
        "se3_exp": lambda: se3.se3_exp(g),
        "tensor from a host list": lambda: torch.tensor([0.0, 1.0], device=dev),
    }
    for name, fn in calls.items():
        print(f"{name}: {count_syncs(fn)} host syncs")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
