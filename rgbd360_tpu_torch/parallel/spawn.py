"""Run a function on N local ranks: one process per rank, started with the
`spawn` method (the one CUDA allows), joined in one process group through a
`FileStore` under a fresh temporary directory (no TCP port).

    results = run_ranks(fn, 2, "gloo", "cuda:0", args=(...,), timeout=300)

Rank r calls `fn(mesh, *args)` with `mesh = make_mesh(device=...)` over the
group, after `torch.cuda.set_device` when its device is a card, and its
return value comes back to the caller in `results[r]` (tensors moved to the
CPU).  The device is the caller's: "cuda:K" puts every rank on card K (gloo
then reduces their CUDA tensors through the host), "cuda" puts rank r on
card r mod count, "cpu" on the host.  The parent polls every rank and
waits at most `timeout` seconds in all.  The first rank to exit non-zero
(it raised or died) fails the call with its traceback at once, and every
rank still running is killed: its peers, blocked in a collective it will
never join, are not waited for.  A timeout fails the call with every
traceback the ranks wrote.  The process group's own collective timeout is
`timeout` too, so a rank blocked in a collective gives up by then.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist


def rank_device(device: str, rank: int) -> torch.device:
    """Rank r's device under the naming rule of the module doc."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return d


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank, world, backend, device, store, out_dir, fn, args, threads, timeout):
    from rgbd360_tpu_torch.parallel.sharded import make_mesh

    out = Path(out_dir)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        result = fn(make_mesh(device=dev), *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save(_to_cpu(result), out / f"result_{rank}.pt")
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def _tracebacks(tmp: str, ranks) -> str:
    out = []
    for r in ranks:
        f = Path(tmp) / f"error_{r}.txt"
        if f.exists():
            out.append(f"rank {r}:\n{f.read_text()}")
    return "\n".join(out)


def run_ranks(fn, world_size: int, backend: str, device: str, args: tuple = (),
              timeout: float = 600.0, threads: int | None = None, poll_s: float = 0.05) -> list:
    """Run `fn(mesh, *args)` on `world_size` spawned ranks; the ranks'
    return values in rank order (see the module doc).  `threads` sets each
    rank's intra-op thread count (the CPU's cores are shared by the
    ranks); `poll_s` is the parent's polling interval."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rgbd360_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world_size, backend, device, store, tmp, fn, args, threads, timeout),
                daemon=False,
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                failed = {r: p.exitcode for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)}
                if failed:
                    # every traceback written so far: a peer of the rank
                    # at fault may fail on the broken collective first
                    raise RuntimeError(
                        f"ranks of {world_size} exited with {failed}:\n"
                        + (_tracebacks(tmp, range(world_size)) or "(no traceback written)"))
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(procs) if p.exitcode is None]
                    raise TimeoutError(
                        f"ranks {alive} of {world_size} did not finish in {timeout} s"
                        + (f"; tracebacks written:\n{t}"
                           if (t := _tracebacks(tmp, range(world_size))) else ""))
                time.sleep(poll_s)
            return [torch.load(Path(tmp) / f"result_{r}.pt", weights_only=False)
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
