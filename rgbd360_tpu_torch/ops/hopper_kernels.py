"""Hand-written Hopper kernels of the port, their wrappers and plain
versions.

* K1 replaces `rgbd360_tpu/ops/pallas_kernels.py:fused_gradients`; CUDA
  source `csrc/fused_gradients.cu`.  `fused_gradients_levels` takes the
  stacks of a whole pyramid (and their seam masks) in ONE launch;
  `fused_gradients` is the group of one.
* K2 replaces `rgbd360_tpu/ops/pallas_kernels.py:fused_pyr_down`; CUDA
  source `csrc/pyr_down.cu`.  One tiled kernel serves three wrappers:
  `fused_pyr_down` (edge-clamped rows, as the Pallas kernel),
  `fused_pyr_down_circular` (circular rows, what the pyramid's pyrDown
  computes) and `fused_level_down` (a whole level transition: the gray's
  circular pyrDown and the depth's 2x2 valid mean in one launch).

The sources are built by `ops/_build.py` on first use.  A wrapper launches
its kernel for a CUDA tensor and raises if it cannot; it uses the plain
PyTorch version only for a tensor on the CPU.  `<kernel>.launches` counts
kernel launches: K1's count is on `fused_gradients` (one for a group), K2's
on `fused_pyr_down` (every wrapper).

What surrounds the kernels is decided here, in Python the CPU tests reach:
`gradient_plan` and `level_down_plan` give each launch its tiles, its grid
and the instantiation each tensor takes (16-byte accesses, or 4-byte ones
for a width or a pointer that does not allow them).
"""

from __future__ import annotations

import struct
from collections.abc import Sequence

import torch

from rgbd360_tpu_torch import resolve_device
from rgbd360_tpu_torch.ops import _build


def _harmonic(fwd: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    mono = ((fwd > 0) & (bwd > 0)) | ((fwd < 0) & (bwd < 0))
    one = torch.ones_like(fwd)
    denom = torch.where(mono, one / torch.where(fwd == 0, 1e-12, fwd), 0.0) + torch.where(
        mono, one / torch.where(bwd == 0, 1e-12, bwd), 0.0
    )
    # tensor / tensor is IEEE division on every device (a Python scalar
    # numerator would become reciprocal * scalar)
    two = torch.full_like(fwd, 2.0)
    return torch.where(mono, two / torch.where(denom == 0, 1e-12, denom), 0.0)


def _axis_grad(a: torch.Tensor, dim: int) -> torch.Tensor:
    fwd = torch.roll(a, -1, dims=dim) - a
    bwd = a - torch.roll(a, 1, dims=dim)
    g = _harmonic(fwd, bwd)
    n = a.shape[dim]
    idx = torch.arange(n, device=a.device)
    shape = [1] * a.ndim
    shape[dim] = n
    interior = ((idx > 0) & (idx < n - 1)).reshape(shape)
    return torch.where(interior, g, 0.0)


def fused_gradients_plain(
    imgs: torch.Tensor, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: a port of
    `rgbd360_tpu/ops/pyramid.py:gradient_xy_multi` over (..., H, W), both
    outputs multiplied by the (H, W) 0/1 `mask` when given."""
    gx, gy = _axis_grad(imgs, imgs.ndim - 1), _axis_grad(imgs, imgs.ndim - 2)
    if mask is not None:
        m = mask.to(imgs.dtype)
        gx, gy = gx * m, gy * m
    return gx, gy


def fused_gradients_levels_plain(
    stacks: Sequence[torch.Tensor], masks: Sequence[torch.Tensor] | None = None
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of the grouped K1 launch: `fused_gradients_plain`
    of every stack with its mask."""
    masks = [None] * len(stacks) if masks is None else masks
    return [fused_gradients_plain(x, m) for x, m in zip(stacks, masks)]


# The tile plan of K1 (twin of the constants in csrc/fused_gradients.cu): a
# warp owns 32 * vec columns by GRAD_ROWS rows of one channel, a block 4 warps.
GRAD_WARPS = 4
GRAD_ROWS = 2
GRAD_MAX_STACKS = 16  # descriptors per launch


def gradient_plan(
    shapes: Sequence[tuple[int, int, int]], aligned: Sequence[bool]
) -> tuple[list[dict], int]:
    """(per-stack plan, blocks in all) of one grouped K1 launch over
    (C, H, W) `shapes`.  `aligned[i]` says whether stack i's pointers allow
    16-byte accesses; with a width that is a multiple of 4 the stack then
    takes `vec` = 4 pixels per thread, else 1.  Per stack: `tiles_x`,
    `tiles_y`, `tiles` (one per warp, channel-major, then rows, then
    columns), `blocks` and `first_block` (the prefix of the block counts)."""
    plan, first = [], 0
    for (c, h, w), ok in zip(shapes, aligned):
        vec = 4 if ok and w % 4 == 0 else 1
        tiles_x = -(-w // (32 * vec))
        tiles_y = -(-h // GRAD_ROWS)
        tiles = c * tiles_y * tiles_x
        blocks = -(-tiles // GRAD_WARPS)
        plan.append(dict(vec=vec, tiles_x=tiles_x, tiles_y=tiles_y, tiles=tiles,
                         blocks=blocks, first_block=first))
        first += blocks
    return plan, first


# `GradStack` of csrc/fused_gradients.cu: img, gx, gy, mask, then c, h, w,
# vec, tiles_x, tiles_y, tiles, first_block; `GradGroup` is GRAD_MAX_STACKS
# of them, then n and a pad.
_GRAD_STACK = struct.Struct("4P8i")
_GRAD_GROUP_TAIL = struct.Struct("2i")


def _check_stack(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{name}: needs (C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")


def _check_mask(m: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if m.dtype != torch.bool or tuple(m.shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"{name}: a mask is an (H, W) bool tensor, got {m.dtype} {tuple(m.shape)} "
            f"for a stack {tuple(x.shape)}"
        )
    if m.device != x.device or not m.is_contiguous():
        raise ValueError(f"{name}: a mask is contiguous and on its stack's device")


def _on_device(dev: torch.device, call):
    """call(stream) with `dev` current: a kernel launches on the current
    device's current stream."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return call(torch.cuda.current_stream().cuda_stream)


def _launch_gradients(stacks, masks):
    """One K1 launch over at most GRAD_MAX_STACKS CUDA stacks."""
    outs = [torch.empty((2, *x.shape), dtype=x.dtype, device=x.device) for x in stacks]
    # (img, gx, gy, mask) pointers: gy follows gx in its stack's output
    ptrs = [
        (x.data_ptr(), o.data_ptr(), o.data_ptr() + 4 * x.numel(),
         0 if m is None else m.data_ptr())
        for x, o, m in zip(stacks, outs, masks)
    ]
    aligned = [
        img % 16 == 0 and gx % 16 == 0 and gy % 16 == 0 and mask % 4 == 0
        for img, gx, gy, mask in ptrs
    ]
    plan, blocks = gradient_plan([x.shape for x in stacks], aligned)
    group = b"".join(
        _GRAD_STACK.pack(*ptr, *x.shape, p["vec"], p["tiles_x"], p["tiles_y"], p["tiles"],
                         p["first_block"])
        for ptr, x, p in zip(ptrs, stacks, plan)
    ).ljust(GRAD_MAX_STACKS * _GRAD_STACK.size, b"\0") + _GRAD_GROUP_TAIL.pack(len(stacks), 0)
    lib = _build.load()
    code = _on_device(stacks[0].device, lambda stream: lib.rgbd360_fused_gradients_levels(
        group, blocks, stream))
    _build.check(lib, code, "fused_gradients_levels")
    if blocks:
        fused_gradients.launches += 1
    return [o.unbind(0) for o in outs]


def fused_gradients_levels(
    stacks: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor | None] | None = None,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(gx, gy)] of every (C, H, W) float32 stack (the gray and depth of
    every pyramid level, of any shapes) in ONE K1 launch per
    GRAD_MAX_STACKS stacks.  `masks`: per stack an (H, W) bool tensor that
    multiplies both outputs (a seam mask), or None."""
    stacks = list(stacks)
    masks = [None] * len(stacks) if masks is None else list(masks)
    if len(masks) != len(stacks):
        raise ValueError("fused_gradients_levels: one mask (or None) per stack")
    if not stacks:
        return []
    kinds = {x.device.type for x in stacks}
    if len({x.device for x in stacks}) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(
            "fused_gradients: no kernel for devices "
            f"{sorted({str(x.device) for x in stacks})} (one CUDA device, or the CPU)"
        )
    for x, m in zip(stacks, masks):
        _check_stack(x, "fused_gradients")
        if m is not None:
            _check_mask(m, x, "fused_gradients")
    if kinds == {"cpu"}:
        return fused_gradients_levels_plain(stacks, masks)
    outs = []
    for i in range(0, len(stacks), GRAD_MAX_STACKS):
        outs += _launch_gradients(stacks[i : i + GRAD_MAX_STACKS], masks[i : i + GRAD_MAX_STACKS])
    return outs


def fused_gradients(
    imgs: torch.Tensor, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) occlusion-aware harmonic-mean gradients of a stacked
    (C, H, W) float32 tensor, one launch for all channels and both axes
    (the group of one stack); both multiplied by the (H, W) bool `mask`
    when given."""
    return fused_gradients_levels([imgs], [mask])[0]


fused_gradients.launches = 0


def check_fast_reciprocal() -> tuple[int, int]:
    """(mismatches, bits of one mismatching b): K1's branch-free reciprocal
    against IEEE division for every float b with 2^-60 <= |b| <= 2^60, on
    the card (a proof by exhaustion of the kernel's division; (0, 0) when
    they agree everywhere)."""
    result = torch.zeros(2, dtype=torch.int64, device=resolve_device())
    lib = _build.load()
    code = _on_device(result.device, lambda stream: lib.rgbd360_check_fast_reciprocal(
        result.data_ptr(), stream))
    _build.check(lib, code, "check_fast_reciprocal")
    count, bits = result.tolist()
    return count, bits


# ------------------------------------------------------------------ K2

_K0, _K1, _K2 = 1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0


def _blur5(m2, m1, c, p1, p2):
    """The Pallas body's order: k0*(m2+p2) + k1*(m1+p1) + k2*c.  (Not
    `ops/pyramid._sep_filter5`'s order.)"""
    return _K0 * (m2 + p2) + _K1 * (m1 + p1) + _K2 * c


def fused_pyr_down_plain(imgs: torch.Tensor, circular: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2 over (..., H, W) with even H and W: the
    5-tap binomial blur on rows (edge-clamped, or circular), then on
    columns (circular), keeping the even rows and columns."""
    h = imgs.shape[-2]
    even = torch.arange(0, h, 2, device=imgs.device)

    def rows(d):
        r = torch.remainder(even + d, h) if circular else torch.clamp(even + d, 0, h - 1)
        return imgs.index_select(-2, r)

    v = _blur5(rows(-2), rows(-1), rows(0), rows(1), rows(2))

    def cols(d):
        return torch.roll(v, -d, dims=-1)

    return _blur5(cols(-2), cols(-1), v, cols(1), cols(2))[..., ::2]


def fused_level_down_plain(
    gray: torch.Tensor, depth: torch.Tensor, min_depth: float, max_depth: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2's level transition over (..., H, W) with
    even H and W: the circular-row pyrDown of the gray, and the depth's
    2x2 mean over valid (min < d < max) depths, 0 where none is valid.  The
    block sums add rows first, then columns, as the 0/1 matmul pair of the
    reference's `fused_level_down` does; each sum has two addends per
    pass, so it is exact in any order."""
    valid = (depth > min_depth) & (depth < max_depth)

    def box_sum(x):
        rows = x[..., 0::2, :] + x[..., 1::2, :]
        return rows[..., 0::2] + rows[..., 1::2]

    s = box_sum(torch.where(valid, depth, 0.0))
    n = box_sum(valid.to(depth.dtype))
    d2 = torch.where(n > 0.5, s / torch.clamp(n, min=1.0), 0.0)
    return fused_pyr_down_plain(gray, circular=True), d2


# The tile plan of K2 (twin of the constants in csrc/pyr_down.cu): a block
# of 256 threads owns 4 x 64 outputs of one channel and stages an 11 x 136
# input window for the blur.
LD_TILE_H = 4
LD_TILE_W = 64
LD_SPAN = 2 * LD_TILE_W + 8


def level_down_plan(
    c_gray: int, c_depth: int, h: int, w: int,
    gray_aligned: bool = True, depth_aligned: bool = True,
) -> dict:
    """The launch of K2 over (c_gray, h, w) gray and (c_depth, h, w) depth
    channels: `grid` = (column tiles, row tiles, channels), the window's
    `rows` and `span`, and `vec_gray` / `vec_depth`: whether that tensor
    takes 16-byte accesses (a width that is a multiple of 4, and pointers
    that `*_aligned` says allow them) or the 4-byte loader."""
    if h % 2 or w % 2:
        raise ValueError(f"level_down_plan: needs even H and W, got {(h, w)}")
    h2, w2 = h // 2, w // 2
    grid = (-(-w2 // LD_TILE_W), -(-h2 // LD_TILE_H), c_gray + c_depth)
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"level_down_plan: grid {grid} exceeds the launch limits")
    return dict(grid=grid, rows=2 * LD_TILE_H + 3, span=LD_SPAN,
                vec_gray=bool(gray_aligned and w % 4 == 0),
                vec_depth=bool(depth_aligned and w % 4 == 0))


def _check_even_stack(x: torch.Tensor, name: str) -> None:
    """K2's checks (on every device, so the CPU tests see them)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype}")
    if x.ndim != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: needs (C, H, W) with even H and W, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")


def _launch_level_down(gray, depth, circular, min_depth, max_depth, name):
    """One K2 launch over a CUDA gray stack and (or None) a depth stack of
    the same (H, W); returns (gray_out, depth_out or None), views of one
    buffer."""
    c_gray, h, w = gray.shape
    c_depth = 0 if depth is None else depth.shape[0]
    out = torch.empty((c_gray + c_depth, h // 2, w // 2), dtype=gray.dtype, device=gray.device)
    g_out, d_out = out[:c_gray], (None if depth is None else out[c_gray:])
    plan = level_down_plan(
        c_gray, c_depth, h, w,
        gray.data_ptr() % 16 == 0,
        depth is not None and depth.data_ptr() % 16 == 0 and d_out.data_ptr() % 8 == 0,
    )
    lib = _build.load()
    code = _on_device(gray.device, lambda stream: lib.rgbd360_level_down(
        gray.data_ptr(), g_out.data_ptr(), c_gray,
        None if depth is None else depth.data_ptr(),
        None if depth is None else d_out.data_ptr(), c_depth,
        h, w, int(circular), min_depth, max_depth,
        int(plan["vec_gray"]), int(plan["vec_depth"]), stream,
    ))
    _build.check(lib, code, name)
    if out.numel():
        fused_pyr_down.launches += 1
    return g_out, d_out


def _pyr_down(imgs: torch.Tensor, circular: bool, name: str) -> torch.Tensor:
    _check_even_stack(imgs, name)
    if imgs.device.type == "cpu":
        return fused_pyr_down_plain(imgs, circular)
    return _launch_level_down(imgs, None, circular, 0.0, 0.0, name)[0]


def fused_pyr_down(imgs: torch.Tensor) -> torch.Tensor:
    """K2: blur + 2x decimation of a stacked (C, H, W) float32 tensor with
    edge-clamped rows and circular columns, as the Pallas kernel."""
    return _pyr_down(imgs, False, "fused_pyr_down")


def fused_pyr_down_circular(imgs: torch.Tensor) -> torch.Tensor:
    """K2 with circular rows: the pyramid's pyrDown (the banded matmuls of
    `rgbd360_tpu/ops/pyramid.pyr_down`) of a stacked (C, H, W) tensor."""
    return _pyr_down(imgs, True, "fused_pyr_down_circular")


def fused_level_down(
    gray: torch.Tensor, depth: torch.Tensor, min_depth: float, max_depth: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 over a whole level transition, ONE launch: the circular-row
    pyrDown of the (C, H, W) float32 `gray` stack and the 2x2 valid mean
    (min_depth < d < max_depth, 0 where no depth is valid) of the
    (C', H, W) `depth` stack."""
    name = "fused_level_down"
    _check_even_stack(gray, name)
    _check_even_stack(depth, name)
    if depth.device != gray.device or depth.shape[1:] != gray.shape[1:]:
        raise ValueError(
            f"{name}: gray {tuple(gray.shape)} on {gray.device} and depth "
            f"{tuple(depth.shape)} on {depth.device} must share (H, W) and the device"
        )
    if gray.device.type == "cpu":
        return fused_level_down_plain(gray, depth, min_depth, max_depth)
    return _launch_level_down(gray, depth, True, float(min_depth), float(max_depth), name)


fused_pyr_down.launches = 0
