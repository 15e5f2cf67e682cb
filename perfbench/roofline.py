"""The card's peaks and the bytes the alignment pyramid must move.

Frozen copies (repository commit e7cf3fe) of `chip_smoke.py`'s
`HBM_BYTES_PER_S`, `FP32_FLOPS_PER_S`, `_bound` and `_k1_bytes`, and of its
K2 byte count (each level transition reads the level's gray and depth and
writes the next level's, 4 bytes a pixel), taken from shapes alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 operations/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could
    take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def level_shapes(height: int, width: int, levels: int) -> list[tuple[int, int]]:
    """(H, W) of every level of a pyramid whose level 0 is H x W."""
    return [(height >> lvl, width >> lvl) for lvl in range(levels)]


def k1_bytes(shapes, stacks_per_level: int = 2, masked: bool = True) -> int:
    """K1 over a pyramid's levels: every pixel of the gray and depth stacks
    read once and its two gradients written once (float32), and each
    level's mask, which its stacks share, read once (one byte a pixel)."""
    pixels = sum(h * w for h, w in shapes)
    return 3 * 4 * stacks_per_level * pixels + (pixels if masked else 0)


def k2_bytes(shapes) -> int:
    """K2 over a pyramid's level transitions: each level's gray and depth
    read (4 bytes a pixel each) and the next level's written."""
    return sum(2 * 4 * h * w + 2 * 4 * (h // 2) * (w // 2) for h, w in shapes[:-1])


def pyramid_bytes(height: int, width: int, levels: int) -> int:
    """Bytes one frame's alignment pyramid must move (K2 down the levels,
    then K1 over every level)."""
    shapes = level_shapes(height, width, levels)
    return k1_bytes(shapes) + k2_bytes(shapes)
