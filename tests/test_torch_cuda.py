"""The port's CUDA kernels against their plain versions, on the card.

This file imports torch only, so it also runs on a machine without jax:

    RGBD360_TEST_TPU=1 python -m pytest -p no:cacheprovider tests/test_torch_cuda.py

(`RGBD360_TEST_TPU=1` keeps tests/conftest.py from setting up jax.)  Where
`torch.cuda.is_available()` is False every test skips with its reason.
"""

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch.ops import hopper_kernels as HK


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")


def _plateau_image(rng, shape):
    x = rng.uniform(0.0, 4.0, shape)
    x = np.where(rng.uniform(size=shape) < 0.3, np.round(x), x)
    x = np.where(rng.uniform(size=shape) < 0.1, 0.0, x)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 320, 1920), (8, 20, 120), (1, 3, 5)])
def test_fused_gradients_kernel_matches_plain(cuda, shape):
    x = _plateau_image(np.random.default_rng(0), shape).cuda()
    before = HK.fused_gradients.launches
    gx, gy = HK.fused_gradients(x)
    px, py = HK.fused_gradients_plain(x)
    torch.cuda.synchronize()
    assert HK.fused_gradients.launches == before + 1
    assert torch.equal(gx, px) and torch.equal(gy, py)


@pytest.mark.cuda
def test_fused_gradients_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        HK.fused_gradients(x.double())
    with pytest.raises(ValueError):
        HK.fused_gradients(x[:, :, ::2])
    with pytest.raises(ValueError):
        HK.fused_gradients(x[0])


@pytest.mark.cuda
@pytest.mark.parametrize("circular", [False, True], ids=["edge", "circular"])
@pytest.mark.parametrize("shape", [(4, 320, 1920), (1, 40, 240), (2, 6, 8)])
def test_fused_pyr_down_kernel_matches_plain(cuda, shape, circular):
    x = _plateau_image(np.random.default_rng(1), shape).cuda()
    kernel = HK.fused_pyr_down_circular if circular else HK.fused_pyr_down
    before = HK.fused_pyr_down.launches
    out = kernel(x)
    ref = HK.fused_pyr_down_plain(x, circular)
    torch.cuda.synchronize()
    assert HK.fused_pyr_down.launches == before + 1
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_fused_pyr_down_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        HK.fused_pyr_down(x.double())
    with pytest.raises(ValueError):
        HK.fused_pyr_down(torch.zeros((2, 8, 16), device="cuda")[:, :, ::2])
    with pytest.raises(ValueError):
        HK.fused_pyr_down_circular(torch.zeros((2, 7, 8), device="cuda"))
    with pytest.raises(ValueError):
        HK.fused_pyr_down(x[0])


def _depth_image(rng, shape):
    d = rng.uniform(0.0, 25.0, shape)
    d = np.where(rng.uniform(size=shape) < 0.2, 0.0, d)
    return torch.from_numpy(d.astype(np.float32))


def _misaligned(x):
    """A contiguous CUDA copy of x at a pointer that is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


AWKWARD_K1 = [(3, 22, 36), (1, 6, 6), (5, 38, 124), (2, 9, 131), (1, 3, 5), (2, 33, 130)]
AWKWARD_K2 = [(3, 22, 36), (1, 6, 6), (5, 38, 124), (2, 10, 264), (2, 10, 134), (1, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", AWKWARD_K1, ids=str)
def test_fused_gradients_awkward_shapes(cuda, shape, misaligned):
    """Tiles' ragged edges, widths that are no multiple of 4 and pointers
    that are not 16-byte aligned (the one-pixel instantiation), with and
    without a mask."""
    rng = np.random.default_rng(2)
    x = _plateau_image(rng, shape).cuda()
    x = _misaligned(x) if misaligned else x
    mask = torch.from_numpy(rng.uniform(size=shape[1:]) > 0.1).cuda()
    for m in (None, mask):
        ref = HK.fused_gradients_plain(x, m)
        got = HK.fused_gradients(x, m)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_gradients_levels_is_one_launch(cuda, b, masked):
    """The grouped launch over a whole pyramid (10 stacks), bit-equal to
    its plain version and counted once."""
    rng = np.random.default_rng(3)
    shapes = [(320, 1920), (160, 960), (80, 480), (40, 240), (20, 120)]
    stacks = [_plateau_image(rng, (b, *hw)).cuda() for hw in shapes for _ in range(2)]
    masks = None
    if masked:
        masks = [torch.from_numpy(rng.uniform(size=hw) > 0.05).cuda()
                 for hw in shapes for _ in range(2)]
    before = HK.fused_gradients.launches
    got = HK.fused_gradients_levels(stacks, masks)
    ref = HK.fused_gradients_levels_plain(stacks, masks)
    torch.cuda.synchronize()
    assert HK.fused_gradients.launches == before + 1
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert torch.equal(gx, rx) and torch.equal(gy, ry)


@pytest.mark.cuda
def test_fused_gradients_extreme_operands(cuda):
    """Denormal, huge, infinite and NaN differences leave the fast
    reciprocal's range: those rows take IEEE division, bit-equal to plain."""
    vals = torch.tensor([0.0, 1e-40, 2e-40, 1e-30, 3e-30, 1e30, 3e38, float("inf"), 1.0,
                         float("nan"), 2.0, 1e-45, 5.0, -1e-39, 0.5, 1e25, -3e38, 7.0])
    x = vals.repeat(7)[:120].reshape(1, 6, 20).contiguous().cuda()
    got, ref = HK.fused_gradients(x), HK.fused_gradients_plain(x)
    for a, b in zip(got, ref):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a, nan=1.0), torch.nan_to_num(b, nan=1.0))


@pytest.mark.cuda
def test_fast_reciprocal_is_ieee_division_on_its_whole_range(cuda):
    assert HK.check_fast_reciprocal() == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", AWKWARD_K2 + [(1, 320, 1920), (4, 40, 240)], ids=str)
def test_fused_level_down_kernel_matches_plain(cuda, shape, misaligned):
    """One launch for the gray's pyrDown and the depth's valid mean, at path
    and awkward shapes, both loaders."""
    rng = np.random.default_rng(4)
    g, d = _plateau_image(rng, shape).cuda(), _depth_image(rng, shape).cuda()
    if misaligned:
        g, d = _misaligned(g), _misaligned(d)
    rg, rd = HK.fused_level_down_plain(g, d, 0.3, 20.0)
    before = HK.fused_pyr_down.launches
    g2, d2 = HK.fused_level_down(g, d, 0.3, 20.0)
    torch.cuda.synchronize()
    assert HK.fused_pyr_down.launches == before + 1
    assert torch.equal(g2, rg) and torch.equal(d2, rd)
    for circular, fn in ((False, HK.fused_pyr_down), (True, HK.fused_pyr_down_circular)):
        assert torch.equal(fn(g), HK.fused_pyr_down_plain(g, circular))


@pytest.mark.cuda
def test_kf_pyramid_without_seam_masks_matches_plain(cuda):
    """A keyframe pyramid rebuilt from the map's bfloat16 payload goes
    through K1 and K2 WITHOUT seam masks (1 + 4 launches) and equals the
    kernels' plain versions bit for bit."""
    import dataclasses

    from rgbd360_tpu_torch import synthetic
    from rgbd360_tpu_torch.slam.loop_closure import LoopCloser
    from rgbd360_tpu_torch.slam.map import Map360

    cfg = synthetic.config()
    rng = np.random.default_rng(3)
    h, w = cfg.sphere.height, cfg.sphere.width
    m = Map360.empty(dataclasses.replace(cfg.map, max_keyframes=2, max_edges=4), h, w,
                     cfg.seg.max_planes, cfg.seg.hull_dirs, "cuda")
    m.gray[1] = _plateau_image(rng, (h, w)).cuda().mul(60).to(torch.bfloat16)
    depth = torch.from_numpy(rng.uniform(0.0, 22.0, (h, w)).astype(np.float32))
    m.depth[1] = torch.where(depth < 1.0, 0.0, depth).cuda().to(torch.bfloat16)
    closer = LoopCloser(cfg)
    k1, k2 = HK.fused_gradients.launches, HK.fused_pyr_down.launches
    pyr = closer.kf_pyramid(m, 1)
    assert HK.fused_gradients.launches == k1 + 1 and HK.fused_pyr_down.launches == k2 + 4
    saved = HK.fused_gradients_levels, HK.fused_level_down
    HK.fused_gradients_levels, HK.fused_level_down = (
        HK.fused_gradients_levels_plain, HK.fused_level_down_plain)
    try:
        plain = closer.kf_pyramid(m, 1)
    finally:
        HK.fused_gradients_levels, HK.fused_level_down = saved
    assert HK.fused_gradients.launches == k1 + 1  # the plain run launched nothing
    for f in dataclasses.fields(pyr):
        for a, b in zip(getattr(pyr, f.name), getattr(plain, f.name)):
            assert torch.equal(a, b), f.name
    # no seam mask, but the uniform seam columns are zeroed
    assert (pyr.gray_gx[0][:, :: w // 8] == 0).all() and pyr.gray_gx[0].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pcg", [False, True], ids=["dense", "pcg"])
def test_pose_graph_solve_is_deterministic_on_the_card(cuda, pcg):
    """A second solve of the same graph is bit-identical: the per-edge
    blocks are assembled by matrix products, not by atomic scatter-adds."""
    from rgbd360_tpu_torch import convert, synthetic
    from rgbd360_tpu_torch.slam import graph as G

    leaves, loop_mask, _ = synthetic.ring_graph(48, 64, 512)
    g = convert.pose_graph_from_numpy(leaves, "cuda")
    lm = torch.from_numpy(loop_mask).cuda()
    solve = G.optimize_pose_graph_pcg if pcg else G.optimize_pose_graph
    first, second = solve(g, 10, loop_mask=lm), solve(g, 10, loop_mask=lm)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert first[2] == second[2] and float(first[1]) < 0.01 * float(G.graph_chi2(g))
    h1 = G._graph_normal_equations(g.poses, g, (lm, 10.0))
    h2 = G._graph_normal_equations(g.poses, g, (lm, 10.0))
    assert all(torch.equal(a, b) for a, b in zip(h1, h2))
