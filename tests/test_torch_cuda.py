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


@pytest.mark.cuda
def test_plane_ba_solve_is_deterministic_on_the_card(cuda):
    """A second planar BA solve is bit-identical (incidence products, no
    atomic scatter-adds), and it recovers the box room's poses."""
    from rgbd360_tpu_torch.ops import se3
    from rgbd360_tpu_torch.slam import plane_ba as B

    rng = np.random.default_rng(0)
    planes = torch.tensor([[1, 0, 0, 3.0], [-1, 0, 0, 3.0], [0, 1, 0, 1.5], [0, -1, 0, 1.5],
                           [0, 0, 1, 4.0], [0, 0, -1, 4.0]], device="cuda")
    step = se3.se3_exp(torch.tensor([0.25, 0.02, 0.1, 0.01, 0.06, 0.0], device="cuda"))
    gt = [torch.eye(4, device="cuda")]
    for _ in range(5):
        gt.append(gt[-1] @ step)
    gt = torch.stack(gt)
    obs_kf = torch.arange(6, device="cuda").repeat_interleave(6)
    obs_pl = torch.arange(6, device="cuda").repeat(6)
    obs = B.predict_plane(gt[obs_kf], planes[obs_pl])
    noise = torch.from_numpy(rng.normal(0, 0.05, (6, 6)).astype(np.float32)).cuda()
    poses0 = se3.se3_exp(noise) @ gt
    poses0[0] = gt[0]
    prob = B.PlaneBAProblem(poses0, planes + 0.02, obs_kf, obs_pl, obs,
                            torch.full((36,), 100.0, device="cuda"))
    first, second = B.optimize_plane_ba(prob, 15), B.optimize_plane_ba(prob, 15)
    assert all(torch.equal(a, b) for a, b in zip(first[:3], second[:3])) and first[3] == second[3]
    assert float(torch.linalg.norm(first[0][:, :3, 3] - gt[:, :3, 3], dim=1).max()) < 1e-3


@pytest.mark.cuda
def test_slot_eigh_is_finite_on_degenerate_matrices(cuda):
    """The card's batched `eigh` on the padding's all-zero scatter matrices
    and a one-point segment's: through `_slot_eigh`, finite, and the
    padding's eigenvectors are the identity's (as LAPACK gives the
    reference)."""
    from rgbd360_tpu_torch.ops import segmentation as S

    cov = torch.zeros((8, 16, 3, 3), device="cuda")
    p = torch.tensor([1.3, -0.4, 2.2], device="cuda")
    cov[:, 1] = torch.outer(p, p) - torch.outer(p, p)
    count = torch.zeros((8, 16), device="cuda")
    count[:, 1] = 1.0
    val, vec = S._slot_eigh(cov, count)
    assert torch.isfinite(val).all() and torch.isfinite(vec).all()
    assert torch.equal(vec[:, 0], torch.eye(3, device="cuda").expand(8, 3, 3))
    assert torch.equal(val[:, 0], torch.zeros((8, 3), device="cuda"))


# ------------------------------------------------- the GN trip's CUDA graphs
#
# The dense solves replay each GN trip (and each `coarse_align` call) from a
# CUDA graph.  Each case runs a solve on the graph path, first on an empty
# cache (capture) and then again on new data of the same shapes (replay),
# and holds both to the eager loop on the same inputs bit for bit.


def _graph_sphere(seed, h=320, w=1920):
    """A textured sphere on the card and the same sphere turned by two
    columns with sensor noise: two (gray, depth) pairs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ph = rng.uniform(0, 2 * np.pi, 3)
    gray = (0.5 + 0.25 * np.sin(xx * 0.035 + ph[0]) + 0.2 * np.cos(yy * 0.045 + ph[1])
            + 0.1 * np.sin((xx + yy) * 0.02 + ph[2]))
    depth = 3.0 + 0.8 * np.sin(xx * 0.025 + ph[1]) + 0.5 * np.cos(yy * 0.03 + ph[2])
    gray2 = np.roll(gray, 2, axis=1) + rng.normal(0, 0.002, (h, w))
    return [(torch.tensor(g, dtype=torch.float32, device="cuda"),
             torch.tensor(d, dtype=torch.float32, device="cuda"))
            for g, d in ((gray, depth), (gray2, np.roll(depth, 2, axis=1)))]


def _graph_seeds(seed, n):
    from rgbd360_tpu_torch.ops import se3

    xi = np.random.default_rng(50 + seed).normal(0, 0.01, (n, 6)).astype(np.float32)
    return se3.se3_exp(torch.tensor(xi, device="cuda"))


def _graph_case(name, seed):
    """(aligner, solve) of one case over the data of `seed`."""
    import dataclasses

    from rgbd360_tpu_torch.config import DenseRegConfig
    from rgbd360_tpu_torch.registration import dense as D

    (g1, d1), (g2, d2) = _graph_sphere(seed)
    base = DenseRegConfig()
    if name == "single":
        al = D.DenseAligner(base)
        src, trg = D.build_frame_pyramid(g2, d2, base), D.build_frame_pyramid(g1, d1, base)
        return lambda: al.align(src, trg, _graph_seeds(seed, 1)[0])
    if name == "verify3":  # the loop closer's verification: salient sweeps, dense polish
        cfg = dataclasses.replace(base, salient_pixels=16384, polish_iters=2)
        n, lv = 3, 0
    else:  # "connect6": the keyframe event's connection batch, one level down
        lv = 1
        cfg = dataclasses.replace(base, pyramid_levels=base.pyramid_levels - lv)
        n = 6
    al = D.DenseAligner(cfg)
    src = D.pyramid_tail(D.build_frame_pyramid(g2, d2, base), lv)
    trgs = [D.pyramid_tail(D.build_frame_pyramid(g1 + 0.01 * i, d1, base), lv) for i in range(n)]
    seeds = list(_graph_seeds(seed, n))
    return lambda: D.batch_align_targets_dispatch(al, src, trgs, seeds)


def _eager(monkeypatch):
    """Send the dense solves through the eager closure loop (`_gn_loop`),
    as the rig aligner runs it."""
    from rgbd360_tpu_torch.registration import dense as D

    def level(src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method, occlusion, intr,
              max_iters):
        def sweep(cand):
            return D._hess_grad_packed(src_gray, pts, valid_src, trg_pack, cand, cfg, method,
                                       occlusion, intr)

        return D._gn_loop(sweep, pose, ill, cfg, max_iters,
                          D._stats0(method, pose.shape[:-2], pose.device))

    monkeypatch.setattr(D, "_gn_level", level)


def _result_tensors(res):
    return {k: v.clone() for k, v in vars(res).items() if isinstance(v, torch.Tensor)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["single", "verify3", "connect6"])
def test_gn_graph_equals_the_eager_loop(cuda, monkeypatch, name):
    """Captured on the first solve, replayed on the second (other pyramids
    and seeds, the same shapes): each equals the eager loop on its own
    inputs bit for bit (pose, Hessian, errors, iterations, flags,
    statistics), in as many trips, every one replayed; the first result
    is untouched by the second solve."""
    from rgbd360_tpu_torch.registration import dense as D

    D._GRAPHS.clear()
    solves = [_graph_case(name, seed) for seed in (0, 1)]
    c0 = D.GN_COUNTS["capture"]
    first = solves[0]()
    held = _result_tensors(first)
    captured = D.GN_COUNTS["capture"] - c0
    second = solves[1]()
    torch.cuda.synchronize()
    assert captured >= 2 and D.GN_COUNTS["capture"] - c0 == captured
    with monkeypatch.context() as m:
        _eager(m)
        want = [solve() for solve in solves]
    for got, ref in zip((first, second), want):
        assert got.replays == got.sweeps == ref.sweeps > 0 and ref.replays == 0
        for k, v in _result_tensors(ref).items():
            assert torch.equal(getattr(got, k), v), (name, k)
    for k, v in held.items():
        assert torch.equal(getattr(first, k), v), k
    assert not torch.equal(first.pose, second.pose)


@pytest.mark.cuda
def test_coarse_align_graph_equals_the_eager_loop(cuda):
    """`coarse_align` over the 16-hypothesis yaw grid, one replay a call,
    against `_coarse_refine` run eagerly on the same inputs, over two data
    sets of the same shapes."""
    from rgbd360_tpu_torch.config import DenseRegConfig
    from rgbd360_tpu_torch.ops import se3
    from rgbd360_tpu_torch.registration import dense as D

    D._GRAPHS.clear()
    cfg = DenseRegConfig()
    al = D.DenseAligner(cfg)
    cands = torch.as_tensor(se3.yaw_grid(16), dtype=torch.float32, device="cuda")
    runs = []
    for seed in (0, 1):
        (g1, d1), (g2, d2) = _graph_sphere(seed)
        src, trg = D.build_frame_pyramid(g2, d2, cfg), D.build_frame_pyramid(g1, d1, cfg)
        c0 = D.GN_COUNTS["coarse"]
        got = al.coarse_align(src, trg, cands)
        assert D.GN_COUNTS["coarse"] == c0 + 1
        runs.append((got, src, trg))
    held = [x.clone() for x in runs[0][0]]
    for got, src, trg in runs:
        (g, pts, valid, pack), _ = al._coarsest(src, trg)
        want = D._coarse_refine(dict(src_gray=g, pts=pts, valid_src=valid, trg_pack=pack),
                                cands, cfg, D.PHOTO_DEPTH, 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], held))


@pytest.mark.cuda
def test_gn_graph_captures_inside_a_profiler_session(cuda, monkeypatch):
    """A batch first seen inside a `torch.profiler` session is captured
    there, and the profile sees its replays' kernels."""
    from torch.profiler import ProfilerActivity, profile

    from rgbd360_tpu_torch.registration import dense as D

    D._GRAPHS.clear()
    solve = _graph_case("verify3", 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = solve()
        torch.cuda.synchronize()
    assert got.replays == got.sweeps > 0
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    with monkeypatch.context() as m:
        _eager(m)
        want = solve()
    for k, v in _result_tensors(want).items():
        assert torch.equal(getattr(got, k), v), k
