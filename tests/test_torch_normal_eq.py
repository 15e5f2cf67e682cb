"""The dense sweep's normal equations (`hopper_kernels.normal_equations`)
on the CPU, where the wrapper runs its plain version.

The plain version and the sweep around it (`dense._hess_grad_packed`) are
held bit for bit to the sweep's code from before the kernel (kept below:
`_old_accumulate` and `_old_hess_grad_packed`, their arithmetic verbatim);
a masked pixel whose Jacobian prefix or point is not finite reaches no sum;
the wrapper refuses what the kernel does not take; and off the card no GN
trip counts as swept by the kernel.  The kernel itself is held to the plain
version on the card (`tests/test_torch_cuda.py`)."""

import math

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import hopper_kernels as HK, se3
from rgbd360_tpu_torch.registration import dense as D

CFG = DenseRegConfig(pyramid_levels=3)
SHAPES = {"sphere": (64, 384), "pinhole": (48, 64)}
METHODS = {"photo": D.PHOTO_CONSISTENCY, "depth": D.DEPTH_CONSISTENCY,
           "photo_depth": D.PHOTO_DEPTH}
PREFIXES = {"photo": ("photo",), "depth": ("depth",), "photo_depth": ("photo", "depth")}


def _old_accumulate(tp, t, a_of, batch):
    """The sums of `_hess_grad_packed` before the kernel, verbatim: `t`
    holds each term's `_w`, `_mask`, `_res` and `visible` over (*batch,
    pixels...), `a_of` each term's Jacobian prefix."""

    def flat(x):  # (*batch, pixels...) -> (*batch, N)
        return x.reshape(*batch, -1)

    # a @ [I | -skew(tp)] = [a | tp x a]
    def chain_row(a):
        return torch.cat([a, torch.linalg.cross(tp, a, dim=-1)], dim=-1)

    hess = torch.zeros(batch + (6, 6), device=tp.device)
    grad = torch.zeros(batch + (6,), device=tp.device)
    stats = {}

    def accumulate(prefix, a):
        nonlocal hess, grad
        jac = chain_row(a) * t[prefix + "_w"][..., None]
        jac = torch.where(t[prefix + "_mask"][..., None], jac, 0.0)
        jf = jac.reshape(*batch, -1, 6)
        rf = flat(t[prefix + "_res"])
        hess = hess + jf.mT @ jf
        grad = grad + (jf.mT @ rf[..., None])[..., 0]
        stats[prefix + "_sq"] = torch.sum(rf * rf, dim=-1)
        stats[prefix + "_n"] = torch.sum(flat(t[prefix + "_mask"]), dim=-1)

    for prefix, a in a_of.items():
        accumulate(prefix, a)
    stats["visible"] = torch.sum(flat(t["visible"]), dim=-1)
    return hess, grad, stats


def _old_hess_grad_packed(src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion=0,
                          intr=None):
    """`_hess_grad_packed` before the kernel, verbatim but for its sums in
    `_old_accumulate`."""
    t = D._residual_terms(
        src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion, intr
    )
    tp = t["tp"]
    if intr is None:
        jproj = D._proj_jacobian(tp, trg_pack.shape[-2])  # (..., 2, 3)
    else:
        jproj = D._proj_jacobian_pinhole(tp, intr)
    batch = pose.shape[:-2]

    def image_term(gx, gy):
        return gx[..., None] * jproj[..., 0, :] + gy[..., None] * jproj[..., 1, :]

    a_of = {}
    if "photo_res" in t:
        a_of["photo"] = image_term(t["photo_gx"], t["photo_gy"])
    if "depth_res" in t:
        a = image_term(t["depth_gx"], t["depth_gy"])
        if intr is None:
            rho_inv = 1.0 / torch.clamp(t["rho"], min=1e-9)
            a = a - tp * rho_inv[..., None]  # -d|p|/dp term
        else:
            # the pinhole depth measure is z: -dz/dp = -e_z (reference `:991`)
            a = torch.cat([a[..., :2], a[..., 2:] - 1.0], dim=-1)
        a_of["depth"] = a
    hess, grad, stats = _old_accumulate(tp, t, a_of, batch)
    # mean weighted residual sqrt(sum(w r)^2 / n): H, g and error from ONE sweep
    err2 = stats.get("photo_sq", 0.0) + stats.get("depth_sq", 0.0)
    n = stats.get("photo_n", 0) + stats.get("depth_n", 0)
    stats["mean_err"] = torch.sqrt(err2 / torch.clamp(n, min=1))
    return hess, grad, stats


def _random_sweep(rng, batch, hw, prefixes):
    """A sweep's per-pixel terms over (*batch, H, W): points at 1-5 m, a
    prefix of mixed magnitudes, Huber-like weights, residuals 0 where the
    mask is off (as the sweep gives them)."""
    pix = tuple(batch) + tuple(hw)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    tp = f32(rng.normal(0, 1, pix + (3,)) * rng.uniform(1, 5, pix + (1,)))
    t = {"visible": torch.from_numpy(rng.uniform(size=pix) < 0.9)}
    a_of = {}
    for p in prefixes:
        mask = torch.from_numpy(rng.uniform(size=pix) < 0.6) & t["visible"]
        a_of[p] = f32(rng.normal(0, 1, pix + (3,)) * 10.0 ** rng.uniform(-3, 2, pix + (1,)))
        t[p + "_w"] = torch.where(mask, f32(rng.uniform(0.05, 1.0, pix)), 0.0)
        t[p + "_res"] = torch.where(mask, f32(rng.normal(0, 0.1, pix)), 0.0)
        t[p + "_mask"] = mask
    return tp, t, a_of


def _flat_terms(tp, t, a_of, batch):
    """The wrapper's operands: everything flattened to (*batch, N[, 3])."""

    def flat(x, *last):
        return x.reshape(*batch, -1, *last).contiguous()

    terms = {p: (flat(a, 3), flat(t[p + "_w"]), flat(t[p + "_mask"]), flat(t[p + "_res"]))
             for p, a in a_of.items()}
    return flat(tp, 3), terms, flat(t["visible"])


def _assert_same(got, want):
    (h, g, st), (h0, g0, st0) = got, want
    assert torch.equal(h, h0) and torch.equal(g, g0)
    assert list(st) == list(st0)
    for k, v in st0.items():
        assert st[k].dtype == v.dtype and torch.equal(st[k], v), k


@pytest.mark.parametrize("b", [None, 1, 3], ids=["unbatched", "b1", "b3"])
@pytest.mark.parametrize("camera", sorted(SHAPES))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_plain_is_the_old_accumulate(method, camera, b):
    batch = () if b is None else (b,)
    tp, t, a_of = _random_sweep(np.random.default_rng(7), batch, SHAPES[camera],
                                PREFIXES[method])
    want = _old_accumulate(tp, t, a_of, batch)
    args = _flat_terms(tp, t, a_of, batch)
    _assert_same(HK.normal_equations_plain(*args), want)
    launches = HK.normal_equations.launches
    _assert_same(HK.normal_equations(*args), want)
    assert HK.normal_equations.launches == launches  # the CPU launched nothing


def _sweep_inputs(camera, b):
    """(src gray, points, valid, target pack, poses, K) of a textured
    sphere pair at level 0 (K None), or of the same images seen through a
    pinhole K, with b seeds near the truth (one unbatched seed for None)."""
    rng = np.random.default_rng(3)
    h, w = (48, 288) if camera == "sphere" else SHAPES["pinhole"]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    gray = 0.5 + 0.25 * np.sin(xx * 0.35) + 0.2 * np.cos(yy * 0.45 + 1.0)
    depth = 3.0 + 0.8 * np.sin(xx * 0.25) + 0.5 * np.cos(yy * 0.3)
    g1, d1 = (torch.tensor(x, dtype=torch.float32) for x in (gray, depth))
    g2 = torch.tensor(np.roll(gray, 2, axis=1) + rng.normal(0, 0.002, (h, w)),
                      dtype=torch.float32)
    d2 = torch.tensor(np.roll(depth, 2, axis=1), dtype=torch.float32)
    intr = None
    if camera == "pinhole":
        intr = torch.tensor([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1.0]])
    spherical = intr is None
    src = D.build_frame_pyramid(g2, d2, CFG, spherical=spherical)
    trg = D.build_frame_pyramid(g1, d1, CFG, spherical=spherical)
    xi = rng.normal(0, 0.01, (b or 1, 6)).astype(np.float32)
    poses = se3.se3_exp(torch.tensor(xi))
    pts, valid = D._src_points(src.depth[0], CFG, intr)
    pack = D._pack_target(D.DenseAligner._level_dicts(trg, 0), CFG.bilinear, wrap=spherical)
    if b is None:
        return src.gray[0], pts, valid, pack, poses[0], intr
    return (src.gray[0].flatten()[None], pts.reshape(1, -1, 3), valid.flatten()[None], pack,
            poses, intr)


@pytest.mark.parametrize("b", [None, 1, 3], ids=["unbatched", "b1", "b3"])
@pytest.mark.parametrize("camera", sorted(SHAPES))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_hess_grad_packed_is_unchanged_on_the_cpu(method, camera, b):
    src_gray, pts, valid, pack, poses, intr = _sweep_inputs(camera, b)
    args = (src_gray, pts, valid, pack, poses, CFG, METHODS[method], 0, intr)
    got, want = D._hess_grad_packed(*args), _old_hess_grad_packed(*args)
    assert int(want[2]["visible"].sum()) > 0
    _assert_same(got, want)


@pytest.mark.parametrize("what", ["a", "tp"])
@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf])
def test_masked_non_finite_pixels_reach_no_sum(what, bad):
    """A pixel that no term's mask keeps, with a non-finite Jacobian
    prefix or point (and the residual 0 the sweep gives it), adds exactly
    nothing: the sums equal those with that pixel's values zeroed."""
    batch = (2,)
    tp, t, a_of = _random_sweep(np.random.default_rng(11), batch, (16, 24), ("photo", "depth"))
    off = torch.zeros(batch + (16, 24), dtype=torch.bool)
    off[0, 3, 5] = off[1, 10, 0] = off[1, 15, 23] = True
    for p in a_of:
        t[p + "_mask"] &= ~off
        t[p + "_w"] = torch.where(off, 0.0, t[p + "_w"])
        t[p + "_res"] = torch.where(off, 0.0, t[p + "_res"])
    zeroed = {p: torch.where(off[..., None], 0.0, a) for p, a in a_of.items()}
    tp0 = torch.where(off[..., None], 0.0, tp)
    if what == "a":
        spoiled = {p: torch.where(off[..., None], bad, a) for p, a in a_of.items()}
        args, ref = (tp0, t, spoiled), (tp0, t, zeroed)
    else:
        args, ref = (torch.where(off[..., None], bad, tp0), t, zeroed), (tp0, t, zeroed)
    got = HK.normal_equations(*_flat_terms(*args, batch))
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    _assert_same(got, HK.normal_equations(*_flat_terms(*ref, batch)))


def test_normal_equations_refuses_what_the_kernel_does_not_take():
    tp, t, a_of = _random_sweep(np.random.default_rng(5), (2,), (8, 12), ("photo", "depth"))
    tp, terms, vis = _flat_terms(tp, t, a_of, (2,))
    HK.normal_equations(tp, terms, vis)  # as given, taken
    a, w, m, r = terms["photo"]
    with pytest.raises(TypeError):
        HK.normal_equations(tp.double(), terms, vis)
    with pytest.raises(TypeError):
        HK.normal_equations(tp, {"photo": (a, w.double(), m, r)}, vis)
    with pytest.raises(TypeError):
        HK.normal_equations(tp, {"photo": (a, w, m.float(), r)}, vis)
    with pytest.raises(ValueError):  # not contiguous
        HK.normal_equations(tp, {"photo": (a.mT.contiguous().mT, w, m, r)}, vis)
    with pytest.raises(ValueError):
        HK.normal_equations(tp[:, ::2], terms, vis[:, ::2])
    with pytest.raises(ValueError):  # mismatched shapes
        HK.normal_equations(tp, {"photo": (a, w[:1], m, r)}, vis)
    with pytest.raises(ValueError):
        HK.normal_equations(tp, {"photo": (a[..., :2].contiguous(), w, m, r)}, vis)
    with pytest.raises(ValueError):
        HK.normal_equations(tp, terms, vis[:, :-1])
    with pytest.raises(ValueError):  # 1 or 2 terms
        HK.normal_equations(tp, {}, vis)
    with pytest.raises(ValueError):
        HK.normal_equations(tp, dict(terms, extra=terms["photo"]), vis)


def test_no_trip_counts_as_swept_by_the_kernel_off_the_card():
    """Single and batched solves (the graph loop's eager body) and the
    closure loop sweep on the CPU: their trips count, none as the
    kernel's, and nothing launched."""
    src_gray, pts, valid, pack, poses, _ = _sweep_inputs("sphere", 3)
    before, launches = dict(D.GN_COUNTS), HK.normal_equations.launches
    al = D.DenseAligner(CFG)
    rng = np.random.default_rng(0)
    gray = torch.tensor(rng.uniform(0, 1, (48, 288)), dtype=torch.float32)
    depth = torch.tensor(rng.uniform(2, 4, (48, 288)), dtype=torch.float32)
    pyr = D.build_frame_pyramid(gray, depth, CFG)
    al.align(pyr, pyr, poses[0])
    D.batch_align_targets(al, pyr, [pyr, pyr], list(poses[:2]))

    def sweep(cand):
        return D._hess_grad_packed(src_gray, pts, valid, pack, cand, CFG, D.PHOTO_DEPTH)

    D._gn_loop(sweep, poses, torch.zeros(3, dtype=torch.bool), CFG, 3,
               D._stats0(D.PHOTO_DEPTH, (3,), "cpu"))
    assert D.GN_COUNTS["sweep"] - before["sweep"] >= 3
    assert D.GN_COUNTS["normal_eq"] == before["normal_eq"]
    assert HK.normal_equations.launches == launches
