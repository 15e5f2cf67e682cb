"""Dense direct spherical RGB-D alignment (twin of
`rgbd360_tpu/registration/dense.py`).

Coarse-to-fine Gauss-Newton over a pyramid of spherical gray/depth images,
minimizing Huber-weighted photometric and depth residuals:

* residuals:  photo  r_p = I_trg(warp(p)) - I_src(p)
              depth  r_d = D_trg(warp(p)) - |T p|
* weights:    w_p = huber(r_p, s_photo)/s_photo,
              w_d = huber(r_d, s_depth*D_trg)/(s_depth*D_trg)
* jacobians:  J_T = [I | -skew(T p)], chained with the (col, row) spherical
              projection Jacobian and the target's gradients; depth adds
              -p^T/|p| J_T
* stepping:   per level at most `max_iters_per_level` GN steps; a step is
              accepted only if the mean residual drops by `tol_residual`;
              an ill-posed Hessian aborts.

Each GN step evaluates the loop condition on the device and reads it with
one host sync, which gives exactly the reference's `lax.while_loop`
semantics (early exit, accept/reject, the iteration counter).  On a CUDA
card each step replays a CUDA graph of its sweep and update (see "CUDA
graphs" below).

Batches.  The reference vmaps the aligner (the batch pipeline, one source
against several keyframes, a batch of pose hypotheses, the rig's sensors);
here a leading batch axis runs through the pyramid, the sweep and the GN
loop.  Either side of a batched alignment may be shared: an unbatched
pyramid, or one with a batch of 1, is broadcast against the other side,
never copied.  The batched GN loop runs while any element is active, and a
finished element keeps its state, as the vmapped `lax.while_loop` does.

Options, as in the reference: the pinhole path (`DenseAligner(intrinsics=
K)`, the reference's `alignFrames`), validity-weighted bilinear target
sampling (`DenseRegConfig.bilinear`) and the occlusion modes 1 (z-buffer)
and 2 (z-buffer and the dynamic-object mask) of `align`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import camera, pyramid as pyr_ops, se3
from rgbd360_tpu_torch.utils import metrics

PHOTO_CONSISTENCY = 0
DEPTH_CONSISTENCY = 1
PHOTO_DEPTH = 2

_CHANNELS = ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")


@dataclass
class FramePyramid:
    """Multi-scale spherical frame: tuples (level 0 = full resolution) of
    gray (H, W), depth (H, W) and the four gradient images of the residual
    model, pre-masked at sensor seams.  A batch of frames has (B, H, W)
    levels."""

    gray: tuple
    depth: tuple
    gray_gx: tuple
    gray_gy: tuple
    depth_gx: tuple
    depth_gy: tuple


@dataclass
class AlignResult:
    """One alignment's result; a batched alignment's fields carry a
    leading batch axis."""

    pose: torch.Tensor  # (4, 4) relative pose source -> target frame
    hessian: torch.Tensor  # (6, 6) information matrix at the solution
    error: torch.Tensor  # final mean residual at level 0
    av_photo_residual: torch.Tensor
    av_depth_residual: torch.Tensor
    sso: torch.Tensor  # co-visibility ratio
    iters: torch.Tensor  # (levels,) iterations used per level
    ill_posed: torch.Tensor  # bool
    # host count of GN loop trips over the levels and the polish: each is
    # one sweep of the pixels and one host sync (a batch's, for each item)
    sweeps: int = 0
    # of those trips, the ones replayed from a CUDA graph
    replays: int = 0


def pyramid_tail(pyr: FramePyramid, start: int) -> FramePyramid:
    """The same pyramid without its `start` finest levels: lets a caller run
    an aligner configured for fewer levels on coarser data (the keyframe
    event's connection aligns start one level down)."""
    return FramePyramid(**{f: getattr(pyr, f)[start:] for f in _CHANNELS})


def seam_masks_per_level(seam_valid: torch.Tensor, levels: int) -> tuple:
    """The (H, W) seam mask subsampled to every pyramid level."""
    return tuple(
        seam_valid[:: 2**lvl, :: 2**lvl].contiguous() for lvl in range(levels)
    )


def _map_levels(pyr: FramePyramid, fn) -> FramePyramid:
    """A pyramid whose every level tensor is fn(that tensor)."""
    return FramePyramid(
        **{f: tuple(fn(x) for x in getattr(pyr, f)) for f in _CHANNELS}
    )


def is_batch(pyr: FramePyramid) -> bool:
    """Whether the pyramid's levels carry a leading batch axis."""
    return pyr.gray[0].ndim == 3


def stack_pyramids(pyrs) -> FramePyramid:
    """One batched pyramid (B, H, W levels) from B unbatched ones."""
    return FramePyramid(
        **{
            f: tuple(torch.stack(lv) for lv in zip(*(getattr(p, f) for p in pyrs)))
            for f in _CHANNELS
        }
    )


def unstack_pyramid(pyr: FramePyramid) -> list:
    """The B unbatched pyramids (views) of a batched one."""
    return [_map_levels(pyr, lambda x, i=i: x[i]) for i in range(pyr.gray[0].shape[0])]


def _build_pyramid(gray, depth, cfg, seam_valid, num_sensors, spherical):
    """The pyramid of one frame (H, W) or of a batch (B, H, W): one K2
    launch per level transition (gray and depth together), then ONE K1
    launch for the gradients of gray and depth at every level, with the
    seam masks applied in its store."""
    if seam_valid is not None and not isinstance(seam_valid, (tuple, list)):
        seam_valid = seam_masks_per_level(seam_valid, cfg.pyramid_levels)
    levels = [(gray, depth)]
    for _ in range(cfg.pyramid_levels - 1):
        g_c, d_c = levels[-1]
        h, w = g_c.shape[-2:]
        if h % 2 == 0 and w % 2 == 0 and h >= 6 and w >= 6:
            levels.append(pyr_ops.fused_level_down(g_c, d_c, cfg.min_depth, cfg.max_depth))
        else:
            levels.append(
                (pyr_ops.pyr_down(g_c), pyr_ops.pyr_down_depth(d_c, cfg.min_depth, cfg.max_depth))
            )
    stacks, masks = [], None if seam_valid is None else []
    for lvl, (g_l, d_l) in enumerate(levels):
        h, w = g_l.shape[-2:]
        stacks += [g_l.reshape(-1, h, w), d_l.reshape(-1, h, w)]
        if seam_valid is not None:
            m = seam_valid[lvl][:h, :w]  # a 0/1 mask
            masks += [(m if m.dtype == torch.bool else m != 0).contiguous()] * 2
    grads = pyr_ops.gradient_xy_levels(stacks, masks)
    if seam_valid is None and spherical:
        half = max(1, cfg.seam_mask_px // 2)
        grads = [
            tuple(pyr_ops.mask_seams(g, num_sensors, half) for g in pair) for pair in grads
        ]
    shaped = [
        tuple(g.reshape(x.shape) for g in pair)
        for pair, x in zip(grads, (x for level in levels for x in level))
    ]
    return FramePyramid(
        gray=tuple(g for g, _ in levels),
        depth=tuple(d for _, d in levels),
        gray_gx=tuple(gx for gx, _ in shaped[0::2]),
        gray_gy=tuple(gy for _, gy in shaped[0::2]),
        depth_gx=tuple(gx for gx, _ in shaped[1::2]),
        depth_gy=tuple(gy for _, gy in shaped[1::2]),
    )


def build_frame_pyramid(
    gray: torch.Tensor,
    depth: torch.Tensor,
    cfg: DenseRegConfig = DenseRegConfig(),
    seam_valid=None,
    num_sensors: int = 8,
    spherical: bool = True,
) -> FramePyramid:
    """Build the alignment pyramid of one frame.

    seam_valid: optional (H, W) bool mask of trustworthy pixels, or a
    per-level tuple of such masks (`seam_masks_per_level`); if None and
    `spherical`, uniform seam columns are masked."""
    return _build_pyramid(gray, depth, cfg, seam_valid, num_sensors, spherical)


def build_frame_pyramid_batch(
    grays: torch.Tensor,
    depths: torch.Tensor,
    cfg: DenseRegConfig = DenseRegConfig(),
    seam_valid=None,
    num_sensors: int = 8,
) -> FramePyramid:
    """The pyramids of a (B, H, W) batch of frames as one FramePyramid with
    (B, H, W) levels (the reference vmaps the per-frame build and
    row-stacks the level-0 gradients for its Pallas kernel; K1 and K2 take
    the batch as it is)."""
    return _build_pyramid(grays, depths, cfg, seam_valid, num_sensors, True)


# ------------------------------------------------------------------ sweep
#
# The sweep takes one alignment or a batch.  Unbatched: source arrays
# (H, W) or a flat (K,) salient subset, target pack (H, W, C), pose (4, 4).
# Batched: flat source arrays (Bs, N), points (Bs, N, 3), target pack
# (Bt, H, W, C) and poses (B, 4, 4), with Bs and Bt each 1 (shared) or B;
# the statistics then come back per element: (B, 6, 6), (B, 6), (B,).
# C is 6 (nearest sampling) or 24 (bilinear: the 2x2 tap neighbourhood).


def _pack_target(level_trg: dict, bilinear: bool = False, wrap: bool = True):
    """Stack the six target channels into (..., H, W, 6) so each GN sweep
    does one row gather per pixel.  bilinear=True widens each row to 24
    channels, the pixel's 2x2 tap neighbourhood [self | right | down |
    down-right]; `wrap` selects column wraparound (spherical) or edge clamp
    (pinhole); rows always clamp."""
    p = torch.stack([level_trg[k] for k in _CHANNELS], dim=-1)
    if not bilinear:
        return p

    def right_of(x):  # columns are dim -2 of (..., H, W, C)
        if wrap:
            return torch.roll(x, -1, dims=-2)
        return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)

    down = torch.cat([p[..., 1:, :, :], p[..., -1:, :, :]], dim=-3)
    return torch.cat([p, right_of(p), down, right_of(down)], dim=-1)


def _src_points(src_depth: torch.Tensor, cfg: DenseRegConfig, intr=None):
    """Pose-invariant source terms, hoisted out of the GN loop: the points
    of the spherical (intr None) or pinhole (intr (3, 3) K) depth, and
    their validity."""
    if intr is None:
        pts = camera.sphere_backproject(src_depth)
    else:
        pts = camera.pinhole_backproject(src_depth, intr)
    valid_src = (src_depth > cfg.min_depth) & (src_depth < cfg.max_depth)
    return pts, valid_src


def _warp_terms(pose, pts, valid_src, h, w, intr=None, taps: bool = False):
    """Transform all source points and project them to the target pixel
    grid (nearest pixel).  intr None: the spherical projection, `rho` the
    radial range; intr (3, 3) K: the pinhole projection, `rho` the
    z-depth.  With `taps`, also the bilinear floor cell (r0, c0) and the
    in-cell fractions."""
    tp = pts @ pose[..., :3, :3].mT + pose[..., None, :3, 3]
    # round half to even, then truncating casts, as the reference
    if intr is None:
        rc, rho = camera.sphere_project(tp, h, w)
        rf, cf = rc[..., 0], torch.remainder(rc[..., 1], w)
        r_i = torch.round(rc[..., 0]).to(torch.int32)
        c_i = torch.remainder(torch.round(rc[..., 1]).to(torch.int32), w)
        inb = (r_i >= 0) & (r_i < h) & valid_src
    else:
        uv, rho = camera.pinhole_project(tp, intr)
        rf, cf = uv[..., 1], uv[..., 0]
        r_i = torch.round(rf).to(torch.int32)
        c_i = torch.round(cf).to(torch.int32)
        inb = (r_i >= 0) & (r_i < h) & (c_i >= 0) & (c_i < w) & (rho > 1e-6) & valid_src
        c_i = torch.clamp(c_i, 0, w - 1)
    out = dict(tp=tp, rho=rho, r=torch.clamp(r_i, 0, h - 1), c=c_i, visible=inb)
    if taps:
        # floor cell and fractions; where the floor coordinate was clipped
        # into the grid the fraction collapses to 0, so the blend does not
        # move the sample a pixel inward of the nearest sampler's
        r0f, c0f = torch.floor(rf), torch.floor(cf)
        frac_r = torch.where(r0f < 0, 0.0, torch.clamp(rf - r0f, 0.0, 1.0))
        frac_c = torch.where(c0f < 0, 0.0, torch.clamp(cf - c0f, 0.0, 1.0))
        out.update(
            r0=torch.clamp(r0f, 0, h - 1).to(torch.int32),
            c0=torch.clamp(c0f, 0, w - 1).to(torch.int32),
            frac_r=frac_r, frac_c=frac_c,
        )
    return out


def _huber(err: torch.Tensor, scale) -> torch.Tensor:
    """Huber weight (reference `RegisterPhotoICP.h:weightHuber:545`)."""
    a = torch.abs(err)
    w = torch.sqrt(torch.clamp(2.0 * scale * a - scale * scale, min=0.0)) / torch.clamp(
        a, min=1e-12
    )
    return torch.where(a < scale, 1.0, w)


def _gather_rows(trg_pack: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Rows of the target pack at flat pixel indices `lin` (one gather of
    all channels); a per-element target (Bt > 1) is offset into its own
    image."""
    h, w, nch = trg_pack.shape[-3:]
    lin = lin.long()
    if trg_pack.ndim == 4 and trg_pack.shape[0] > 1:
        off = torch.arange(trg_pack.shape[0], device=lin.device) * (h * w)
        lin = lin + off[:, None]
    return trg_pack.reshape(-1, nch)[lin]


def _bilinear_sample(trg_pack: torch.Tensor, wt: dict, cfg) -> torch.Tensor:
    """Validity-weighted bilinear sample of the 24-channel pack: all six
    channels share one weight set from the taps' depth validity; the blend
    falls back to the nearest tap where the valid weight is low or the
    live taps straddle a depth discontinuity (`bilerp_depth_spread`).
    Dropped taps are selected out (torch.where), never multiplied by 0."""
    w = trg_pack.shape[-2]
    tv24 = _gather_rows(trg_pack, wt["r0"] * w + wt["c0"])
    taps = [tv24[..., 6 * i : 6 * i + 6] for i in range(4)]
    fr, fc = wt["frac_r"], wt["frac_c"]
    bw = [(1 - fr) * (1 - fc), (1 - fr) * fc, fr * (1 - fc), fr * fc]
    dtap = [t[..., 1] for t in taps]
    ew = [torch.where(d > 0, b, 0.0) for b, d in zip(bw, dtap)]
    s = ew[0] + ew[1] + ew[2] + ew[3]
    live = [e > 1e-6 for e in ew]  # the taps that carry weight
    hi = [torch.where(lv, d, -math.inf) for lv, d in zip(live, dtap)]
    lo = [torch.where(lv, d, math.inf) for lv, d in zip(live, dtap)]
    dmax = torch.maximum(torch.maximum(hi[0], hi[1]), torch.maximum(hi[2], hi[3]))
    dmin = torch.minimum(torch.minimum(lo[0], lo[1]), torch.minimum(lo[2], lo[3]))
    spread_ok = (dmax - dmin) <= torch.clamp(cfg.bilerp_depth_spread * dmax, min=0.05)
    blend_ok = (s > 0.5) & spread_ok
    terms = [torch.where((e > 0)[..., None], e[..., None] * t, 0.0) for e, t in zip(ew, taps)]
    blended = (terms[0] + terms[1] + terms[2] + terms[3]) / torch.clamp(s, min=1e-6)[..., None]
    left, top = (fc < 0.5)[..., None], (fr < 0.5)[..., None]
    near = torch.where(
        top, torch.where(left, taps[0], taps[1]), torch.where(left, taps[2], taps[3])
    )
    return torch.where(blend_ok[..., None], blended, near)


def _occluded(wt: dict, h: int, w: int, batch: tuple) -> torch.Tensor:
    """The z-buffer test of occlusion modes 1 and 2: a visible point that
    lies more than 5 cm behind the nearest point projecting to its target
    pixel is occluded.  The z-buffer is a scatter-min over the NEAREST
    pixel index (in both sampling modes), one buffer per element of a
    batch; a min is order-independent, so the result is deterministic."""
    lin = (wt["r"] * w + wt["c"]).long()
    n = 1
    if batch:
        n = batch[0]
        lin = lin + (torch.arange(n, device=lin.device) * (h * w))[:, None]
    rho = wt["rho"].expand(lin.shape)
    rho_w = torch.where(wt["visible"], rho, math.inf)
    zbuf = torch.full((n * h * w,), math.inf, device=rho.device).scatter_reduce(
        0, lin.reshape(-1), rho_w.reshape(-1), "amin"
    )
    return rho > zbuf[lin] + 0.05


def _residual_terms(
    src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion=0, intr=None
):
    """Per-pixel weighted residuals and masks for one pyramid level.
    occlusion=1 adds the z-buffer test (the reference's `_sphereOcc1` /
    `_Occ1` variants); occlusion=2 also drops depth residuals beyond the
    0.3 m outlier threshold (moving objects) and reports them as
    `dynamic_mask`."""
    h, w, nch = trg_pack.shape[-3:]
    wt = _warp_terms(pose, pts, valid_src, h, w, intr, taps=nch == 24)
    if nch == 24:
        tvp = _bilinear_sample(trg_pack, wt, cfg)
    else:
        tvp = _gather_rows(trg_pack, wt["r"] * w + wt["c"])
    tv = [tvp[..., k] for k in range(6)]
    visible = wt["visible"]
    if occlusion >= 1:
        visible = visible & ~_occluded(wt, h, w, pose.shape[:-2])

    out = dict(visible=visible, tp=wt["tp"], rho=wt["rho"])
    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        gx, gy = tv[2], tv[3]
        salient = (torch.abs(gx) >= cfg.sal_intensity) | (torch.abs(gy) >= cfg.sal_intensity)
        diff = tv[0] - src_gray
        w_p = _huber(diff, cfg.std_photo) / cfg.std_photo
        m = visible & salient
        out.update(
            photo_res=torch.where(m, w_p * diff, 0.0),
            photo_w=torch.where(m, w_p, 0.0),
            photo_mask=m,
            photo_gx=gx,
            photo_gy=gy,
        )
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        d2, dgx, dgy = tv[1], tv[4], tv[5]
        salient = (torch.abs(dgx) >= cfg.sal_depth) | (torch.abs(dgy) >= cfg.sal_depth)
        has_d = d2 > 0
        diff = d2 - wt["rho"]
        s = cfg.std_depth * torch.clamp(d2, min=1e-3)
        w_d = _huber(diff, s) / s
        m = visible & salient & has_d
        if occlusion >= 2:
            # dynamic-object / outlier rejection (thresDepthOutliers = 0.3,
            # reference `alignFrames360:4525`)
            dynamic = torch.abs(diff) > 0.3
            m = m & ~dynamic
            out["dynamic_mask"] = dynamic & visible & has_d
        out.update(
            depth_res=torch.where(m, w_d * diff, 0.0),
            depth_w=torch.where(m, w_d, 0.0),
            depth_mask=m,
            depth_gx=dgx,
            depth_gy=dgy,
        )
    return out


def _proj_jacobian(tp: torch.Tensor, w: int) -> torch.Tensor:
    """J of (col, row) with respect to the 3D point, (..., 2, 3)."""
    res_inv = w / (2.0 * math.pi)
    x, y, z = tp[..., 0], tp[..., 1], tp[..., 2]
    rho2 = x * x + y * y + z * z
    rho = torch.sqrt(torch.clamp(rho2, min=1e-12))
    rho_inv = 1.0 / rho
    z_s = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    z_inv = 1.0 / z_s
    d_atan = res_inv / (1.0 + (y * z_inv) ** 2)
    j00 = torch.zeros_like(x)
    j01 = d_atan * z_inv
    j02 = -y * z_inv * z_inv * d_atan
    x_r2 = x / torch.clamp(rho2, min=1e-12)
    d_asin = res_inv / torch.sqrt(torch.clamp(1.0 - x * x_r2, min=1e-9))
    j10 = -d_asin * rho_inv * (1.0 - x * x_r2)
    j11 = d_asin * x_r2 * y * rho_inv
    j12 = d_asin * x_r2 * z * rho_inv
    return torch.stack(
        [torch.stack([j00, j01, j02], -1), torch.stack([j10, j11, j12], -1)], dim=-2
    )


def _proj_jacobian_pinhole(tp: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """J of (col=u, row=v) with respect to the 3D point for a pinhole
    camera (reference `calcHessGrad:776`), (..., 2, 3)."""
    x, y, z = tp[..., 0], tp[..., 1], tp[..., 2]
    z_s = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    z_inv = 1.0 / z_s
    fx, fy = intr[0, 0], intr[1, 1]
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1)
    row_v = torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _hess_grad(level_src, level_trg, pose, cfg, method, occlusion=0, intr=None):
    """The 6x6 normal equations of one level from its source and target
    level dicts (`_src_points` and `_pack_target`, then the sweep)."""
    pts, valid_src = _src_points(level_src["depth"], cfg, intr)
    return _hess_grad_packed(
        level_src["gray"], pts, valid_src,
        _pack_target(level_trg, cfg.bilinear, wrap=intr is None), pose, cfg,
        method, occlusion, intr,
    )


def _hess_grad_packed(
    src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion=0, intr=None
):
    """The 6x6 normal equations, gradient and residual statistics of one
    GN iteration (one pixel sweep), per element of a batch of poses."""
    t = _residual_terms(
        src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion, intr
    )
    tp = t["tp"]
    if intr is None:
        jproj = _proj_jacobian(tp, trg_pack.shape[-2])  # (..., 2, 3)
    else:
        jproj = _proj_jacobian_pinhole(tp, intr)
    batch = pose.shape[:-2]

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

    def image_term(gx, gy):
        return gx[..., None] * jproj[..., 0, :] + gy[..., None] * jproj[..., 1, :]

    if "photo_res" in t:
        accumulate("photo", image_term(t["photo_gx"], t["photo_gy"]))
    if "depth_res" in t:
        a = image_term(t["depth_gx"], t["depth_gy"])
        if intr is None:
            rho_inv = 1.0 / torch.clamp(t["rho"], min=1e-9)
            a = a - tp * rho_inv[..., None]  # -d|p|/dp term
        else:
            # the pinhole depth measure is z: -dz/dp = -e_z (reference `:991`)
            a = torch.cat([a[..., :2], a[..., 2:] - 1.0], dim=-1)
        accumulate("depth", a)

    stats["visible"] = torch.sum(flat(t["visible"]), dim=-1)
    # mean weighted residual sqrt(sum(w r)^2 / n): H, g and error from ONE sweep
    err2 = stats.get("photo_sq", 0.0) + stats.get("depth_sq", 0.0)
    n = stats.get("photo_n", 0) + stats.get("depth_n", 0)
    stats["mean_err"] = torch.sqrt(err2 / torch.clamp(n, min=1))
    return hess, grad, stats


def _stats0(method: int, batch: tuple, device) -> dict:
    f = torch.zeros(batch, device=device)
    i = torch.zeros(batch, dtype=torch.int64, device=device)
    st = {"mean_err": f, "visible": i}
    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        st.update(photo_sq=f, photo_n=i)
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        st.update(depth_sq=f, depth_n=i)
    return st


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-element (batch-shaped) mask."""
    extra = max(a.ndim, b.ndim) - mask.ndim
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, b)


def _solve_step(hess: torch.Tensor, grad: torch.Tensor):
    """(bad, GN update) under the observability guard (reference
    `:4682-4690`): an ill-posed or non-finite Hessian solves with the
    identity instead."""
    bad = (torch.linalg.det(hess) < 1e-12) | ~torch.isfinite(hess).flatten(-2).all(-1)
    eye6 = torch.eye(6, device=hess.device)
    update = -torch.linalg.solve_ex(_where(bad, eye6, hess), grad[..., None])[0][..., 0]
    return bad, update


def _gn_level(
    src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method, occlusion,
    intr, max_iters,
):
    """One pyramid level of Gauss-Newton with accept-if-improved stepping
    (a rejected step exits the level).  Returns (pose, err, iters, ill,
    hessian, stats), where hessian/stats come from the last ACCEPTED
    evaluation: at exit they describe the final pose.  On a CUDA card each
    trip replays a CUDA graph (`_gn_graph_loop`)."""
    inputs = dict(src_gray=src_gray, pts=pts, valid_src=valid_src, trg_pack=trg_pack)
    if intr is not None:
        inputs["intr"] = intr
    return _gn_graph_loop(inputs, pose, ill, cfg, method, occlusion, max_iters)


# Since import: GN loop trips (`sweep`), the trips replayed from a CUDA
# graph (`replay`), the graphs captured (`capture`) and the `coarse_align`
# calls replayed (`coarse`).  A solve's `sweeps` and `replays` are what it
# adds (the host runs one solve at a time); a tracker adds each to its
# timer's `gn_graph.<name>` count.
GN_COUNTS = {"sweep": 0, "replay": 0, "capture": 0, "coarse": 0}


def _gn_start(pose, ill, st_best, cfg, max_iters) -> dict:
    """The GN loop's state before its first trip (`it` starts at -1: the
    first sweep only evaluates)."""
    dev = pose.device
    batch = pose.shape[:-2]
    s = dict(
        cand=pose, best=pose,
        err_best=torch.full(batch, math.inf, device=dev),
        it=torch.full(batch, -1, dtype=torch.int64, device=dev),
        upd=torch.ones(batch, device=dev),
        diff=torch.ones(batch, device=dev),
        ill=ill.expand(batch),
        h_best=torch.zeros(batch + (6, 6), device=dev),
        st_best=st_best,
    )
    s["run"] = _gn_active(s, cfg, max_iters)
    return s


def _gn_active(s: dict, cfg, max_iters) -> torch.Tensor:
    return (
        (s["it"] < max_iters) & (s["upd"] > cfg.tol_update)
        & (s["diff"] > cfg.tol_residual) & ~s["ill"]
    )


def _gn_trip(s: dict, hess, grad, stats, cfg, max_iters) -> dict:
    """The state after one trip, from the sweep of `s["cand"]`.  The
    elements that are not running keep their state; those that run take
    the step if it lowers the error by `tol_residual`."""
    err = stats["mean_err"]
    bad, update = _solve_step(hess, grad)
    run, cand, err_best = s["run"], s["cand"], s["err_best"]
    accept = ((err_best - err) > cfg.tol_residual) & ~bad
    step = run & accept  # the elements that take this step
    best = _where(step, cand, s["best"])
    n = dict(
        best=best,
        h_best=_where(step, hess, s["h_best"]),
        st_best={k: _where(step, stats[k], v) for k, v in s["st_best"].items()},
        cand=_where(step, se3.se3_exp(update) @ cand, _where(run, best, cand)),
        it=s["it"] + step.to(s["it"].dtype),
        diff=_where(run, torch.where(bad, 0.0, err_best - err), s["diff"]),
        err_best=_where(step, err, err_best),
        upd=_where(run, torch.linalg.norm(update, dim=-1), s["upd"]),
        ill=s["ill"] | (run & bad),
    )
    n["run"] = _gn_active(n, cfg, max_iters)
    return n


def _gn_out(s: dict) -> tuple:
    return s["best"], s["err_best"], s["it"], s["ill"], s["h_best"], s["st_best"]


def _gn_loop(sweep, pose, ill, cfg, max_iters, st_best):
    """The GN loop of `_gn_level`, run eagerly over any sweep:
    `sweep(pose)` gives (hessian, gradient, stats) and `st_best` holds the
    statistics kept (their starting values).  The rig aligner's joint
    sweep runs here.

    The state lives on the device; each step reads the loop condition with
    one host sync.  For a batch of poses the loop runs while any element
    is active; a finished element keeps its state, so each element ends
    where its own unbatched run would.  Each trip counts in `GN_COUNTS`
    (no device work, no sync of its own)."""
    s = _gn_start(pose, ill, st_best, cfg, max_iters)
    while bool(s["run"].any()):
        GN_COUNTS["sweep"] += 1
        s = _gn_trip(s, *sweep(s["cand"]), cfg, max_iters)
    return _gn_out(s)


# ------------------------------------------------------------ CUDA graphs
#
# On a CUDA card the dense sweep's GN trip is a few hundred small kernels
# whose launches cost the host far more than the card's work.  Each trip
# (and each `coarse_align` call) is a body over static tensors, captured
# once per key into a CUDA graph and replayed: one launch a trip, the same
# kernels in the same order on the same data.  Off the card the same body
# runs eagerly on the same static tensors.  A key is what the captured
# code depends on: the inputs' shapes, dtypes and device, the batch, the
# method, the occlusion mode, whether a pinhole K is given, the loop's
# bound and the configuration's numbers that the sweep and the loop read
# (`_SWEEP_FIELDS`).  Inputs are copied into the key's static tensors
# before each call and results cloned out after it, so no later replay
# overwrites what a caller holds.  All graphs capture into one memory
# pool: they replay one at a time on one stream.  A sweep that calls a
# collective, or any closure (`_gn_loop`), never takes this path.

_SWEEP_FIELDS = (
    "tol_residual", "tol_update", "bilinear", "sal_intensity", "sal_depth",
    "std_photo", "std_depth", "bilerp_depth_spread",
)
_GRAPHS: dict = {}  # key -> the static tensors and graphs of a GN loop or a coarse sweep
_CAPTURE: dict = {}  # device -> (memory pool, capture stream)


def _replayer(body, device):
    """How the loops run `body`: the replay of its CUDA graph on a card
    (captured here), the body itself elsewhere."""
    if device.type != "cuda":
        return body
    return _capture(body, device).replay


def _graph_key(kind: str, inputs: dict, cfg, *flags) -> tuple:
    """The cache key of a graph over `inputs` (name -> tensor)."""
    return (
        kind,
        tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in inputs.items()),
        tuple(getattr(cfg, f) for f in _SWEEP_FIELDS),
        flags,
    )


def _static(x):
    """A static copy of a tensor, or of a dict of them."""
    if isinstance(x, dict):
        return {k: _static(v) for k, v in x.items()}
    return x.clone(memory_format=torch.contiguous_format)


def _load(dst: dict, src: dict) -> None:
    """Copy `src`'s tensors into the static tensors of `dst`, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _load(dst[k], v)
        else:
            dst[k].copy_(v)


def _capture(body, device) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of `body()`, which reads and writes static tensors
    only: run once on the capture stream (which sets up the libraries'
    handles and workspaces there), then captured into the shared pool."""
    if device not in _CAPTURE:
        with torch.cuda.device(device):
            _CAPTURE[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream())
    pool, stream = _CAPTURE[device]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        body()
    GN_COUNTS["capture"] += 1
    return graph


def _gn_graph_loop(inputs: dict, pose, ill, cfg, method, occlusion, max_iters):
    """`_gn_loop` over the dense sweep of `inputs` (`src_gray`, `pts`,
    `valid_src`, `trg_pack`, `intr` where given) on static tensors, with
    the start and each trip replayed from CUDA graphs on a card: the same
    trips, syncs and counts."""
    dev, batch = pose.device, pose.shape[:-2]
    replayed = int(pose.is_cuda)
    key = _graph_key(
        "gn", dict(inputs, pose=pose, ill=ill), cfg, method, occlusion, max_iters
    )
    entry = _GRAPHS.get(key)
    if entry is None:
        inp = _static(dict(inputs, pose=pose, ill=ill))
        state = _static(_gn_start(pose, ill, _stats0(method, batch, dev), cfg, max_iters))
        flag = torch.zeros((), dtype=torch.bool, device=dev)

        def start():
            _load(state, _gn_start(
                inp["pose"], inp["ill"], _stats0(method, batch, dev), cfg, max_iters
            ))
            torch.any(state["run"], out=flag)

        def trip():
            sweep = _hess_grad_packed(
                inp["src_gray"], inp["pts"], inp["valid_src"], inp["trg_pack"],
                state["cand"], cfg, method, occlusion, inp.get("intr"),
            )
            _load(state, _gn_trip(state, *sweep, cfg, max_iters))
            torch.any(state["run"], out=flag)

        entry = _GRAPHS[key] = (inp, state, flag, _replayer(start, dev), _replayer(trip, dev))
    else:
        _load(entry[0], dict(inputs, pose=pose, ill=ill))
    _, state, flag, start, trip = entry
    start()
    while bool(flag):
        GN_COUNTS["sweep"] += 1
        GN_COUNTS["replay"] += replayed
        trip()
    return tuple(_static(x) for x in _gn_out(state))


# ------------------------------------------------------------------ aligner


def _as_batch(pyr: FramePyramid) -> FramePyramid:
    """The pyramid with a leading batch axis (a view of 1 if it has none)."""
    return pyr if is_batch(pyr) else _map_levels(pyr, lambda x: x[None])


def _flat_points(depth: torch.Tensor, gray: torch.Tensor, cfg, intr=None):
    """Dense source terms of (B, H, W) levels, flattened to (B, H*W)."""
    pts, valid = _src_points(depth, cfg, intr)
    return gray.flatten(-2), pts.flatten(-3, -2), valid.flatten(-2)


def scale_intrinsics(k: torch.Tensor, lvl: int) -> torch.Tensor:
    """Pinhole K at pyramid level `lvl` (reference `scaleCameraParams`: fx,
    fy, cx, cy all halve per level, `RegisterPhotoICP.h:487-495`)."""
    s = 0.5**lvl
    k = torch.as_tensor(k, dtype=torch.float32)
    out = torch.zeros((3, 3), dtype=torch.float32, device=k.device)
    out[0, 0], out[0, 2] = k[0, 0] * s, k[0, 2] * s
    out[1, 1], out[1, 2] = k[1, 1] * s, k[1, 2] * s
    out[2, 2] = 1.0
    return out


class DenseAligner:
    """Coarse-to-fine dense alignment engine: the reference's
    `RegisterPhotoICP::alignFrames360` (spherical, the default) or
    `alignFrames` (pinhole: pass `intrinsics=K` for one RGB-D camera
    pair)."""

    def __init__(self, cfg: DenseRegConfig = DenseRegConfig(), intrinsics=None):
        self.cfg = cfg
        # (3, 3) float32 K or None; the tracker reads it to choose the
        # spherical yaw rescue
        self.intrinsics = (
            None if intrinsics is None else torch.as_tensor(intrinsics, dtype=torch.float32)
        )

    def align(
        self,
        src: FramePyramid,
        trg: FramePyramid,
        init_pose=None,
        method: int = PHOTO_DEPTH,
        occlusion: int = 0,
    ) -> AlignResult:
        """T_trg<-src by coarse-to-fine GN; init_pose seeds it (identity by
        default).  occlusion: 0 plain, 1 the z-buffer occlusion test, 2 the
        test and dynamic-object rejection (the reference's
        `alignFrames360(..., occlusion)` modes).  Batched pyramids or
        (B, 4, 4) seeds give a batched result (see `_align_impl`)."""
        if occlusion not in (0, 1, 2):
            raise ValueError(f"occlusion must be 0, 1 or 2, not {occlusion}")
        dev = src.gray[0].device
        if init_pose is None:
            init_pose = torch.eye(4, device=dev)
        init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        return self._align_impl(src, trg, init_pose, method, occlusion)

    def _intr(self, lvl: int, device):
        """K at pyramid level `lvl` on `device`, or None (spherical)."""
        if self.intrinsics is None:
            return None
        return scale_intrinsics(self.intrinsics.to(device), lvl)

    def _pack(self, trg: FramePyramid, lvl: int, intr):
        return _pack_target(self._level_dicts(trg, lvl), self.cfg.bilinear, wrap=intr is None)

    def _coarsest(self, src: FramePyramid, trg: FramePyramid):
        """(source gray, points, valid, target pack) at the coarsest level,
        and its K (None on the sphere)."""
        lvl = self.cfg.pyramid_levels - 1
        src, trg = _as_batch(src), _as_batch(trg)
        intr = self._intr(lvl, src.gray[0].device)
        g, pts, valid = _flat_points(src.depth[lvl], src.gray[lvl], self.cfg, intr)
        return (g, pts, valid, self._pack(trg, lvl, intr)), intr

    def coarse_errors(self, src, trg, poses, method: int = PHOTO_DEPTH) -> torch.Tensor:
        """(N,) mean residual at the COARSEST pyramid level for a batch of
        candidate poses (N, 4, 4): one batched sweep, used to rank rotation
        hypotheses before a full coarse-to-fine solve."""
        poses = torch.as_tensor(poses, dtype=torch.float32, device=src.gray[0].device)
        args, intr = self._coarsest(src, trg)
        _, _, stats = _hess_grad_packed(*args, poses, self.cfg, method, 0, intr)
        return stats["mean_err"]

    def coarse_align(
        self, src, trg, poses, method: int = PHOTO_DEPTH, iters: int = 10
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """GN-refine a batch of candidate poses (N, 4, 4) at the coarsest
        pyramid level: `iters` plain GN steps each (no accept test, no host
        sync; an ill-posed step does not move), then (refined poses
        (N, 4, 4), post-alignment errors (N,))."""
        (g, pts, valid, pack), intr = self._coarsest(src, trg)
        inputs = dict(src_gray=g, pts=pts, valid_src=valid, trg_pack=pack)
        if intr is not None:
            inputs["intr"] = intr
        pose = torch.as_tensor(poses, dtype=torch.float32, device=g.device)
        return _coarse_graph(inputs, pose, self.cfg, method, iters)

    @staticmethod
    def _level_dicts(pyr: FramePyramid, lvl: int) -> dict:
        return {k: getattr(pyr, k)[lvl] for k in _CHANNELS}

    def _salient_indices(self, src: FramePyramid, lvl: int, k: int) -> torch.Tensor:
        """Stratified salient selection: the flat index of the most salient
        valid source pixel in each of k tiles of consecutive pixels (the
        first maximum on ties, as the reference's argmax), per frame of a
        batch: (..., k)."""
        cfg = self.cfg
        d_full = src.depth[lvl]
        valid_full = (d_full > cfg.min_depth) & (d_full < cfg.max_depth)
        score = (
            torch.abs(src.gray_gx[lvl])
            + torch.abs(src.gray_gy[lvl])
            + torch.abs(src.depth_gx[lvl])
            + torch.abs(src.depth_gy[lvl])
        )
        score = torch.where(valid_full, score, -1.0).flatten(-2)
        total = score.shape[-1]
        k = min(k, total)
        tile = total // k
        tiles = score[..., : k * tile].unflatten(-1, (k, tile))
        return torch.arange(k, device=score.device) * tile + torch.argmax(tiles, dim=-1)

    def _salient_subset(self, src: FramePyramid, lvl: int, k: int, intr=None):
        """(gray (..., k), points (..., k, 3), valid (..., k)) of the salient
        source pixels, gathered per frame; the rays (or the pinhole
        backprojection, with `intr`) are computed at the selected pixels
        only."""
        cfg = self.cfg
        idx = self._salient_indices(src, lvl, k)
        h_l, w_l = src.depth[lvl].shape[-2:]
        g_s = torch.gather(src.gray[lvl].flatten(-2), -1, idx)
        d_s = torch.gather(src.depth[lvl].flatten(-2), -1, idx)
        valid = (d_s > cfg.min_depth) & (d_s < cfg.max_depth)
        r_s, c_s = idx // w_l, idx % w_l
        if intr is None:
            pts = camera.sphere_rays_at(r_s, c_s, h_l, w_l) * d_s[..., None]
        else:
            xn = (c_s.to(torch.float32) - intr[0, 2]) / intr[0, 0]
            yn = (r_s.to(torch.float32) - intr[1, 2]) / intr[1, 1]
            pts = torch.stack([xn * d_s, yn * d_s, d_s], dim=-1)
        return g_s, pts, valid

    def _align_impl(self, src, trg, init_pose, method, occlusion=0):
        """The coarse-to-fine solve.  Either pyramid may have (B, H, W)
        levels and init_pose may be (B, 4, 4): the explicit-batch form of
        the reference's vmapped `_align_impl`.  A side without a batch axis
        (or with a batch of 1) is shared by all B alignments, and the
        salient subset of a shared source is selected once.  The result has
        a leading axis B when anything was batched."""
        cfg = self.cfg
        batched = init_pose.ndim == 3 or is_batch(src) or is_batch(trg)
        src, trg = _as_batch(src), _as_batch(trg)
        sizes = {src.gray[0].shape[0], trg.gray[0].shape[0]}
        if init_pose.ndim == 3:
            sizes.add(init_pose.shape[0])
        n = max(sizes)
        if not sizes <= {1, n}:
            raise ValueError(f"batch sizes {sorted(sizes)} do not broadcast")
        pose = init_pose.expand(n, 4, 4)
        ill = torch.zeros(n, dtype=torch.bool, device=pose.device)
        iters = []
        sweeps0, replays0 = GN_COUNTS["sweep"], GN_COUNTS["replay"]

        for lvl in reversed(range(cfg.pyramid_levels)):
            intr = self._intr(lvl, pose.device)
            trg_pack = self._pack(trg, lvl, intr)
            h_l, w_l = src.gray[lvl].shape[-2:]
            # salient sweeps at levels whose pixel count exceeds twice the
            # budget; level 2 keeps a 1/4-density budget (see the reference)
            k_lvl = cfg.salient_pixels >> (2 * lvl)
            if lvl == 2:
                k_lvl = h_l * w_l // 4
            if cfg.salient_pixels > 0 and lvl <= 2 and h_l * w_l > 2 * k_lvl and k_lvl > 0:
                src_gray, pts, valid_src = self._salient_subset(src, lvl, k_lvl, intr)
            else:
                src_gray, pts, valid_src = _flat_points(src.depth[lvl], src.gray[lvl], cfg, intr)

            pose, err, n_it, ill, hess_lvl, stats_lvl = _gn_level(
                src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method,
                occlusion, intr, cfg.max_iters_per_level,
            )
            iters.append(torch.clamp(n_it, min=0))
            if lvl == 0:
                hess_out, stats = hess_lvl, stats_lvl
                size = src_gray.shape[-1]

        if cfg.salient_pixels > 0 and cfg.polish_iters > 0:
            # dense polish: full-sweep GN steps at the finest level after
            # the thinned solve; its Hessian/statistics describe the FULL
            # image and replace the thinned ones
            intr = self._intr(0, pose.device)
            src_gray, pts, valid_src = _flat_points(src.depth[0], src.gray[0], cfg, intr)
            pose, err, _, ill, hess_out, stats = _gn_level(
                src_gray, pts, valid_src, self._pack(trg, 0, intr), pose, ill, cfg,
                method, occlusion, intr, cfg.polish_iters,
            )
            size = src_gray.shape[-1]

        zero = torch.zeros((), device=pose.device)
        one = torch.ones((), dtype=torch.int64, device=pose.device)
        av_photo = torch.sqrt(
            stats.get("photo_sq", zero) / torch.clamp(stats.get("photo_n", one), min=1)
        )
        av_depth = torch.sqrt(
            stats.get("depth_sq", zero) / torch.clamp(stats.get("depth_n", one), min=1)
        )
        res = AlignResult(
            pose=pose,
            hessian=hess_out,
            error=err,
            av_photo_residual=av_photo.expand(n),
            av_depth_residual=av_depth.expand(n),
            sso=stats["visible"] / size,
            iters=torch.stack(iters[::-1], dim=-1),
            ill_posed=ill,
            sweeps=GN_COUNTS["sweep"] - sweeps0,
            replays=GN_COUNTS["replay"] - replays0,
        )
        return res if batched else _result_item(res, 0)


def _coarse_refine(inputs: dict, pose, cfg, method, iters):
    """`coarse_align`'s `iters` plain GN steps of the sweep of `inputs`
    (as `_gn_graph_loop` names them) and the closing error sweep."""
    args = (inputs["src_gray"], inputs["pts"], inputs["valid_src"], inputs["trg_pack"])
    intr = inputs.get("intr")
    for _ in range(iters):
        hess, grad, _ = _hess_grad_packed(*args, pose, cfg, method, 0, intr)
        bad, upd = _solve_step(hess, grad)
        pose = se3.se3_exp(_where(bad, torch.zeros_like(upd), upd)) @ pose
    _, _, stats = _hess_grad_packed(*args, pose, cfg, method, 0, intr)
    return pose, stats["mean_err"]


def _coarse_graph(inputs: dict, pose, cfg, method, iters):
    """`_coarse_refine` on static tensors, replayed from a CUDA graph on a
    card: it has no host read, so the whole refinement is one replay."""
    key = _graph_key("coarse", dict(inputs, pose=pose), cfg, method, iters)
    entry = _GRAPHS.get(key)
    if entry is None:
        inp = _static(dict(inputs, pose=pose))
        out = (torch.empty_like(inp["pose"]), torch.empty(pose.shape[:-2], device=pose.device))

        def refine():
            got = _coarse_refine(inp, inp["pose"], cfg, method, iters)
            for o, x in zip(out, got):
                o.copy_(x)

        entry = _GRAPHS[key] = (inp, out, _replayer(refine, pose.device))
    else:
        _load(entry[0], dict(inputs, pose=pose))
    _, out, refine = entry
    refine()
    GN_COUNTS["coarse"] += int(pose.is_cuda)
    return tuple(_static(x) for x in out)


def _result_item(res: AlignResult, i: int) -> AlignResult:
    """Item i of a batched result (the host `sweeps` and `replays` are the
    batch's)."""
    return AlignResult(**{k: v[i] if isinstance(v, torch.Tensor) else v
                          for k, v in vars(res).items()})


def batch_align_targets_dispatch(aligner, src_pyr, trg_pyrs, seeds) -> AlignResult:
    """Dense-align ONE source pyramid against SEVERAL target pyramids in one
    batched solve (connection candidates, loop-closure verifications).
    Returns the result on the device, with a leading axis of
    len(trg_pyrs); nothing is copied to the host."""
    if len(trg_pyrs) == 0:
        raise ValueError("batch_align_targets needs at least one target")
    if len(seeds) != len(trg_pyrs):
        raise ValueError(f"{len(trg_pyrs)} targets but {len(seeds)} seeds")
    dev = src_pyr.gray[0].device
    seeds = torch.stack(
        [torch.as_tensor(s, dtype=torch.float32, device=dev) for s in seeds]
    )
    return aligner._align_impl(src_pyr, stack_pyramids(trg_pyrs), seeds, PHOTO_DEPTH)


def batch_align_targets(aligner, src_pyr, trg_pyrs, seeds) -> AlignResult:
    """`batch_align_targets_dispatch`, fetched: the result's tensors on the
    host."""
    res = batch_align_targets_dispatch(aligner, src_pyr, trg_pyrs, seeds)
    return AlignResult(**{k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in vars(res).items()})


def entropy_from_hessian(hess: torch.Tensor) -> torch.Tensor:
    """Differential entropy of the pose estimate (Kerl IROS'13; reference
    `RegisterPhotoICP::calcEntropy` / `RegisterRGBD360.h:230`)."""
    return metrics.entropy(hess)
