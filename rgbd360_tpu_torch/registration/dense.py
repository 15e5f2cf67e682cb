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
semantics (early exit, accept/reject, the iteration counter).

Not ported yet (raise NotImplementedError): bilinear target sampling,
occlusion modes 1 and 2, the pinhole `intrinsics=` path, `coarse_errors`,
`coarse_align` and `batch_align_targets`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from rgbd360_tpu.config import DenseRegConfig
from rgbd360_tpu_torch.ops import camera, pyramid as pyr_ops, se3

PHOTO_CONSISTENCY = 0
DEPTH_CONSISTENCY = 1
PHOTO_DEPTH = 2

_CHANNELS = ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")


@dataclass
class FramePyramid:
    """Multi-scale spherical frame: tuples (level 0 = full resolution) of
    gray (H, W), depth (H, W) and the four gradient images of the residual
    model, pre-masked at sensor seams."""

    gray: tuple
    depth: tuple
    gray_gx: tuple
    gray_gy: tuple
    depth_gx: tuple
    depth_gy: tuple


@dataclass
class AlignResult:
    pose: torch.Tensor  # (4, 4) relative pose source -> target frame
    hessian: torch.Tensor  # (6, 6) information matrix at the solution
    error: torch.Tensor  # final mean residual at level 0
    av_photo_residual: torch.Tensor
    av_depth_residual: torch.Tensor
    sso: torch.Tensor  # co-visibility ratio
    iters: torch.Tensor  # (levels,) iterations used per level
    ill_posed: torch.Tensor  # bool


def seam_masks_per_level(seam_valid: torch.Tensor, levels: int) -> tuple:
    """The (H, W) seam mask subsampled to every pyramid level."""
    return tuple(
        seam_valid[:: 2**lvl, :: 2**lvl].contiguous() for lvl in range(levels)
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
    `spherical`, uniform seam columns are masked.  The gradients of gray
    and depth at each level come from ONE K1 launch on the (2, H, W) stack.
    """
    if seam_valid is not None and not isinstance(seam_valid, (tuple, list)):
        seam_valid = seam_masks_per_level(seam_valid, cfg.pyramid_levels)
    grays = [gray]
    depths = [depth]
    for _ in range(cfg.pyramid_levels - 1):
        g_c, d_c = grays[-1], depths[-1]
        h, w = g_c.shape
        if h % 2 == 0 and w % 2 == 0 and h >= 6 and w >= 6:
            g2, d2 = pyr_ops.fused_level_down(g_c, d_c, cfg.min_depth, cfg.max_depth)
        else:
            g2 = pyr_ops.pyr_down(g_c)
            d2 = pyr_ops.pyr_down_depth(d_c, cfg.min_depth, cfg.max_depth)
        grays.append(g2)
        depths.append(d2)
    ggx, ggy, dgx, dgy = [], [], [], []
    half = max(1, cfg.seam_mask_px // 2)
    for lvl in range(cfg.pyramid_levels):
        sx, sy = pyr_ops.gradient_xy_multi(torch.stack([grays[lvl], depths[lvl]]))
        if seam_valid is not None:
            m = seam_valid[lvl].to(sx.dtype)[: sx.shape[1], : sx.shape[2]]
            sx, sy = sx * m, sy * m
        elif spherical:
            sx = pyr_ops.mask_seams(sx, num_sensors, half)
            sy = pyr_ops.mask_seams(sy, num_sensors, half)
        ggx.append(sx[0])
        dgx.append(sx[1])
        ggy.append(sy[0])
        dgy.append(sy[1])
    return FramePyramid(
        gray=tuple(grays),
        depth=tuple(depths),
        gray_gx=tuple(ggx),
        gray_gy=tuple(ggy),
        depth_gx=tuple(dgx),
        depth_gy=tuple(dgy),
    )


# ------------------------------------------------------------------ sweep


def _pack_target(level_trg: dict, bilinear: bool = False, wrap: bool = True):
    """Stack the six target channels into (H, W, 6) so each GN sweep does
    one row gather per pixel (nearest sampling)."""
    if bilinear:
        raise NotImplementedError("bilinear target sampling is not ported yet")
    return torch.stack([level_trg[k] for k in _CHANNELS], dim=-1)


def _src_points(src_depth: torch.Tensor, cfg: DenseRegConfig, intr=None):
    """Pose-invariant source terms, hoisted out of the GN loop."""
    if intr is not None:
        raise NotImplementedError("the pinhole alignment path is not ported yet")
    pts = camera.sphere_backproject(src_depth)
    valid_src = (src_depth > cfg.min_depth) & (src_depth < cfg.max_depth)
    return pts, valid_src


def _warp_terms(pose, pts, valid_src, h, w, intr=None):
    """Transform all source points and project them to the target's
    spherical pixel grid (nearest pixel; `rho` is the radial range)."""
    if intr is not None:
        raise NotImplementedError("the pinhole alignment path is not ported yet")
    tp = pts @ pose[:3, :3].T + pose[:3, 3]
    rc, rho = camera.sphere_project(tp, h, w)
    # round half to even, then truncating casts, as the reference
    r_i = torch.round(rc[..., 0]).to(torch.int32)
    c_i = torch.remainder(torch.round(rc[..., 1]).to(torch.int32), w)
    inb = (r_i >= 0) & (r_i < h) & valid_src
    return dict(tp=tp, rho=rho, r=torch.clamp(r_i, 0, h - 1), c=c_i, visible=inb)


def _huber(err: torch.Tensor, scale) -> torch.Tensor:
    """Huber weight (reference `RegisterPhotoICP.h:weightHuber:545`)."""
    a = torch.abs(err)
    w = torch.sqrt(torch.clamp(2.0 * scale * a - scale * scale, min=0.0)) / torch.clamp(
        a, min=1e-12
    )
    return torch.where(a < scale, 1.0, w)


def _residual_terms(
    src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion=0, intr=None
):
    """Per-pixel weighted residuals and masks for one pyramid level, on
    (H, W) dense source arrays or flat (K,) salient subsets."""
    if occlusion != 0:
        raise NotImplementedError("occlusion modes 1 and 2 are not ported yet")
    if trg_pack.shape[-1] != 6:
        raise NotImplementedError("bilinear target sampling is not ported yet")
    h, w = trg_pack.shape[0], trg_pack.shape[1]
    wt = _warp_terms(pose, pts, valid_src, h, w, intr)
    lin = wt["r"] * w + wt["c"]
    tvp = trg_pack.reshape(-1, 6)[lin.long()]
    tv = [tvp[..., k] for k in range(6)]

    out = dict(visible=wt["visible"], tp=wt["tp"], rho=wt["rho"])
    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        gx, gy = tv[2], tv[3]
        salient = (torch.abs(gx) >= cfg.sal_intensity) | (torch.abs(gy) >= cfg.sal_intensity)
        diff = tv[0] - src_gray
        w_p = _huber(diff, cfg.std_photo) / cfg.std_photo
        m = wt["visible"] & salient
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
        m = wt["visible"] & salient & has_d
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


def _hess_grad_packed(
    src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion=0, intr=None
):
    """The 6x6 normal equations, gradient and residual statistics of one
    GN iteration (one pixel sweep)."""
    t = _residual_terms(
        src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion, intr
    )
    tp = t["tp"]
    jproj = _proj_jacobian(tp, trg_pack.shape[1])  # (..., 2, 3)

    # a @ [I | -skew(tp)] = [a | tp x a]
    def chain_row(a):
        return torch.cat([a, torch.linalg.cross(tp, a, dim=-1)], dim=-1)

    hess = torch.zeros((6, 6), device=tp.device)
    grad = torch.zeros((6,), device=tp.device)
    stats = {}

    def accumulate(prefix, a):
        nonlocal hess, grad
        jac = chain_row(a) * t[prefix + "_w"][..., None]
        jac = torch.where(t[prefix + "_mask"][..., None], jac, 0.0)
        jf = jac.reshape(-1, 6)
        rf = t[prefix + "_res"].reshape(-1)
        hess = hess + jf.T @ jf
        grad = grad + jf.T @ rf
        stats[prefix + "_sq"] = torch.sum(rf * rf)
        stats[prefix + "_n"] = torch.sum(t[prefix + "_mask"])

    def image_term(gx, gy):
        return gx[..., None] * jproj[..., 0, :] + gy[..., None] * jproj[..., 1, :]

    if "photo_res" in t:
        accumulate("photo", image_term(t["photo_gx"], t["photo_gy"]))
    if "depth_res" in t:
        a = image_term(t["depth_gx"], t["depth_gy"])
        rho_inv = 1.0 / torch.clamp(t["rho"], min=1e-9)
        accumulate("depth", a - tp * rho_inv[..., None])  # -d|p|/dp term

    stats["visible"] = torch.sum(t["visible"])
    # mean weighted residual sqrt(sum(w r)^2 / n): H, g and error from ONE sweep
    err2 = stats.get("photo_sq", 0.0) + stats.get("depth_sq", 0.0)
    n = stats.get("photo_n", 0) + stats.get("depth_n", 0)
    stats["mean_err"] = torch.sqrt(err2 / torch.clamp(n, min=1))
    return hess, grad, stats


def _stats0(method: int, device) -> dict:
    f = torch.tensor(0.0, device=device)
    i = torch.tensor(0, device=device)
    st = {"mean_err": f, "visible": i}
    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        st.update(photo_sq=f, photo_n=i)
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        st.update(depth_sq=f, depth_n=i)
    return st


def _gn_level(
    src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method, occlusion,
    intr, max_iters,
):
    """One pyramid level of Gauss-Newton with accept-if-improved stepping
    (a rejected step exits the level).  Returns (pose, err, iters, ill,
    hessian, stats), where hessian/stats come from the last ACCEPTED
    evaluation: at exit they describe the final pose.

    The state lives on the device; each step reads the loop condition with
    one host sync (`it` starts at -1: the first sweep only evaluates)."""
    dev = pose.device
    eye6 = torch.eye(6, device=dev)
    cand, best = pose, pose
    err_best = torch.tensor(math.inf, device=dev)
    it = torch.tensor(-1, device=dev)
    upd = torch.tensor(1.0, device=dev)
    diff = torch.tensor(1.0, device=dev)
    h_best = torch.zeros((6, 6), device=dev)
    st_best = _stats0(method, dev)

    def cond():
        c = (it < max_iters) & (upd > cfg.tol_update) & (diff > cfg.tol_residual) & ~ill
        return bool(c)

    while cond():
        hess, grad, stats = _hess_grad_packed(
            src_gray, pts, valid_src, trg_pack, cand, cfg, method, occlusion, intr
        )
        err = stats["mean_err"]
        # observability guard (reference `:4682-4690`)
        bad = (torch.linalg.det(hess) < 1e-12) | ~torch.all(torch.isfinite(hess))
        update = -torch.linalg.solve_ex(torch.where(bad, eye6, hess), grad)[0]
        accept = ((err_best - err) > cfg.tol_residual) & ~bad
        best = torch.where(accept, cand, best)
        h_best = torch.where(accept, hess, h_best)
        st_best = {k: torch.where(accept, stats[k], st_best[k]) for k in st_best}
        cand = torch.where(accept, se3.se3_exp(update) @ cand, best)
        it = it + accept.to(it.dtype)
        diff = torch.where(bad, 0.0, err_best - err)
        err_best = torch.where(accept, err, err_best)
        upd = torch.linalg.norm(update)
        ill = ill | bad
    return best, err_best, it, ill, h_best, st_best


# ------------------------------------------------------------------ aligner


class DenseAligner:
    """Coarse-to-fine dense spherical alignment engine (the reference's
    `RegisterPhotoICP::alignFrames360`)."""

    def __init__(self, cfg: DenseRegConfig = DenseRegConfig(), intrinsics=None):
        if intrinsics is not None:
            raise NotImplementedError("the pinhole alignment path is not ported yet")
        if cfg.bilinear:
            raise NotImplementedError("bilinear target sampling is not ported yet")
        self.cfg = cfg

    def align(
        self,
        src: FramePyramid,
        trg: FramePyramid,
        init_pose=None,
        method: int = PHOTO_DEPTH,
        occlusion: int = 0,
    ) -> AlignResult:
        """T_trg<-src by coarse-to-fine GN; init_pose seeds it (identity by
        default).  occlusion must be 0 (modes 1 and 2 are not ported)."""
        if occlusion != 0:
            raise NotImplementedError("occlusion modes 1 and 2 are not ported yet")
        dev = src.gray[0].device
        if init_pose is None:
            init_pose = torch.eye(4, device=dev)
        init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        return self._align_impl(src, trg, init_pose, method, occlusion)

    def coarse_errors(self, *args, **kwargs):
        raise NotImplementedError("DenseAligner.coarse_errors is not ported yet")

    def coarse_align(self, *args, **kwargs):
        raise NotImplementedError("DenseAligner.coarse_align is not ported yet")

    @staticmethod
    def _level_dicts(pyr: FramePyramid, lvl: int) -> dict:
        return {k: getattr(pyr, k)[lvl] for k in _CHANNELS}

    def _salient_indices(self, src: FramePyramid, lvl: int, k: int) -> torch.Tensor:
        """Stratified salient selection: the flat index of the most salient
        valid source pixel in each of k tiles of consecutive pixels (the
        first maximum on ties, as the reference's argmax)."""
        cfg = self.cfg
        d_full = src.depth[lvl]
        valid_full = (d_full > cfg.min_depth) & (d_full < cfg.max_depth)
        score = (
            torch.abs(src.gray_gx[lvl])
            + torch.abs(src.gray_gy[lvl])
            + torch.abs(src.depth_gx[lvl])
            + torch.abs(src.depth_gy[lvl])
        )
        score = torch.where(valid_full, score, -1.0).reshape(-1)
        total = score.shape[0]
        k = min(k, total)
        tile = total // k
        tiles = score[: k * tile].reshape(k, tile)
        return torch.arange(k, device=score.device) * tile + torch.argmax(tiles, dim=1)

    def _salient_subset(self, src: FramePyramid, lvl: int, k: int):
        """(gray (k,), points (k, 3), valid (k,)) of the salient source
        pixels; the rays are computed at the selected pixels only."""
        cfg = self.cfg
        idx = self._salient_indices(src, lvl, k)
        h_l, w_l = src.depth[lvl].shape
        g_s = src.gray[lvl].reshape(-1)[idx]
        d_s = src.depth[lvl].reshape(-1)[idx]
        valid = (d_s > cfg.min_depth) & (d_s < cfg.max_depth)
        pts = camera.sphere_rays_at(idx // w_l, idx % w_l, h_l, w_l) * d_s[:, None]
        return g_s, pts, valid

    def _align_impl(self, src, trg, init_pose, method, occlusion=0):
        cfg = self.cfg
        pose = init_pose
        iters = []
        ill = torch.tensor(False, device=pose.device)

        for lvl in reversed(range(cfg.pyramid_levels)):
            lsrc = self._level_dicts(src, lvl)
            trg_pack = _pack_target(self._level_dicts(trg, lvl))
            src_gray = lsrc["gray"]
            # salient sweeps at levels whose pixel count exceeds twice the
            # budget; level 2 keeps a 1/4-density budget (see the reference)
            k_lvl = cfg.salient_pixels >> (2 * lvl)
            if lvl == 2:
                k_lvl = src_gray.numel() // 4
            if (
                cfg.salient_pixels > 0
                and lvl <= 2
                and src_gray.numel() > 2 * k_lvl
                and k_lvl > 0
            ):
                src_gray, pts, valid_src = self._salient_subset(src, lvl, k_lvl)
            else:
                pts, valid_src = _src_points(lsrc["depth"], cfg)

            pose, err, n_it, ill, hess_lvl, stats_lvl = _gn_level(
                src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method,
                occlusion, None, cfg.max_iters_per_level,
            )
            iters.append(torch.clamp(n_it, min=0))
            if lvl == 0:
                hess_out, stats = hess_lvl, stats_lvl
                size = src_gray.numel()

        if cfg.salient_pixels > 0 and cfg.polish_iters > 0:
            # dense polish: full-sweep GN steps at the finest level after
            # the thinned solve; its Hessian/statistics describe the FULL
            # image and replace the thinned ones
            lsrc = self._level_dicts(src, 0)
            pts, valid_src = _src_points(lsrc["depth"], cfg)
            pose, err, _, ill, hess_out, stats = _gn_level(
                lsrc["gray"], pts, valid_src,
                _pack_target(self._level_dicts(trg, 0)), pose, ill, cfg,
                method, occlusion, None, cfg.polish_iters,
            )
            size = lsrc["gray"].numel()

        zero = torch.tensor(0.0, device=pose.device)
        one = torch.tensor(1, device=pose.device)
        av_photo = torch.sqrt(
            stats.get("photo_sq", zero) / torch.clamp(stats.get("photo_n", one), min=1)
        )
        av_depth = torch.sqrt(
            stats.get("depth_sq", zero) / torch.clamp(stats.get("depth_n", one), min=1)
        )
        return AlignResult(
            pose=pose,
            hessian=hess_out,
            error=err,
            av_photo_residual=av_photo,
            av_depth_residual=av_depth,
            sso=stats["visible"] / size,
            iters=torch.stack(iters[::-1]),
            ill_posed=ill,
        )


def batch_align_targets(aligner, src_pyr, trg_pyrs, seeds):
    raise NotImplementedError("batch_align_targets is not ported yet")
