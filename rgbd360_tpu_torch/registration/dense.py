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

Batches.  The reference vmaps the aligner (the batch pipeline, one source
against several keyframes, a batch of pose hypotheses); here a leading
batch axis runs through the pyramid, the sweep and the GN loop.  Either
side of a batched alignment may be shared: an unbatched pyramid, or one
with a batch of 1, is broadcast against the other side, never copied.
The batched GN loop runs while any element is active, and a finished
element keeps its state, as the vmapped `lax.while_loop` does.

Not ported yet (raise NotImplementedError): bilinear target sampling,
occlusion modes 1 and 2, the pinhole `intrinsics=` path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import camera, pyramid as pyr_ops, se3

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
# (H, W) or a flat (K,) salient subset, target pack (H, W, 6), pose (4, 4).
# Batched: flat source arrays (Bs, N), points (Bs, N, 3), target pack
# (Bt, H, W, 6) and poses (B, 4, 4), with Bs and Bt each 1 (shared) or B;
# the statistics then come back per element: (B, 6, 6), (B, 6), (B,).


def _pack_target(level_trg: dict, bilinear: bool = False, wrap: bool = True):
    """Stack the six target channels into (..., H, W, 6) so each GN sweep
    does one row gather per pixel (nearest sampling)."""
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
    tp = pts @ pose[..., :3, :3].mT + pose[..., None, :3, 3]
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
    """Per-pixel weighted residuals and masks for one pyramid level."""
    if occlusion != 0:
        raise NotImplementedError("occlusion modes 1 and 2 are not ported yet")
    if trg_pack.shape[-1] != 6:
        raise NotImplementedError("bilinear target sampling is not ported yet")
    h, w = trg_pack.shape[-3], trg_pack.shape[-2]
    wt = _warp_terms(pose, pts, valid_src, h, w, intr)
    lin = (wt["r"] * w + wt["c"]).long()
    if trg_pack.ndim == 4 and trg_pack.shape[0] > 1:
        # one target per element: offset each element into its own image
        off = torch.arange(trg_pack.shape[0], device=lin.device) * (h * w)
        lin = lin + off[:, None]
    tvp = trg_pack.reshape(-1, 6)[lin]
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
    GN iteration (one pixel sweep), per element of a batch of poses."""
    t = _residual_terms(
        src_gray, pts, valid_src, trg_pack, pose, cfg, method, occlusion, intr
    )
    tp = t["tp"]
    jproj = _proj_jacobian(tp, trg_pack.shape[-2])  # (..., 2, 3)
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
        rho_inv = 1.0 / torch.clamp(t["rho"], min=1e-9)
        accumulate("depth", a - tp * rho_inv[..., None])  # -d|p|/dp term

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
    evaluation: at exit they describe the final pose.

    The state lives on the device; each step reads the loop condition with
    one host sync (`it` starts at -1: the first sweep only evaluates).  For
    a batch of poses the loop runs while any element is active; a finished
    element keeps its state, so each element ends where its own unbatched
    run would."""
    dev = pose.device
    batch = pose.shape[:-2]
    cand, best = pose, pose
    err_best = torch.full(batch, math.inf, device=dev)
    it = torch.full(batch, -1, dtype=torch.int64, device=dev)
    upd = torch.ones(batch, device=dev)
    diff = torch.ones(batch, device=dev)
    ill = ill.expand(batch)
    h_best = torch.zeros(batch + (6, 6), device=dev)
    st_best = _stats0(method, batch, dev)

    def active():
        return (it < max_iters) & (upd > cfg.tol_update) & (diff > cfg.tol_residual) & ~ill

    run = active()
    while bool(run.any()):
        hess, grad, stats = _hess_grad_packed(
            src_gray, pts, valid_src, trg_pack, cand, cfg, method, occlusion, intr
        )
        err = stats["mean_err"]
        bad, update = _solve_step(hess, grad)
        accept = ((err_best - err) > cfg.tol_residual) & ~bad
        step = run & accept  # the elements that take this step
        best = _where(step, cand, best)
        h_best = _where(step, hess, h_best)
        st_best = {k: _where(step, stats[k], st_best[k]) for k in st_best}
        cand = _where(step, se3.se3_exp(update) @ cand, _where(run, best, cand))
        it = it + step.to(it.dtype)
        diff = _where(run, torch.where(bad, 0.0, err_best - err), diff)
        err_best = _where(step, err, err_best)
        upd = _where(run, torch.linalg.norm(update, dim=-1), upd)
        ill = ill | (run & bad)
        run = active()
    return best, err_best, it, ill, h_best, st_best


# ------------------------------------------------------------------ aligner


def _as_batch(pyr: FramePyramid) -> FramePyramid:
    """The pyramid with a leading batch axis (a view of 1 if it has none)."""
    return pyr if is_batch(pyr) else _map_levels(pyr, lambda x: x[None])


def _flat_points(depth: torch.Tensor, gray: torch.Tensor, cfg):
    """Dense source terms of (B, H, W) levels, flattened to (B, H*W)."""
    pts, valid = _src_points(depth, cfg)
    return gray.flatten(-2), pts.flatten(-3, -2), valid.flatten(-2)


class DenseAligner:
    """Coarse-to-fine dense spherical alignment engine (the reference's
    `RegisterPhotoICP::alignFrames360`)."""

    def __init__(self, cfg: DenseRegConfig = DenseRegConfig(), intrinsics=None):
        if intrinsics is not None:
            raise NotImplementedError("the pinhole alignment path is not ported yet")
        if cfg.bilinear:
            raise NotImplementedError("bilinear target sampling is not ported yet")
        self.cfg = cfg
        # the tracker reads it to choose the spherical yaw rescue
        self.intrinsics = intrinsics

    def align(
        self,
        src: FramePyramid,
        trg: FramePyramid,
        init_pose=None,
        method: int = PHOTO_DEPTH,
        occlusion: int = 0,
    ) -> AlignResult:
        """T_trg<-src by coarse-to-fine GN; init_pose seeds it (identity by
        default).  occlusion must be 0 (modes 1 and 2 are not ported).
        Batched pyramids or (B, 4, 4) seeds give a batched result (see
        `_align_impl`)."""
        if occlusion != 0:
            raise NotImplementedError("occlusion modes 1 and 2 are not ported yet")
        dev = src.gray[0].device
        if init_pose is None:
            init_pose = torch.eye(4, device=dev)
        init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
        return self._align_impl(src, trg, init_pose, method, occlusion)

    def _coarsest(self, src: FramePyramid, trg: FramePyramid):
        """(source gray, points, valid, target pack) at the coarsest level."""
        lvl = self.cfg.pyramid_levels - 1
        src, trg = _as_batch(src), _as_batch(trg)
        g, pts, valid = _flat_points(src.depth[lvl], src.gray[lvl], self.cfg)
        return g, pts, valid, _pack_target(self._level_dicts(trg, lvl))

    def coarse_errors(self, src, trg, poses, method: int = PHOTO_DEPTH) -> torch.Tensor:
        """(N,) mean residual at the COARSEST pyramid level for a batch of
        candidate poses (N, 4, 4): one batched sweep, used to rank rotation
        hypotheses before a full coarse-to-fine solve."""
        poses = torch.as_tensor(poses, dtype=torch.float32, device=src.gray[0].device)
        _, _, stats = _hess_grad_packed(*self._coarsest(src, trg), poses, self.cfg, method)
        return stats["mean_err"]

    def coarse_align(
        self, src, trg, poses, method: int = PHOTO_DEPTH, iters: int = 10
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """GN-refine a batch of candidate poses (N, 4, 4) at the coarsest
        pyramid level: `iters` plain GN steps each (no accept test, no host
        sync; an ill-posed step does not move), then (refined poses
        (N, 4, 4), post-alignment errors (N,))."""
        args = self._coarsest(src, trg)
        pose = torch.as_tensor(poses, dtype=torch.float32, device=src.gray[0].device)
        for _ in range(iters):
            hess, grad, _ = _hess_grad_packed(*args, pose, self.cfg, method)
            bad, upd = _solve_step(hess, grad)
            pose = se3.se3_exp(_where(bad, torch.zeros_like(upd), upd)) @ pose
        _, _, stats = _hess_grad_packed(*args, pose, self.cfg, method)
        return pose, stats["mean_err"]

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

    def _salient_subset(self, src: FramePyramid, lvl: int, k: int):
        """(gray (..., k), points (..., k, 3), valid (..., k)) of the salient
        source pixels, gathered per frame; the rays are computed at the
        selected pixels only."""
        cfg = self.cfg
        idx = self._salient_indices(src, lvl, k)
        h_l, w_l = src.depth[lvl].shape[-2:]
        g_s = torch.gather(src.gray[lvl].flatten(-2), -1, idx)
        d_s = torch.gather(src.depth[lvl].flatten(-2), -1, idx)
        valid = (d_s > cfg.min_depth) & (d_s < cfg.max_depth)
        pts = camera.sphere_rays_at(idx // w_l, idx % w_l, h_l, w_l) * d_s[..., None]
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

        for lvl in reversed(range(cfg.pyramid_levels)):
            trg_pack = _pack_target(self._level_dicts(trg, lvl))
            h_l, w_l = src.gray[lvl].shape[-2:]
            # salient sweeps at levels whose pixel count exceeds twice the
            # budget; level 2 keeps a 1/4-density budget (see the reference)
            k_lvl = cfg.salient_pixels >> (2 * lvl)
            if lvl == 2:
                k_lvl = h_l * w_l // 4
            if cfg.salient_pixels > 0 and lvl <= 2 and h_l * w_l > 2 * k_lvl and k_lvl > 0:
                src_gray, pts, valid_src = self._salient_subset(src, lvl, k_lvl)
            else:
                src_gray, pts, valid_src = _flat_points(src.depth[lvl], src.gray[lvl], cfg)

            pose, err, n_it, ill, hess_lvl, stats_lvl = _gn_level(
                src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method,
                occlusion, None, cfg.max_iters_per_level,
            )
            iters.append(torch.clamp(n_it, min=0))
            if lvl == 0:
                hess_out, stats = hess_lvl, stats_lvl
                size = src_gray.shape[-1]

        if cfg.salient_pixels > 0 and cfg.polish_iters > 0:
            # dense polish: full-sweep GN steps at the finest level after
            # the thinned solve; its Hessian/statistics describe the FULL
            # image and replace the thinned ones
            src_gray, pts, valid_src = _flat_points(src.depth[0], src.gray[0], cfg)
            pose, err, _, ill, hess_out, stats = _gn_level(
                src_gray, pts, valid_src,
                _pack_target(self._level_dicts(trg, 0)), pose, ill, cfg,
                method, occlusion, None, cfg.polish_iters,
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
        )
        return res if batched else _result_item(res, 0)


def _result_item(res: AlignResult, i: int) -> AlignResult:
    return AlignResult(**{k: v[i] for k, v in vars(res).items()})


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
    return AlignResult(**{k: v.cpu() for k, v in vars(res).items()})
