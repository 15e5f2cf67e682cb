"""The plain reference that decides `correct`: the frame build, the
alignment pyramid, the dense tracking solve and its statistics, and the
pose-graph solve, written from their definitions in plain PyTorch.  It imports
nothing of the program and takes nothing the program made: the benchmark
hands it the same captures and calibration arrays it hands the program,
and it builds its own maps and pyramids from them.  The program's outputs
reach it only as the answers it judges.

Long matrix products are written as matrix products (the pyramid's blur
and box sums, J^T J), so that the control can compute them in TF32
(`precision(tf32=True)`); the other arithmetic takes a `dtype`, bfloat16
for the control.

- `Rig` and `sphere`: the stitch maps (each sphere pixel to the sensor that
  sees its ray most head-on, the nearest source pixel truncated, the radial
  scale), the CLAMS depth undistortion, the gather, the BGR to gray weights.
- `pyramid`: the circular 5-tap binomial blur and decimation of the gray,
  the 2x2 mean of valid depths, the harmonic-mean gradients masked at the
  sensor seams.
- `track_stats` and `dense_solve`: the Huber-weighted photometric and
  depth residuals of a spherical warp, their normal matrix and mean
  residuals at level 0, and the coarse-to-fine Gauss-Newton solve on them.
- `graph_solve`: Levenberg-Marquardt on the SE(3) pose graph, with Dynamic
  Covariance Scaling on the loop edges.
- `plane_register` and its parts (`plane_candidates`, `plane_consistency`,
  `plane_votes`, `plane_pose`): the PbMap registration of two plane sets,
  the match set and the pose with its information matrix (the section's
  own doc says where it departs from the C++ reference).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

CHANNELS = ("gray", "depth", "gray_gx", "gray_gy", "depth_gx", "depth_gy")


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (the control) or full float32 inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ sphere


def sphere_rays(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3) unit rays: row r at elevation (h/2 - 1/2 - r) * 2pi/w,
    column c at azimuth c * 2pi/w, the rig's up axis x."""
    res = 2.0 * math.pi / w
    phi = (0.5 * h - 0.5 - torch.arange(h, dtype=torch.float32, device=device)) * res
    theta = torch.arange(w, dtype=torch.float32, device=device) * res
    sp, cp = torch.sin(phi)[:, None], torch.cos(phi)[:, None]
    st, ct = torch.sin(theta)[None, :], torch.cos(theta)[None, :]
    return torch.stack([sp.expand(h, w), -cp * st, -cp * ct], dim=-1)


@dataclass
class Rig:
    """The stitch maps and undistortion tables of one calibration."""

    sensor: torch.Tensor  # (H, W) long
    u: torch.Tensor
    v: torch.Tensor
    scale: torch.Tensor
    valid: torch.Tensor
    ambiguous: torch.Tensor  # (H, W) pixels whose gather rounding decides
    seam_tie: torch.Tensor  # (H, W) pixels whose seam mask an ownership tie decides
    clams_m: torch.Tensor  # (S, h, w, nbins)
    clams_c: torch.Tensor
    bin_depth: float

    @staticmethod
    def build(rt: np.ndarray, k: np.ndarray, sphere_hw, sensor_hw, clams_mult, clams_counts,
              bin_w: int, bin_h: int, bin_depth: float, device) -> "Rig":
        hs, ws = sphere_hw
        sh, sw = sensor_hw
        rt_inv = torch.as_tensor(np.linalg.inv(np.asarray(rt, np.float64)), dtype=torch.float32,
                                 device=device)
        kk = torch.as_tensor(k, dtype=torch.float32, device=device)
        rays = sphere_rays(hs, ws, device)
        # each ray's unit point in each sensor's frame: R^-1 ray + t^-1
        p = rays.reshape(1, -1, 3) @ rt_inv[:, :3, :3].mT + rt_inv[:, None, :3, 3]
        p = p.reshape(-1, hs, ws, 3)
        z = p[..., 2]
        zs = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
        u_f = kk[0, 0] * p[..., 0] / zs + kk[0, 2]
        v_f = kk[1, 1] * p[..., 1] / zs + kk[1, 2]
        inb = (z > 1e-6) & (u_f >= 0) & (u_f < sw) & (v_f >= 0) & (v_f < sh)
        score = torch.where(inb, z / torch.linalg.norm(p, dim=-1), -math.inf)
        sensor = torch.argmax(score, dim=0)

        def pick(a):
            return torch.gather(a, 0, sensor[None])[0]

        u_sel, v_sel = pick(u_f), pick(v_f)
        # where rounding may decide: two sensors see the ray equally head-on,
        # or the source coordinate lies on a pixel boundary
        top2 = torch.topk(score, 2, dim=0).values
        near = lambda x: torch.abs(x - torch.round(x)) < 1e-3  # noqa: E731
        tie = top2[0] - top2[1] < 1e-5
        ambiguous = tie | near(u_sel) | near(v_sel)
        xn = (u_sel - kk[0, 2]) / kk[0, 0]
        yn = (v_sel - kk[1, 2]) / kk[1, 1]

        def trunc(x, n):  # int32 truncation, clipped into the image
            return torch.clamp(torch.clamp(x, -1.0, float(n)).to(torch.int32), 0, n - 1).long()

        yb = torch.arange(sh, device=device) // bin_h
        xb = torch.arange(sw, device=device) // bin_w
        m = torch.as_tensor(clams_mult, dtype=torch.float32, device=device)
        c = torch.as_tensor(clams_counts, dtype=torch.float32, device=device)
        return Rig(
            sensor=sensor, u=trunc(u_sel, sw), v=trunc(v_sel, sh),
            scale=torch.sqrt(1.0 + xn * xn + yn * yn), valid=pick(inb), ambiguous=ambiguous,
            seam_tie=tie | torch.roll(tie, 1, dims=1) | torch.roll(tie, -1, dims=1),
            clams_m=m[:, yb][:, :, xb], clams_c=c[:, yb][:, :, xb], bin_depth=float(bin_depth),
        )

    def seam_mask(self) -> torch.Tensor:
        """(H, W) True away from a change of owning sensor between columns."""
        s = self.sensor
        seam = (s != torch.roll(s, 1, dims=1)) | (s != torch.roll(s, -1, dims=1))
        return ~seam


def undistort(z: torch.Tensor, rig: Rig) -> torch.Tensor:
    """CLAMS undistortion of (S, h, w) metre depth: the multiplier of the
    pixel's frustum interpolated between the two nearest depth-bin
    centres, or the depth's own bin where a bin is missing or has fewer
    than 50 training examples."""
    nb = rig.clams_m.shape[-1]
    bd = rig.bin_depth
    idx = torch.clamp(torch.floor(z / bd).to(torch.int64), max=nb - 1)
    idx1 = torch.where(z - bd * idx.to(z.dtype) < 0.5 * bd, idx, idx + 1)
    idx0 = idx1 - 1

    def at(tab, i):
        return torch.gather(tab, -1, torch.clamp(i, 0, nb - 1)[..., None])[..., 0]

    tab = rig.clams_m.to(z.dtype)
    m_near, m0, m1 = at(tab, idx), at(tab, idx0), at(tab, idx1)
    c0, c1 = at(rig.clams_c, idx0), at(rig.clams_c, idx1)
    coeff1 = (z - (idx1.to(z.dtype) * bd - 0.5 * bd)) / bd
    m_interp = (1.0 - coeff1) * m0 + coeff1 * m1
    fallback = (idx0 < 0) | (idx1 >= nb) | (c0 < 50.0) | (c1 < 50.0)
    return torch.where(z > 0, z * torch.where(fallback, m_near, m_interp), z)


def sphere(rgb: np.ndarray, depth_mm: np.ndarray, rig: Rig, dtype=torch.float32):
    """(gray (H, W) in [0, 1], radial depth (H, W) metres, 0 = none) of one
    capture: rgb (S, h, w, 3) uint8 BGR, depth (S, h, w) uint16 mm; the
    arithmetic in `dtype` (bfloat16 for the control)."""
    dev = rig.sensor.device
    img = torch.as_tensor(rgb, device=dev).to(dtype)
    z = undistort(torch.as_tensor(depth_mm.astype(np.int32), device=dev).to(dtype) * 0.001, rig)
    px = img[rig.sensor, rig.v, rig.u]  # (H, W, 3)
    d = z[rig.sensor, rig.v, rig.u]
    px = torch.where(rig.valid[..., None], px, 0.0)
    gray = (0.114 * px[..., 0] + 0.587 * px[..., 1] + 0.299 * px[..., 2]) * (1.0 / 255.0)
    depth = torch.where(rig.valid & (d > 0), d * rig.scale.to(dtype), 0.0)
    return gray.float(), depth.float()


# ----------------------------------------------------------------- pyramid


def _blur_decimate(n: int, circular: bool, device) -> torch.Tensor:
    """(n/2, n): output i = sum_a k[a] x[2i + a], a in -2..2, k = (1 4 6 4
    1)/16, indices wrapped."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=device) / 16.0
    m = torch.zeros((n // 2, n), device=device)
    i = torch.arange(n // 2, device=device)
    for a in range(-2, 3):
        j = torch.remainder(2 * i + a, n) if circular else torch.clamp(2 * i + a, 0, n - 1)
        m.index_put_((i, j), k[a + 2].expand(n // 2), accumulate=True)
    return m


def _pair_sum(n: int, device) -> torch.Tensor:
    """(n/2, n): output i = x[2i] + x[2i+1]."""
    m = torch.zeros((n // 2, n), device=device)
    i = torch.arange(n // 2, device=device)
    m[i, 2 * i] = 1.0
    m[i, 2 * i + 1] = 1.0
    return m


def _grad(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Occlusion-aware gradient along `dim`: the harmonic mean of the
    forward and backward differences where they agree in sign, else 0;
    0 on the first and last index."""
    fwd = torch.roll(a, -1, dims=dim) - a
    bwd = a - torch.roll(a, 1, dims=dim)
    mono = ((fwd > 0) & (bwd > 0)) | ((fwd < 0) & (bwd < 0))
    one = torch.ones_like(a)
    den = torch.where(mono, one / torch.where(fwd == 0, 1e-12, fwd), 0.0) + torch.where(
        mono, one / torch.where(bwd == 0, 1e-12, bwd), 0.0)
    g = torch.where(mono, torch.full_like(a, 2.0) / torch.where(den == 0, 1e-12, den), 0.0)
    n = a.shape[dim]
    idx = torch.arange(n, device=a.device)
    shape = [1] * a.ndim
    shape[dim] = n
    return torch.where(((idx > 0) & (idx < n - 1)).reshape(shape), g, 0.0)


def pyramid(gray: torch.Tensor, depth: torch.Tensor, levels: int, seam: torch.Tensor,
            min_depth: float, max_depth: float) -> dict:
    """{channel: [level 0, 1, ...]} of one sphere: gray, depth and the four
    masked gradient images."""
    out = {c: [] for c in CHANNELS}
    g, d = gray, depth
    for lvl in range(levels):
        if lvl:
            h, w = g.shape
            g = _blur_decimate(h, True, g.device) @ g @ _blur_decimate(w, True, g.device).T
            valid = (d > min_depth) & (d < max_depth)
            p, q = _pair_sum(h, d.device), _pair_sum(w, d.device).T
            s = p @ torch.where(valid, d, 0.0) @ q
            n = p @ valid.to(d.dtype) @ q
            d = torch.where(n > 0.5, s / torch.clamp(n, min=1.0), 0.0)
        m = seam[:: 2**lvl, :: 2**lvl].to(torch.float32)
        out["gray"].append(g)
        out["depth"].append(d)
        for name, x in (("gray", g), ("depth", d)):
            out[f"{name}_gx"].append(_grad(x, 1) * m)
            out[f"{name}_gy"].append(_grad(x, 0) * m)
    return out


# -------------------------------------------------------------- tracking


def _huber_w(err: torch.Tensor, s) -> torch.Tensor:
    a = torch.abs(err)
    w = torch.sqrt(torch.clamp(2.0 * s * a - s * s, min=0.0)) / torch.clamp(a, min=1e-12)
    return torch.where(a < s, 1.0, w)


def _sweep(src: dict, trg: dict, lvl: int, pose: torch.Tensor, cfg: dict,
           dtype=torch.float32) -> tuple:
    """One pass over the pixels of level `lvl` at the pose T (T_trg<-src):
    each valid source point moved by T and projected to the target sphere's
    nearest pixel; the photometric residual I_trg - I_src and the depth
    residual D_trg - |T p|, Huber-weighted (scales `std_photo`, `std_depth`
    * D_trg), kept where the target's gradients pass the saliency gates.
    Returns (H, g, stats): the normal matrix H = sum J^T J and the gradient
    g = sum J^T r over both residuals, with J the residual's derivative in
    the left twist (v, w) of T; the sums of squared residuals and the
    counts of each, the visible count and the mean residual
    sqrt(sum r^2 / n).  The arithmetic in `dtype` (bfloat16 for the
    control), the sums in float32."""
    g_s, d_s = src["gray"][lvl].to(dtype), src["depth"][lvl].to(dtype)
    h, w = d_s.shape
    pts = sphere_rays(h, w, d_s.device).to(dtype) * d_s[..., None]
    valid = (d_s > cfg["min_depth"]) & (d_s < cfg["max_depth"])
    pose = pose.to(dtype)
    tp = (pts.reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]).reshape(h, w, 3)
    rho = torch.linalg.norm(tp, dim=-1)
    phi = torch.arcsin(torch.clamp(tp[..., 0] / torch.clamp(rho, min=1e-12), -1.0, 1.0))
    theta = torch.atan2(tp[..., 1], tp[..., 2]) + math.pi
    res_inv = w / (2.0 * math.pi)
    r_i = torch.round(0.5 * h - 0.5 - phi * res_inv).to(torch.int64)
    c_i = torch.remainder(torch.round(theta * res_inv).to(torch.int64), w)
    visible = (r_i >= 0) & (r_i < h) & valid
    r_i = torch.clamp(r_i, 0, h - 1)
    t = {c: trg[c][lvl].to(dtype)[r_i, c_i] for c in CHANNELS}

    # d(col, row)/dp of the spherical projection
    x, y, z = tp[..., 0], tp[..., 1], tp[..., 2]
    rho2 = x * x + y * y + z * z
    z_s = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    d_atan = res_inv / (1.0 + (y / z_s) ** 2)
    x_r2 = x / torch.clamp(rho2, min=1e-12)
    d_asin = res_inv / torch.sqrt(torch.clamp(1.0 - x * x_r2, min=1e-9))
    rho_i = 1.0 / torch.clamp(torch.sqrt(rho2), min=1e-6)
    j_col = torch.stack([torch.zeros_like(x), d_atan / z_s, -y / (z_s * z_s) * d_atan], -1)
    j_row = torch.stack([-d_asin * rho_i * (1.0 - x * x_r2), d_asin * x_r2 * y * rho_i,
                         d_asin * x_r2 * z * rho_i], -1)

    terms = {}
    sal_p = (torch.abs(t["gray_gx"]) >= cfg["sal_intensity"]) | (
        torch.abs(t["gray_gy"]) >= cfg["sal_intensity"])
    diff = t["gray"] - g_s
    w_p = _huber_w(diff, cfg["std_photo"]) / cfg["std_photo"]
    a_p = t["gray_gx"][..., None] * j_col + t["gray_gy"][..., None] * j_row
    terms["photo"] = (visible & sal_p, w_p, w_p * diff, a_p)
    sal_d = (torch.abs(t["depth_gx"]) >= cfg["sal_depth"]) | (
        torch.abs(t["depth_gy"]) >= cfg["sal_depth"])
    d2 = t["depth"]
    diff = d2 - rho
    s = cfg["std_depth"] * torch.clamp(d2, min=1e-3)
    w_d = _huber_w(diff, s) / s
    a_d = (t["depth_gx"][..., None] * j_col + t["depth_gy"][..., None] * j_row
           - tp / torch.clamp(rho, min=1e-9)[..., None])
    terms["depth"] = (visible & sal_d & (d2 > 0), w_d, w_d * diff, a_d)

    hess = torch.zeros((6, 6), device=d_s.device)
    grad = torch.zeros(6, device=d_s.device)
    stats = {"visible": torch.sum(visible)}
    for name, (m, wt, r, a) in terms.items():
        jac = torch.cat([a, torch.linalg.cross(tp, a, dim=-1)], dim=-1) * wt[..., None]
        jac = torch.where(m[..., None], jac, 0.0).reshape(-1, 6).float()
        r = torch.where(m, r, 0.0).reshape(-1).float()
        hess = hess + jac.T @ jac
        grad = grad + jac.T @ r
        stats[name + "_sq"] = torch.sum(r * r)
        stats[name + "_n"] = torch.sum(m)
    stats["mean_err"] = torch.sqrt((stats["photo_sq"] + stats["depth_sq"]) / torch.clamp(
        stats["photo_n"] + stats["depth_n"], min=1))
    return hess, grad, stats


def track_stats(src: dict, trg: dict, pose: torch.Tensor, cfg: dict,
                dtype=torch.float32) -> dict:
    """At level 0 and the pose T, the normal matrix of `_sweep`, the mean
    photometric and depth residuals sqrt(sum r^2 / n) and the visible
    share."""
    hess, _, st = _sweep(src, trg, 0, pose, cfg, dtype)
    h, w = src["depth"][0].shape
    av = [torch.sqrt(st[k + "_sq"] / torch.clamp(st[k + "_n"], min=1)) for k in ("photo", "depth")]
    return {"hessian": hess, "av_photo": av[0], "av_depth": av[1],
            "sso": st["visible"] / (h * w)}


def dense_solve(src: dict, trg: dict, init_pose: torch.Tensor, cfg: dict,
                dtype=torch.float32) -> tuple:
    """The dense tracking solve as the configuration states it: from
    `init_pose`, coarse to fine over `pyramid_levels` levels, Gauss-Newton
    on `_sweep`'s normal equations with left updates T <- exp(-H^-1 g) T.
    At each level the first sweep only evaluates; a step is taken while its
    sweep lowers the mean residual by more than `tol_residual` (a step that
    does not is undone and ends the level), the last update's norm is over
    `tol_update` and fewer than `max_iters_per_level` steps were taken.  A
    normal matrix with determinant under 1e-12, or not finite, marks the
    solve ill-posed and ends it.  Returns (pose, ill_posed); the pose stays
    in float32, the pixels' arithmetic is in `dtype`."""
    pose = init_pose.to(torch.float32)
    ill = False
    eye6 = torch.eye(6, device=pose.device)
    for lvl in reversed(range(int(cfg["pyramid_levels"]))):
        best = cand = pose
        err_best, it, upd, diff = math.inf, -1, 1.0, 1.0
        while (it < cfg["max_iters_per_level"] and upd > cfg["tol_update"]
               and diff > cfg["tol_residual"] and not ill):
            hess, grad, st = _sweep(src, trg, lvl, cand, cfg, dtype)
            err = float(st["mean_err"])
            bad = bool(torch.linalg.det(hess) < 1e-12) or not bool(torch.isfinite(hess).all())
            update = -torch.linalg.solve(eye6 if bad else hess, grad)
            diff = 0.0 if bad else err_best - err
            if diff > cfg["tol_residual"]:
                best, cand, it, err_best = cand, se3_exp(update) @ cand, it + 1, err
            else:
                cand = best
            upd = float(torch.linalg.norm(update))
            ill = ill or bad
        pose = best
    return pose, ill


# ------------------------------------------------------------------ graph


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _so3_jl(w):
    """Left Jacobian of SO(3) and the rotation, for rotation vectors w."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(th2)
    k = _skew(w)
    k2 = k @ k
    small = th2 < 1e-12
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - torch.sin(ths)) / (ths ** 3))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + b * k + c * k2, eye + a * k + b * k2


def se3_exp(xi):
    """Twists (v, w) to 4x4 transforms."""
    jl, r = _so3_jl(xi[..., 3:])
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = (jl @ xi[..., :3, None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def so3_log(r):
    """Rotation matrices (angle at most pi) to rotation vectors.  Near pi,
    where the antisymmetric part no longer carries the axis, the axis is
    the largest column of (R + R^T - 2 cos(th) I) / (2 (1 - cos(th))),
    signed to agree with the antisymmetric part."""
    cos_t = torch.clamp((r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    th = torch.arccos(cos_t)
    vee = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                       r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_t = torch.sin(th)
    safe = torch.where(torch.abs(sin_t) > 1e-9, sin_t, 1.0)
    w = torch.where((torch.abs(sin_t) > 1e-9)[..., None], (th / (2.0 * safe))[..., None] * vee,
                    (0.5 + th * th / 12.0)[..., None] * vee)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    aat = (r + r.mT - 2.0 * cos_t[..., None, None] * eye) / torch.clamp(
        2.0 * (1.0 - cos_t), min=1e-12)[..., None, None]
    k = torch.argmax(torch.diagonal(aat, dim1=-2, dim2=-1), dim=-1)
    col = torch.take_along_dim(aat, k[..., None, None].expand(*k.shape, 3, 1), dim=-1)[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-30)
    sign = torch.where(torch.sum(axis * vee, -1) < 0, -1.0, 1.0).to(r.dtype)
    w_pi = (th * sign)[..., None] * axis
    return torch.where((th > 3.0)[..., None], w_pi, w)


def se3_log(t):
    """4x4 transforms (rotation angle at most pi) to twists (v, w)."""
    w = so3_log(t[..., :3, :3])
    th = torch.linalg.norm(w, dim=-1)
    # inverse left Jacobian: I - [w]/2 + (1/th^2 - (1 + cos th) / (2 th sin th)) [w]^2
    k = _skew(w)
    th2 = (th * th)[..., None, None]
    small = th2 < 1e-8
    ths = torch.where(small, 1.0, th[..., None, None])
    coef = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                       1.0 / (ths * ths) - (1.0 + torch.cos(ths)) / (2.0 * ths * torch.sin(ths)))
    jinv = torch.eye(3, dtype=t.dtype, device=t.device) - 0.5 * k + coef * (k @ k)
    v = (jinv @ t[..., :3, 3:])[..., 0]
    return torch.cat([v, w], -1)


def se3_inv(t):
    out = torch.zeros_like(t)
    rt = t[..., :3, :3].mT
    out[..., :3, :3] = rt
    out[..., :3, 3] = -(rt @ t[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _adjoint(t):
    """6x6 adjoint of SE(3) for (v, w) twists."""
    r = t[..., :3, :3]
    out = torch.zeros(t.shape[:-2] + (6, 6), dtype=t.dtype, device=t.device)
    out[..., :3, :3] = r
    out[..., :3, 3:] = _skew(t[..., :3, 3]) @ r
    out[..., 3:, 3:] = r
    return out


def graph_cost(poses, edges_ij, rel, info, is_loop, dcs_phi: float) -> float:
    """The robust cost the graph solve minimizes, sum_e s_e^2 e^T L e (the
    module's `graph_solve`), in float64."""
    d = torch.float64
    ij = edges_ij.long()
    p = poses.to(d)
    e = se3_log(se3_inv(rel.to(d)) @ se3_inv(p[ij[:, 0]]) @ p[ij[:, 1]])
    c = torch.einsum("ei,eij,ej->e", e, info.to(d), e)
    s = torch.clamp(2.0 * dcs_phi / torch.clamp(dcs_phi + c, min=1e-12), max=1.0)
    s = torch.where(is_loop.to(torch.bool), s, torch.ones_like(s))
    return float(torch.sum(c * s * s))


def graph_solve(poses, edges_ij, rel, info, is_loop, dcs_phi: float, max_iters: int,
                lm_lambda0: float, lm_step: float, dtype=torch.float64):
    """Levenberg-Marquardt on the pose graph from `poses` (N, 4, 4,
    world<-keyframe), as the configuration states it: edge residuals
    e = log(Z^-1 T_i^-1 T_j), first-order Jacobians Adj(T_j^-1) and
    -Adj(T_j^-1) for left updates, loop edges' information scaled by s^2
    with s = min(1, 2 phi / (phi + e^T L e)) (Dynamic Covariance Scaling),
    vertex 0 held by a prior of 1e6 and every vertex by 1e-6, the damping
    lambda diag(H) + 1e-9.  A step is taken when it lowers the cost, and
    lambda is divided by `lm_step` after it, multiplied after a rejected
    one; the solve ends after `max_iters` steps or a taken step that lowers
    the cost by less than 1e-6 of it.  Returns the poses."""
    dev = poses.device
    p = poses.to(dtype)
    n = p.shape[0]
    ij = edges_ij.long()
    i, j = ij[:, 0], ij[:, 1]
    z_inv = se3_inv(rel.to(dtype))
    lam_e = info.to(dtype)
    loop = is_loop.to(torch.bool)

    def terms(x):
        e = se3_log(z_inv @ se3_inv(x[i]) @ x[j])
        c = torch.einsum("ei,eij,ej->e", e, lam_e, e)
        s = torch.clamp(2.0 * dcs_phi / torch.clamp(dcs_phi + c, min=1e-12), max=1.0)
        s = torch.where(loop, s, torch.ones_like(s))
        return e, lam_e * (s * s)[:, None, None]

    def cost(x):
        e, lam = terms(x)
        return torch.einsum("ei,eij,ej->", e, lam, e)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    prior = torch.zeros((n, 6, 6), dtype=dtype, device=dev) + 1e-6 * eye6
    prior[0] += 1e6 * eye6
    r6 = torch.arange(6, device=dev)
    idx = torch.arange(n, device=dev)
    lm = lm_lambda0
    c0 = cost(p)
    for _ in range(max_iters):
        e, lam = terms(p)
        a = _adjoint(se3_inv(p[j]))
        m = a.mT @ lam @ a
        b = (a.mT @ lam @ e[..., None])[..., 0]
        h = torch.zeros((n, 6, n, 6), dtype=dtype, device=dev)
        for u, v, sgn in ((i, i, 1.0), (j, j, 1.0), (i, j, -1.0), (j, i, -1.0)):
            h.index_put_((u[:, None, None], r6[None, :, None], v[:, None, None],
                          r6[None, None, :]), sgn * m, accumulate=True)
        hb = torch.zeros((n, 6), dtype=dtype, device=dev)
        hb.index_add_(0, j, b)
        hb.index_add_(0, i, -b)
        h[idx, :, idx, :] += prior
        hf = h.reshape(n * 6, n * 6)
        damped = hf + lm * torch.diag(torch.diagonal(hf)) + 1e-9 * torch.eye(
            n * 6, dtype=dtype, device=dev)
        solve_dtype = torch.promote_types(dtype, torch.float32)
        delta = -torch.linalg.solve(damped.to(solve_dtype), hb.reshape(-1).to(solve_dtype))
        delta = delta.to(dtype).reshape(n, 6)
        cand = se3_exp(delta) @ p
        c1 = cost(cand)
        if bool(c1 < c0):
            rel_impr = float((c0 - c1) / torch.clamp(c0, min=1e-12))
            p, c0, lm = cand, c1, lm / lm_step
            if rel_impr < 1e-6:
                break
        else:
            lm *= lm_step
    return p


# ------------------------------------------------------ plane registration
#
# The C++ reference (mrpt's PbMap `Subgraph` matcher behind
# `RegisterRGBD360`) grows its match set by an interpretation tree: a
# depth-first search over plane pairs that keeps the largest set whose
# pairs pass the unary gates and are consistent two by two.  What is
# written here is the registration the configuration states, which departs
# from that tree in these ways:
#
# - the match set is grown greedily: every live pair (it passes the unary
#   gates and is consistent with every pair taken so far, and neither of
#   its planes is taken) gets a vote, its area weight times the sum of the
#   area weights of the live pairs consistent with it; the pair of the
#   highest vote is taken, the first of tied votes in row-major order of
#   (reference plane, target plane), for at most `max_matches` steps or
#   until no live pair is left.  The tree's largest consistent set is not
#   searched for;
# - the binary gates are the tree's three (angle between normals, distance
#   between centres, height of one centre over the other plane), with the
#   height tolerance three times `height_threshold`;
# - the pose is closed-form: a weighted SVD rotation of the normals and an
#   eigen-truncated least-squares translation, refined by Huber IRLS and
#   two redescending passes (`plane_pose`), where the C++ reference hands
#   the match set to mrpt's `ConsistencyTest::estimatePoseWithCovariance`;
# - the degree gates are computed in float32 on the host (a float32 gate
#   compares exactly against the float32 value), as a float32 program
#   computes them.
#
# Against the program's arithmetic: the sums over the three coordinates of
# a normal are elementwise products summed, where the program may use a
# matrix product, and the pose is solved over the n matched pairs alone,
# where the program carries `max_matches` slots with zero weight; both move
# results by rounding only.

# registration modes, numbered as `RegisterRGBD360.h` numbers them
DEFAULT_6DOF, PLANAR_3DOF, ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF = 0, 1, 2, 3
# the per-plane fields the registration reads
PLANE_FIELDS = ("valid", "normal", "d", "center", "area", "elongation", "hue_hist")


def _f32_angle(deg: float, fn=None) -> float:
    """`deg` in radians, or fn of it, computed in float32 on the host."""
    x = torch.deg2rad(torch.tensor(deg, dtype=torch.float32))
    return float(fn(x) if fn is not None else x)


def _dot(a, b):
    """(..., 3) . (..., 3), the products summed."""
    return (a * b).sum(-1)


def plane_candidates(ref: dict, trg: dict, cfg: dict, mode: int) -> torch.Tensor:
    """(K1, K2) bool: which pairs (plane i of `ref`, plane j of `trg`) pass
    the unary gates: both valid; the ratios of larger to smaller area and
    elongation under `area_threshold` and `elongation_threshold`; the
    Bhattacharyya coefficient of the hue histograms over 1 -
    `hue_threshold`; in the odometry modes the normals within
    `unary_angle_deg` and the offsets d within `unary_dist_d`; in the planar
    modes the up components (x) of the normals within 0.2 of each other."""

    def ratio(key):
        a, b = ref[key][:, None], trg[key][None, :]
        return torch.maximum(a, b) / torch.clamp(torch.minimum(a, b), min=1e-6)

    h1 = torch.clamp(ref["hue_hist"], min=0.0)[:, None, :]
    h2 = torch.clamp(trg["hue_hist"], min=0.0)[None, :, :]
    ok = (ref["valid"][:, None] & trg["valid"][None, :]
          & (ratio("area") < cfg["area_threshold"])
          & (ratio("elongation") < cfg["elongation_threshold"])
          & (torch.sqrt(h1 * h2).sum(-1) > 1.0 - cfg["hue_threshold"]))
    n1, n2 = ref["normal"], trg["normal"]
    if mode in (ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF):
        ok = ok & (_dot(n1[:, None, :], n2[None, :, :])
                   > _f32_angle(cfg["unary_angle_deg"], torch.cos))
        ok = ok & (torch.abs(ref["d"][:, None] - trg["d"][None, :]) < cfg["unary_dist_d"])
    if mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF):
        up = torch.abs(n1[:, 0])[:, None] - torch.abs(n2[:, 0])[None, :]
        ok = ok & (torch.abs(up) < 0.2)
    return ok


def plane_consistency(ref: dict, trg: dict, cand: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(K1 K2, K1 K2) bool, row i K2 + j and column k K2 + l: both pairs
    are candidates, they share no plane unless they are the same pair, and
    the relations of planes i and k in `ref` match those of j and l in
    `trg`: the angle between the normals within
    `binary_angle_threshold_deg`, the distance between the centres within
    `binary_dist_threshold`, the height of centre k over plane i within 3
    `height_threshold`."""

    def relations(p):
        n, c = p["normal"], p["center"]
        ang = torch.arccos(torch.clamp(_dot(n[:, None, :], n[None, :, :]), -1.0, 1.0))
        dist = torch.linalg.norm(c[:, None, :] - c[None, :, :], dim=-1)
        height = _dot(n[:, None, :], c[None, :, :]) + p["d"][:, None]
        return ang, dist, height

    k1, k2 = cand.shape
    ok = cand[:, :, None, None] & cand[None, None, :, :]
    tols = (_f32_angle(cfg["binary_angle_threshold_deg"]), cfg["binary_dist_threshold"],
            cfg["height_threshold"] * 3)
    for x1, x2, tol in zip(relations(ref), relations(trg), tols):
        ok = ok & (torch.abs(x1[:, None, :, None] - x2[None, :, None, :]) < tol)
    dev = cand.device
    same_i = torch.eye(k1, dtype=torch.bool, device=dev)[:, None, :, None]
    same_j = torch.eye(k2, dtype=torch.bool, device=dev)[None, :, None, :]
    return (ok & ~(same_i ^ same_j)).reshape(k1 * k2, k1 * k2)


def plane_vote_weights(ref: dict, trg: dict) -> torch.Tensor:
    """(K1, K2): a pair's area weight, sqrt(area_i area_j), each area at
    least 1e-3."""
    return torch.sqrt(torch.clamp(ref["area"][:, None], min=1e-3)
                      * torch.clamp(trg["area"][None, :], min=1e-3))


def plane_votes(cons: torch.Tensor, live: torch.Tensor, w: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """(K1, K2): each live pair's vote, its weight times the sum of the
    weights of the live pairs consistent with it; -1 where not live.  In
    `dtype` (bfloat16 for the control)."""
    lw = torch.where(live, w, 0.0).reshape(-1).to(dtype)
    v = (cons.to(dtype) @ lw).reshape(live.shape) * w.to(dtype)
    return torch.where(live, v, -1.0)


def plane_live_after(live: torch.Tensor, cons: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """The live pairs once (i, j) is taken: those consistent with it whose
    planes are not i or j."""
    k1, k2 = live.shape
    nxt = live & cons[i * k2 + j].reshape(k1, k2)
    nxt[i, :] = False
    nxt[:, j] = False
    return nxt


def plane_greedy(cons: torch.Tensor, cand: torch.Tensor, w: torch.Tensor, max_matches: int,
                 dtype=torch.float32) -> list:
    """The match set [(i, j), ...] in the order taken (the section's doc)."""
    k2 = cand.shape[1]
    live, picks = cand, []
    for _ in range(int(max_matches)):
        votes = plane_votes(cons, live, w, dtype).reshape(-1)
        best = int(torch.argmax(votes))  # the first of tied votes
        if not float(votes[best]) > 0.0:
            break
        i, j = divmod(best, k2)
        picks.append((i, j))
        live = plane_live_after(live, cons, i, j)
    return picks


def _huber_irls(r, s):
    a = torch.abs(r)
    return torch.where(a < s, 1.0, s / torch.clamp(a, min=1e-12))


def plane_pose(ref: dict, trg: dict, pairs, cfg: dict, dtype=torch.float32) -> dict:
    """The pose T_ref<-trg of matched pairs [(i, j), ...], its information
    matrix and `success`, as the configuration states them.  With normals
    n1, n2 and offsets d1, d2 of the pairs and weights w: R maximises
    sum w (R n2) . n1 (the SVD of sum w n1 n2^T, its determinant fixed to
    +1); t solves w n1 . t = w (d2 - d1) in least squares through the
    eigenvectors of A^T A (A = w n1), directions of eigenvalue 0.25 or less
    left at 0.  Weights start at 1; two Huber passes (0.05 m on the offset
    residual n1 . t - (d2 - d1), 0.002 on the normal residual 1 - n1 . R
    n2) and two redescending passes follow, each solving again.  A
    redescending pass keeps a pair whose residuals lie under 4 times their
    weighted RMS (at least 0.15 m and 0.01) and revokes a kept pair whose
    normal lies within ~15 degrees (|n1 . n1'| > 0.966) of a cut pair's
    unless another kept pair of that direction supports it.  The
    information matrix is A^T A (translation) beside sum w J^T J with J =
    -[R n2]x (rotation), at the last weights.  `success`: at least 3 pairs,
    det(A^T A) over 1e-9 and at least `min_planes_recognition` pairs; the
    pose is the identity otherwise.  Arithmetic in `dtype` (bfloat16 for
    the control), the SVD, eigen-decomposition and determinants in float32
    of its values."""
    dev = ref["normal"].device
    idx = torch.as_tensor(list(pairs), dtype=torch.long, device=dev).reshape(-1, 2)
    n = idx.shape[0]
    n1 = ref["normal"][idx[:, 0]].to(dtype)
    n2 = trg["normal"][idx[:, 1]].to(dtype)
    dd = trg["d"][idx[:, 1]].to(dtype) - ref["d"][idx[:, 0]].to(dtype)

    def solve(w):
        corr = (n1 * w[:, None]).T @ n2
        u, _, vt = torch.linalg.svd(corr.float())
        fix = torch.ones(3, device=dev)
        fix[2] = torch.linalg.det(u @ vt)
        rot = ((u * fix[None, :]) @ vt).to(dtype)
        a = n1 * w[:, None]
        ata = a.T @ a
        atb = a.T @ (dd * w)
        evals, evecs = torch.linalg.eigh(ata.float())
        inv = torch.where(evals > 0.25, 1.0 / torch.clamp(evals, min=1e-12), 0.0)
        evecs = evecs.to(dtype)
        t = evecs @ (inv.to(dtype) * (evecs.T @ atb))
        return rot, t, ata

    def residuals(rot, t):
        return n1 @ t - dd, 1.0 - _dot(n1, n2 @ rot.T)

    w = torch.ones(n, dtype=dtype, device=dev)
    rot, t, ata = solve(w)
    for _ in range(2):
        r_t, r_r = residuals(rot, t)
        w = _huber_irls(r_t, 0.05) * _huber_irls(r_r, 0.002)
        rot, t, ata = solve(w)
    same_dir = torch.abs(n1 @ n1.T) > 0.966
    for _ in range(2):
        r_t, r_r = residuals(rot, t)
        wsum = torch.clamp(w.sum(), min=1e-9)
        thr_t = torch.clamp(4.0 * torch.sqrt((w * r_t * r_t).sum() / wsum), min=0.15)
        thr_r = torch.clamp(4.0 * torch.sqrt((w * r_r * r_r).sum() / wsum), min=0.01)
        keep = (torch.abs(r_t) < thr_t) & (r_r < thr_r)
        cut = (w > 0) & ~keep
        suspect = (same_dir & cut[None, :]).any(-1)
        support = (same_dir & (keep & (w > 0))[None, :]).sum(-1) - 1
        keep = keep & (~suspect | (support >= 1))
        w = torch.where(keep, w, 0.0)
        rot, t, ata = solve(w)

    rn2 = n2 @ rot.T
    z = torch.zeros_like(rn2[:, 0])
    jr = -torch.stack([torch.stack([z, -rn2[:, 2], rn2[:, 1]], -1),
                       torch.stack([rn2[:, 2], z, -rn2[:, 0]], -1),
                       torch.stack([-rn2[:, 1], rn2[:, 0], z], -1)], -2)
    info = torch.zeros((6, 6), device=dev)
    info[:3, :3] = ata.float()
    info[3:, 3:] = (w[:, None, None] * (jr.mT @ jr)).sum(0).float()
    success = (n >= 3 and bool(torch.linalg.det(ata.float()) > 1e-9)
               and n >= int(cfg["min_planes_recognition"]))
    pose = torch.eye(4, device=dev)
    if success:
        pose[:3, :3] = rot.float()
        pose[:3, 3] = t.float()
    return {"pose": pose, "information": info, "success": success}


def plane_register(ref: dict, trg: dict, cfg: dict, mode: int, dtype=torch.float32) -> dict:
    """T_ref<-trg from two plane sets ({field: tensor} of `PLANE_FIELDS`,
    K planes each): the unary gates of `mode`, the binary consistency, the
    greedy match set and `plane_pose` of it.  Returns `plane_pose`'s dict
    with `pairs` [(i, j), ...].  The votes and the pose in `dtype`, the
    gates in float32."""
    cand = plane_candidates(ref, trg, cfg, mode)
    cons = plane_consistency(ref, trg, cand, cfg)
    pairs = plane_greedy(cons, cand, plane_vote_weights(ref, trg), cfg["max_matches"], dtype)
    return {"pairs": pairs, **plane_pose(ref, trg, pairs, cfg, dtype)}
