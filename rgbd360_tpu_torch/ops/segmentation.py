"""Organized multi-plane segmentation (twin of
`rgbd360_tpu/ops/segmentation.py`).

1. normals from box-smoothed organized-cloud gradients (banded matmuls);
2. planar region growing as connected components: a pixel connects to its
   4-neighbours when their normals and point-to-plane distances agree, and
   the components come from a FIXED number of alternating row/column
   segmented min-scans (not converged union-find: the labels, and so the
   planes, must be the reference's);
3. per-component statistics as one-hot matmuls (centroid, covariance
   eigendecomposition, hull extremes, hue histogram);
4. a fixed-capacity `PlaneSet` gated like the reference.

Every function takes leading batch axes: the rig's sensors (and a batch of
frames) segment in one call, as the reference vmaps them.  The parity
traps and what this module does about them: `lax.top_k` puts the lower
index first on ties, so ranks come from a stable descending sort; float
`%` is floor-mod (`torch.remainder`); the label histogram is an integer
scatter-add (exact counts); the cross-sensor merge sums with a one-hot
matmul instead of an atomic float `index_add_`, so two runs on the card
agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from rgbd360_tpu_torch.config import SegmentationConfig


@dataclass
class PlaneSet:
    """Fixed-capacity padded plane set (leading axes = batch, then K planes).

    normal:    (K, 3) unit, oriented toward the viewpoint
    center:    (K, 3)
    d:         (K,) plane offset, n . x + d = 0 with d = -n . c
    curvature: (K,)
    area:      (K,) hull area (m^2)
    elongation:(K,) hull axis ratio
    n_inliers: (K,)
    hull:      (K, R, 3) polygon contour (extreme points)
    hue_hist:  (K, 37) normalized hue histogram (36 hue bins + gray bin)
    main_color:(K, 3) mean rgb (0..1)
    valid:     (K,) bool
    """

    normal: torch.Tensor
    center: torch.Tensor
    d: torch.Tensor
    curvature: torch.Tensor
    area: torch.Tensor
    elongation: torch.Tensor
    n_inliers: torch.Tensor
    hull: torch.Tensor
    hue_hist: torch.Tensor
    main_color: torch.Tensor
    valid: torch.Tensor

    def map(self, fn) -> "PlaneSet":
        """The PlaneSet whose every field is fn(name, tensor)."""
        return PlaneSet(**{f.name: fn(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)})


# trailing (per-plane) rank of each field: the plane axis is the one before
_TRAIL = {"normal": 1, "center": 1, "d": 0, "curvature": 0, "area": 0, "elongation": 0,
          "n_inliers": 0, "hull": 2, "hue_hist": 1, "main_color": 1, "valid": 0}


def _plane_dim(name: str) -> int:
    return -1 - _TRAIL[name]


@functools.lru_cache(maxsize=16)
def _box_band(n: int, k: int) -> np.ndarray:
    """(n, n) float32 matrix of the reference's box filter: out_i =
    (c[b_i] - c[a_i]) / k with c = cumsum, a_i = clip(i - k//2 - 1, 0,
    n-1), b_i = clip(i + k - k//2 - 1, 0, n-1): window (a_i, b_i], uniform
    1/k weights, truncated (NOT renormalized) at the borders."""
    a = np.zeros((n, n), np.float32)
    lpad = k // 2 + 1
    for i in range(n):
        lo = min(max(i - lpad, 0), n - 1)
        hi = min(max(i + k - lpad, 0), n - 1)
        a[i, lo + 1 : hi + 1] = 1.0 / k
    return a


@functools.lru_cache(maxsize=16)
def _box_band_t(n: int, k: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_box_band(n, k)).to(device)


def _box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable box blur over the last two axes as banded matmuls."""
    if k <= 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    x = _box_band_t(h, k, x.device) @ x
    return x @ _box_band_t(w, k, x.device).mT


def estimate_normals(
    xyz: torch.Tensor, valid: torch.Tensor, smoothing: int = 8
) -> torch.Tensor:
    """Organized normal estimation (PCL AVERAGE_3D_GRADIENT analogue).

    xyz: (..., H, W, 3) organized points (garbage where ~valid); returns
    unit normals oriented toward the origin, zero where undefined."""
    p = torch.where(valid[..., None], xyz, 0.0)
    w = valid.to(xyz.dtype)[..., None]
    ps = _box_blur(torch.movedim(p, -1, -3), smoothing)
    ws = _box_blur(torch.movedim(w, -1, -3), smoothing)
    sm = torch.movedim(ps / torch.clamp(ws, min=1e-6), -3, -1)  # smoothed points

    du = 0.5 * (torch.roll(sm, -1, dims=-2) - torch.roll(sm, 1, dims=-2))
    dv = 0.5 * (torch.roll(sm, -1, dims=-3) - torch.roll(sm, 1, dims=-3))
    n = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * sm, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(valid[..., None] & (norm > 1e-9), n, 0.0)


def _seg_min_scan(lab, r_fwd, r_bwd, axis: int):
    """Min within each contiguous compatible run along `axis`, both
    directions, in ONE Hillis-Steele doubling chain (the backward scan of
    x is the forward scan of flip(x), stacked on a new leading axis)."""
    ax = axis % lab.ndim
    n = lab.shape[ax]
    sax = ax + 1  # scan axis after the direction stack
    v = torch.stack([lab, torch.flip(lab, dims=(ax,))])
    f = torch.stack([r_fwd, torch.flip(r_bwd, dims=(ax,))])
    shape = [1] * v.ndim
    shape[sax] = n
    idx = torch.arange(n, device=lab.device).reshape(shape)
    d = 1
    while d < n:
        # the ok gate keeps roll's wrap-around from leaking across the edge
        ok = idx >= d
        vp = torch.roll(v, d, dims=sax)
        fp = torch.roll(f, d, dims=sax)
        v = torch.where(ok & ~f, torch.minimum(v, vp), v)
        f = torch.where(ok, f | fp, f)
        d *= 2
    return torch.minimum(v[0], torch.flip(v[1], dims=(ax,)))


def _connected_labels(compat_r, compat_c, valid, iters: int) -> torch.Tensor:
    """Connected components by alternating row/column segmented min-scans.

    compat_r: (..., H-1, W) connectivity of (r, c) and (r+1, c);
    compat_c: (..., H, W-1) connectivity of (r, c) and (r, c+1).
    Returns int32 labels (..., H, W); `max(2, min(iters, 8))` alternations,
    as the reference (not always converged, by design)."""
    h, w = valid.shape[-2:]
    lead = valid.shape[:-2]
    dev = valid.device
    lab = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w).expand(*lead, h, w)
    brk_c, brk_r = ~compat_c, ~compat_r
    edge_c = torch.ones((*lead, h, 1), dtype=torch.bool, device=dev)
    edge_r = torch.ones((*lead, 1, w), dtype=torch.bool, device=dev)
    rc_f = torch.cat([edge_c, brk_c], dim=-1)
    rc_b = torch.cat([brk_c, edge_c], dim=-1)
    rr_f = torch.cat([edge_r, brk_r], dim=-2)
    rr_b = torch.cat([brk_r, edge_r], dim=-2)
    for _ in range(max(2, min(iters, 8))):
        lab = _seg_min_scan(lab, rc_f, rc_b, axis=-1)
        lab = _seg_min_scan(lab, rr_f, rr_b, axis=-2)
    return lab


def _rgb_to_hue_hist(rgb):
    """Per-pixel hue bin (36 hue bins + 1 low-saturation bin), mirroring
    mrpt::pbmap `Plane::calcPlaneHistH`; rgb (..., 3) BGR 0..255.  (The
    reference's unused `weights` and `num_segments` are left out.)"""
    r, g, b = rgb[..., 2] / 255.0, rgb[..., 1] / 255.0, rgb[..., 0] / 255.0
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.clamp(diff, min=1e-6)
    hue = torch.where(
        mx == r,
        torch.remainder((g - b) / safe, 6.0),  # floor-mod, as Python's %
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    ) * 60.0
    sat = diff / torch.clamp(mx, min=1e-6)
    gray = (sat < 0.1) | (mx < 0.1)
    return torch.where(gray, 36, torch.clamp(hue / 10.0, 0, 35.999).to(torch.int32))


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index first (the order `lax.top_k` gives)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def _compat_masks(xyz: torch.Tensor, valid: torch.Tensor, cfg: SegmentationConfig):
    """(points (..., H, W, 3) zeroed where invalid, compat_r, compat_c): a
    pixel and its lower / right neighbour may join one region when both are
    valid, their normals agree within the angular gate, and each point lies
    within the distance gate of the other's plane."""
    normals = estimate_normals(xyz, valid, cfg.normal_smoothing_size)
    p = torch.where(valid[..., None], xyz, 0.0)
    cos_gate = math.cos(cfg.angular_threshold)

    def edge_compat(pa, na, va, pb, nb, vb):
        cos = torch.sum(na * nb, dim=-1)
        dp = pb - pa
        dist_a = torch.abs(torch.sum(na * dp, dim=-1))
        dist_b = torch.abs(torch.sum(nb * dp, dim=-1))
        return (va & vb & (cos > cos_gate) & (dist_a < cfg.distance_threshold)
                & (dist_b < cfg.distance_threshold))

    compat_r = edge_compat(
        p[..., :-1, :, :], normals[..., :-1, :, :], valid[..., :-1, :],
        p[..., 1:, :, :], normals[..., 1:, :, :], valid[..., 1:, :],
    )
    compat_c = edge_compat(
        p[..., :, :-1, :], normals[..., :, :-1, :], valid[..., :, :-1],
        p[..., :, 1:, :], normals[..., :, 1:, :], valid[..., :, 1:],
    )
    return p, compat_r, compat_c


def segment_planes_sensor(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    cfg: SegmentationConfig = SegmentationConfig(),
) -> PlaneSet:
    """Segment planes in organized sensor clouds (camera frame).

    xyz: (..., H, W, 3); rgb: (..., H, W, 3) BGR 0..255; valid: (..., H, W)
    bool.  Returns a PlaneSet (..., K) with K = cfg.max_planes_sensor in
    the same frame as xyz."""
    h, w = valid.shape[-2:]
    lead = valid.shape[:-2]
    dev = xyz.device
    k_cap = cfg.max_planes_sensor
    p, compat_r, compat_c = _compat_masks(xyz, valid, cfg)
    labels = _connected_labels(compat_r, compat_c, valid, cfg.cc_iters)
    n_pix = h * w
    flat_lab = torch.where(valid, labels, n_pix).reshape(-1, n_pix).long()  # invalid -> bin h*w
    nb = flat_lab.shape[0]
    nbins = n_pix + 1
    # exact integer label histogram of every batch element at once (an
    # integer scatter-add: exact in any order, and unlike `bincount` it
    # needs no host sync for its length)
    off = torch.arange(nb, device=dev)[:, None] * nbins
    idx = (flat_lab + off).reshape(-1)
    counts = torch.zeros(nb * nbins, dtype=torch.int64, device=dev).index_add_(
        0, idx, torch.ones_like(idx))
    counts = counts.reshape(nb, nbins)[:, :-1]

    k_labels = _top_indices(counts, k_cap)  # (nb, K)
    k_counts = torch.gather(counts, 1, k_labels)
    seg_ok = k_counts >= cfg.min_inliers

    member = flat_lab[:, None, :] == k_labels[:, :, None]  # (nb, K, N)
    onehot = member.to(torch.float32)
    ones = valid.reshape(nb, n_pix).to(torch.float32)
    pf = p.reshape(nb, n_pix, 3)
    ppt = (pf[..., :, None] * pf[..., None, :]).reshape(nb, n_pix, 9)
    moments = torch.cat([ones[..., None], pf * ones[..., None], ppt * ones[..., None]], dim=-1)
    segsum = onehot @ moments  # (nb, K, 13), full f32

    s1 = segsum[..., 0]
    sp = segsum[..., 1:4]
    spp = segsum[..., 4:13].reshape(nb, k_cap, 3, 3)
    cnt = torch.clamp(s1, min=1.0)
    centroid = sp / cnt[..., None]
    cov = spp / cnt[..., None, None] - centroid[..., :, None] * centroid[..., None, :]

    eigval, eigvec = torch.linalg.eigh(cov)  # ascending
    normal = eigvec[..., 0]
    flip = torch.sum(normal * centroid, dim=-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    curvature = eigval[..., 0] / torch.clamp(torch.sum(eigval, dim=-1), min=1e-12)
    d = -torch.sum(normal * centroid, dim=-1)

    # in-plane basis for the hull and the elongation
    e1 = eigvec[..., 2]
    e2 = eigvec[..., 1]
    rel = pf[:, None, :, :] - centroid[:, :, None, :]  # (nb, K, N, 3)
    u = torch.sum(rel * e1[:, :, None, :], dim=-1)
    v = torch.sum(rel * e2[:, :, None, :], dim=-1)

    # extreme points along hull_dirs directions -> polygon
    # jnp.linspace(0, 2 pi, R, endpoint=False) in f32: 2 pi * (i / R)
    angles = torch.arange(cfg.hull_dirs, dtype=torch.float32, device=dev) / cfg.hull_dirs * (2 * math.pi)
    proj = (u[:, :, None, :] * torch.cos(angles)[None, None, :, None]
            + v[:, :, None, :] * torch.sin(angles)[None, None, :, None])  # (nb, K, R, N)
    proj = torch.where(member[:, :, None, :], proj, -math.inf)
    idx = torch.argmax(proj, dim=-1)  # (nb, K, R)
    hull_u = torch.gather(u, 2, idx)
    hull_v = torch.gather(v, 2, idx)
    hull = (centroid[:, :, None, :] + hull_u[..., None] * e1[:, :, None, :]
            + hull_v[..., None] * e2[:, :, None, :])

    # shoelace area of the (u, v) polygon
    u2 = torch.roll(hull_u, -1, dims=-1)
    v2 = torch.roll(hull_v, -1, dims=-1)
    area = 0.5 * torch.abs(torch.sum(hull_u * v2 - u2 * hull_v, dim=-1))

    lam1 = torch.sqrt(torch.clamp(eigval[..., 2], min=1e-12))
    lam2 = torch.sqrt(torch.clamp(eigval[..., 1], min=1e-12))
    elongation = lam1 / torch.clamp(lam2, min=1e-9)

    rgbf = rgb.reshape(nb, n_pix, 3).to(torch.float32)
    hue_bins = _rgb_to_hue_hist(rgbf)
    # one-hot by comparison (`F.one_hot` checks its range with a host sync)
    hue_onehot = (hue_bins[..., None] == torch.arange(37, device=dev)).to(torch.float32)
    seg_hist = onehot @ (hue_onehot * ones[..., None])
    hist = seg_hist / torch.clamp(torch.sum(seg_hist, dim=-1, keepdim=True), min=1.0)
    mean_rgb = (onehot @ (rgbf * ones[..., None])) / cnt[..., None] / 255.0

    plane_ok = (
        seg_ok
        & (area >= cfg.min_area)
        & (elongation <= cfg.max_elongation)
        & (curvature < cfg.max_curvature_estimate)
    )
    out = PlaneSet(
        normal=normal, center=centroid, d=d, curvature=curvature, area=area,
        elongation=elongation, n_inliers=s1, hull=hull, hue_hist=hist,
        main_color=torch.flip(mean_rgb, dims=(-1,)),  # BGR -> RGB
        valid=plane_ok,
    )
    return out.map(lambda name, a: a.reshape(*lead, *a.shape[1:]))


def vertical_planes_mask(
    planes: PlaneSet, dev_angle_deg: float = 5.0, up_axis: int = 1
) -> torch.Tensor:
    """Mask of valid planes whose normal is horizontal within
    `dev_angle_deg` (walls; reference `Miscellaneous.h:getVerticalPlanes`)."""
    s = torch.sin(torch.deg2rad(torch.tensor(dev_angle_deg, dtype=torch.float32)))
    return planes.valid & (torch.abs(planes.normal[..., up_axis]) < s.to(planes.normal.device))


def transform_planes(planes: PlaneSet, rt: torch.Tensor) -> PlaneSet:
    """Rigidly transform a PlaneSet (reference `Plane::transform`); rt
    (..., 4, 4) with the plane set's leading axes (one pose per sensor)."""
    r, t = rt[..., :3, :3], rt[..., :3, 3]
    rmt = r.mT
    normal = planes.normal @ rmt
    center = planes.center @ rmt + t[..., None, :]
    hull = planes.hull @ rmt[..., None, :, :] + t[..., None, None, :]
    return dataclasses.replace(
        planes, normal=normal, center=center, d=-torch.sum(normal * center, dim=-1), hull=hull
    )


def concat_sets(planes: PlaneSet) -> PlaneSet:
    """The plane sets (..., S, K) concatenated in order along the plane
    axis, (..., S*K): the reference's `merge_plane_sets` input list of S
    per-sensor sets, as one set."""
    return planes.map(
        lambda name, a: a.flatten(a.ndim + _plane_dim(name) - 1, a.ndim + _plane_dim(name))
    )


def _min_hull_dist(hull_a, hull_b):
    """Min pairwise vertex distance between two hull polygons (..., R, 3)."""
    d = torch.linalg.norm(hull_a[..., :, None, :] - hull_b[..., None, :, :], dim=-1)
    return torch.amin(d, dim=(-2, -1))


def merge_plane_sets(cat: PlaneSet, cfg: SegmentationConfig) -> PlaneSet:
    """Merge co-planar duplicates within one plane set (the reference's
    `groupPlanes` + `mergePlanes`; the reference takes a list of per-sensor
    sets, which `concat_sets` joins into `cat` first): two planes unify when
    their normals agree, their offsets and hulls are close, and union-find
    runs as 8 rounds of min-label propagation over the K x K adjacency.
    Merged attributes are inlier-weighted sums, taken as one-hot matmuls
    (deterministic on the card, unlike an atomic scatter)."""
    normal, center, d, valid = cat.normal, cat.center, cat.d, cat.valid
    hull, n_in = cat.hull, cat.n_inliers
    k = normal.shape[-2]
    dev = normal.device

    ndot = normal @ normal.mT
    dd = torch.abs(d[..., :, None] - d[..., None, :])
    hd = _min_hull_dist(hull[..., :, None, :, :], hull[..., None, :, :, :])
    close_disp = torch.abs(normal @ center.mT + d[..., :, None])
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    same = (
        valid[..., :, None] & valid[..., None, :]
        & (ndot > cfg.merge_normal_dot)
        & (dd < cfg.merge_dist_d)
        & (hd < cfg.group_max_dist_hull)
        & (close_disp < cfg.group_max_dist_parallel * 2)
    ) | eye

    lab = torch.arange(k, device=dev).expand(valid.shape)
    for _ in range(8):
        lmat = torch.where(same, lab[..., None, :], k)
        newlab = torch.minimum(lab, torch.amin(lmat, dim=-1))
        lab = torch.gather(newlab, -1, newlab)

    # (..., k_members, k_roots) one-hot: the merge sums are matmuls
    onehot = (lab[..., :, None] == torch.arange(k, device=dev)).to(torch.float32)
    roots_t = onehot.mT
    wgt = torch.where(valid, n_in, 0.0)

    def seg(vals):  # (..., k, c) -> (..., k_roots, c)
        # an invalid member adds nothing, whatever its fields hold: a
        # degenerate slot's `eigh` may come back non-finite on the card, and
        # 0 * nan in the product would spread it to every merged plane
        return roots_t @ torch.where(valid[..., None], vals, 0.0)

    wsum = seg(wgt[..., None])[..., 0]
    wsafe = torch.clamp(wsum, min=1e-6)
    m_center = seg(center * wgt[..., None]) / wsafe[..., None]
    m_normal = seg(normal * wgt[..., None])
    m_norm = torch.linalg.norm(m_normal, dim=-1, keepdim=True)
    m_normal = m_normal / torch.clamp(m_norm, min=1e-12)
    m_d = -torch.sum(m_normal * m_center, dim=-1)
    m_curv = seg((cat.curvature * wgt)[..., None])[..., 0] / wsafe
    m_area = seg(torch.where(valid, cat.area, 0.0)[..., None])[..., 0]
    m_elong = seg((cat.elongation * wgt)[..., None])[..., 0] / wsafe
    m_hist = seg(cat.hue_hist * wgt[..., None])
    m_hist = m_hist / torch.clamp(torch.sum(m_hist, dim=-1, keepdim=True), min=1e-6)
    m_color = seg(cat.main_color * wgt[..., None]) / wsafe[..., None]
    is_root = lab == torch.arange(k, device=dev)
    m_valid = is_root & (wsum > 0)

    # the merged plane keeps the hull of its largest member
    scores = onehot * torch.where(valid, n_in, -1.0)[..., None]
    best_member = torch.argmax(scores, dim=-2)  # (..., k_roots), first max
    m_hull = torch.gather(hull, -3, best_member[..., None, None].expand(hull.shape))

    merged = PlaneSet(
        normal=m_normal, center=m_center, d=m_d, curvature=m_curv, area=m_area,
        elongation=m_elong, n_inliers=wsum, hull=m_hull, hue_hist=m_hist,
        main_color=m_color, valid=m_valid,
    )
    return _compact_top(merged, cfg.max_planes)


def _compact_top(planes: PlaneSet, k_out: int) -> PlaneSet:
    """Keep the k_out largest-area valid planes, compacted to the front
    (ties to the lower slot, as `lax.top_k`)."""
    k_have = planes.valid.shape[-1]
    if k_have < k_out:  # pad capacity with invalid slots first

        def pad(name, a):
            dim = a.ndim + _plane_dim(name)
            shape = list(a.shape)
            shape[dim] = k_out - k_have
            return torch.cat([a, torch.zeros(shape, dtype=a.dtype, device=a.device)], dim=dim)

        planes = planes.map(pad)
    score = torch.where(planes.valid, planes.area, -1.0)
    order = _top_indices(score, k_out)

    def take(name, a):
        dim = a.ndim + _plane_dim(name)
        idx = order.reshape(order.shape + (1,) * _TRAIL[name])
        return torch.gather(a, dim, idx.expand(*order.shape, *a.shape[dim + 1:]))

    return planes.map(take)
