"""Plane-graph matching and closed-form pose from plane correspondences
(twin of `rgbd360_tpu/registration/planes.py`).

The PbMap interpretation tree becomes masked exhaustive consistency
scoring: every candidate pair's unary gates, every pair of pairs' binary
consistency (a (K1, K2, K1, K2) mask), then a greedy one-to-one match set
grown by area-weighted consistency votes for `max_matches` steps.  The
steps are a Python loop over device tensors with no host sync inside it
(the reference's `lax.scan`).  The pose is the closed-form weighted
alignment of the matched normals (SVD) with an eigen-truncated
least-squares translation, refined by Huber IRLS and two redescending
passes, and its information matrix from the same linear system.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rgbd360_tpu_torch.config import MatcherConfig
from rgbd360_tpu_torch.ops.segmentation import PlaneSet

# Registration modes (reference `RegisterRGBD360.h:264-269`)
DEFAULT_6DOF = 0
PLANAR_3DOF = 1
ODOMETRY_6DOF = 2
PLANAR_ODOMETRY_3DOF = 3


@dataclass
class MatchResult:
    """Fixed-capacity match set + pose estimate.

    pairs: (M, 2) int32 indices (ref_plane, trg_plane), -1 padded.
    n_matches: () int32
    area_matched: () float, total matched hull area in the ref frame
    pose: (4, 4), maps target-frame points into the ref frame
    information: (6, 6)
    success: () bool
    """

    pairs: torch.Tensor
    n_matches: torch.Tensor
    area_matched: torch.Tensor
    pose: torch.Tensor
    information: torch.Tensor
    success: torch.Tensor


def _f32_gate(fn, deg: float) -> float:
    """fn(deg2rad(deg)) computed in f32, as the reference's jnp gates are,
    on the host: a Python float holding an f32 value compares exactly like
    the reference's f32 scalar (and needs no copy to the card)."""
    return fn(torch.deg2rad(torch.tensor(deg, dtype=torch.float32))).item()


def _bhattacharyya(h1, h2):
    """Bhattacharyya coefficient between color histograms."""
    return torch.sum(torch.sqrt(torch.clamp(h1, min=0.0) * torch.clamp(h2, min=0.0)), dim=-1)


def unary_compatibility(
    ref: PlaneSet, trg: PlaneSet, cfg: MatcherConfig, mode: int
) -> torch.Tensor:
    """(K1, K2) bool: which plane pairs may correspond."""
    a1 = ref.area[:, None]
    a2 = trg.area[None, :]
    ratio_area = torch.maximum(a1, a2) / torch.clamp(torch.minimum(a1, a2), min=1e-6)
    e1 = ref.elongation[:, None]
    e2 = trg.elongation[None, :]
    ratio_elong = torch.maximum(e1, e2) / torch.clamp(torch.minimum(e1, e2), min=1e-6)
    color_ok = (
        _bhattacharyya(ref.hue_hist[:, None, :], trg.hue_hist[None, :, :])
        > 1.0 - cfg.hue_threshold
    )
    ok = (
        ref.valid[:, None]
        & trg.valid[None, :]
        & (ratio_area < cfg.area_threshold)
        & (ratio_elong < cfg.elongation_threshold)
        & color_ok
    )
    if mode in (ODOMETRY_6DOF, PLANAR_ODOMETRY_3DOF):
        # small-motion assumption: normals and offsets must roughly agree
        ndot = ref.normal @ trg.normal.mT
        cos_gate = _f32_gate(torch.cos, cfg.unary_angle_deg)
        dd = torch.abs(ref.d[:, None] - trg.d[None, :])
        ok = ok & (ndot > cos_gate) & (dd < cfg.unary_dist_d)
    if mode in (PLANAR_3DOF, PLANAR_ODOMETRY_3DOF):
        # planar motion: vertical planes stay vertical, horizontal stay
        # horizontal (the rig's x axis is up in the sphere frame)
        up1 = torch.abs(ref.normal[:, 0])[:, None]
        up2 = torch.abs(trg.normal[None, :, 0])
        ok = ok & (torch.abs(up1 - up2) < 0.2)
    return ok


def binary_consistency(
    ref: PlaneSet, trg: PlaneSet, cand: torch.Tensor, cfg: MatcherConfig
) -> torch.Tensor:
    """(K1, K2, K1, K2) bool: pair (i, j) is geometrically consistent with
    pair (k, l): rigid-invariant relations are preserved."""
    ang1 = ref.normal @ ref.normal.mT  # cos angles
    ang2 = trg.normal @ trg.normal.mT
    cos_tol = _f32_gate(lambda x: x, cfg.binary_angle_threshold_deg)
    ang_ok = torch.abs(
        torch.arccos(torch.clamp(ang1, -1, 1))[:, None, :, None]
        - torch.arccos(torch.clamp(ang2, -1, 1))[None, :, None, :]
    ) < cos_tol

    dist1 = torch.linalg.norm(ref.center[:, None] - ref.center[None, :], dim=-1)
    dist2 = torch.linalg.norm(trg.center[:, None] - trg.center[None, :], dim=-1)
    dist_ok = (
        torch.abs(dist1[:, None, :, None] - dist2[None, :, None, :])
        < cfg.binary_dist_threshold
    )

    # height relation: the distance of plane k's center to plane i's plane
    # must be preserved (reference binary height_threshold)
    h1 = ref.normal @ ref.center.mT + ref.d[:, None]
    h2 = trg.normal @ trg.center.mT + trg.d[:, None]
    h_ok = torch.abs(h1[:, None, :, None] - h2[None, :, None, :]) < cfg.height_threshold * 3

    c = cand[:, :, None, None] & cand[None, None, :, :]
    # a pair is never consistent with a conflicting pair (shared plane)
    k1, k2 = cand.shape
    dev = cand.device
    i_eq = torch.eye(k1, dtype=torch.bool, device=dev)[:, None, :, None]
    j_eq = torch.eye(k2, dtype=torch.bool, device=dev)[None, :, None, :]
    conflict = (i_eq | j_eq) & ~(i_eq & j_eq)
    return c & ang_ok & dist_ok & h_ok & ~conflict


def match_planes(
    ref: PlaneSet, trg: PlaneSet, cfg: MatcherConfig, mode: int = PLANAR_3DOF
):
    """Greedy maximum-consistent-set matching: (pairs (M, 2) int32 padded
    with -1, n_matches).  `max_matches` steps, each on the device with no
    host sync."""
    cand = unary_compatibility(ref, trg, cfg, mode)
    cons = binary_consistency(ref, trg, cand, cfg)
    k1, k2 = cand.shape
    m_cap = cfg.max_matches
    dev = cand.device

    # weight votes by matched area so large planes anchor the match
    w = torch.sqrt(
        torch.clamp(ref.area[:, None], min=1e-3) * torch.clamp(trg.area[None, :], min=1e-3)
    )
    cons_flat = cons.reshape(k1 * k2, k1 * k2)
    cons_f = cons_flat.to(torch.float32)
    rows = torch.arange(k1, device=dev)[:, None]
    cols = torch.arange(k2, device=dev)[None, :]
    slots = torch.arange(m_cap, device=dev)[:, None]
    none = torch.full((2,), -1, dtype=torch.int32, device=dev)
    cand_live = cand
    chosen = torch.full((m_cap, 2), -1, dtype=torch.int32, device=dev)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(m_cap):
        votes = (cons_f @ (cand_live * w).reshape(-1)).reshape(k1, k2)
        votes = torch.where(cand_live, votes * w, -1.0).reshape(-1)
        best = torch.argmax(votes)  # the first of tied votes, as jnp.argmax
        ok = torch.amax(votes) > 0
        bi, bj = best // k2, best % k2
        # keep only pairs consistent with the chosen one; a matched plane
        # cannot match again (one-to-one), so drop its row and column too
        cons_b = torch.index_select(cons_flat, 0, best.reshape(1)).reshape(k1, k2)
        cand_next = cand_live & cons_b & (rows != bi) & (cols != bj)
        pick = torch.where(ok, torch.stack([bi, bj]).to(torch.int32), none)
        chosen = torch.where(slots == n, pick, chosen)
        cand_live = torch.where(ok, cand_next, cand_live)
        n = n + ok.to(torch.int32)
    return chosen, n


def pose_from_matches(
    ref: PlaneSet, trg: PlaneSet, pairs: torch.Tensor, n_matches: torch.Tensor
):
    """Closed-form pose + information from matched planes: (pose (4, 4)
    T_ref<-trg, information (6, 6), observable ()).  R aligns the target's
    normals to the reference's (weighted SVD), t solves n1 . t = d2 - d1
    (eigen-truncated); see the reference for the IRLS and the redescending
    outlier revocation."""
    dev = pairs.device
    vmask = (pairs[:, 0] >= 0).to(torch.float32)
    i = torch.clamp(pairs[:, 0], min=0).long()
    j = torch.clamp(pairs[:, 1], min=0).long()
    n1 = ref.normal[i]
    n2 = trg.normal[j]
    d1 = ref.d[i]
    d2 = trg.d[j]
    diag = torch.ones(3, device=dev)

    def huber_w(r, scale):
        a_ = torch.abs(r)
        return torch.where(a_ < scale, 1.0, scale / torch.clamp(a_, min=1e-12))

    def solve(w):
        # rotation: maximize sum w_k (R n2_k) . n1_k
        corr = (n1 * w[:, None]).mT @ n2
        uu, _, vt = torch.linalg.svd(corr)
        det = torch.linalg.det(uu @ vt)
        s = torch.diag(torch.cat([diag[:2], det.reshape(1)]))
        rot = uu @ s @ vt
        # translation: n1_k . t = d2_k - d1_k
        rhs = (d2 - d1) * w
        amat = n1 * w[:, None]
        ata = amat.mT @ amat
        att = amat.mT @ rhs
        # eigen-truncated solve: directions carrying less than ~a quarter
        # of one unit-weight constraint are unobserved and get exactly 0
        evals, evecs = torch.linalg.eigh(ata)
        inv = torch.where(evals > 0.25, 1.0 / torch.clamp(evals, min=1e-12), 0.0)
        t = evecs @ (inv * (evecs.mT @ att))
        return rot, t, ata

    w = vmask
    rot, t, ata = solve(w)
    for _ in range(2):  # IRLS refinement
        r_t = n1 @ t - (d2 - d1)
        r_r = 1.0 - torch.sum(n1 * (n2 @ rot.mT), dim=-1)
        w = vmask * huber_w(r_t, 0.05) * huber_w(r_r, 0.002)
        rot, t, ata = solve(w)
    # redescending passes: hard-zero grossly inconsistent pairs, and revoke
    # survivors that share a cut pair's normal direction without a second
    # supporting inlier (see the reference for why)
    for _ in range(2):
        r_t = n1 @ t - (d2 - d1)
        r_r = 1.0 - torch.sum(n1 * (n2 @ rot.mT), dim=-1)
        wsum = torch.clamp(torch.sum(w), min=1e-9)
        thr_t = torch.clamp(4.0 * torch.sqrt(torch.sum(w * r_t**2) / wsum), min=0.15)
        thr_r = torch.clamp(4.0 * torch.sqrt(torch.sum(w * r_r**2) / wsum), min=0.01)
        keep = (torch.abs(r_t) < thr_t) & (r_r < thr_r)
        cut = (w > 0.0) & ~keep
        same_dir = torch.abs(n1 @ n1.mT) > 0.966  # ~15 deg
        suspect = torch.any(same_dir & cut[None, :], dim=1)
        support = torch.sum(same_dir & keep[None, :] & (w[None, :] > 0.0), dim=1) - 1
        keep = keep & (~suspect | (support >= 1))
        w = torch.where(keep, w, 0.0)
        rot, t, ata = solve(w)
    det_t = torch.linalg.det(ata)

    pose = torch.eye(4, device=dev)
    pose[:3, :3] = rot
    pose[:3, 3] = t
    a = w  # the final robust weights feed the information matrix

    # information: translation block = A^T A; rotation block from the
    # normal-alignment residuals, J_r = -skew(R n2) per constraint
    rn2 = n2 @ rot.mT
    z = torch.zeros_like(rn2[:, 0])
    jr = -torch.stack(
        [z, -rn2[:, 2], rn2[:, 1], rn2[:, 2], z, -rn2[:, 0], -rn2[:, 1], rn2[:, 0], z],
        dim=-1,
    ).reshape(-1, 3, 3)
    h_rot = torch.einsum("k,kij,kil->jl", a, jr, jr)
    info = torch.zeros((6, 6), device=dev)
    info[:3, :3] = ata
    info[3:, 3:] = h_rot

    observable = (n_matches >= 3) & (det_t > 1e-9)
    return pose, info, observable


class PlaneRegistration:
    """RegisterRGBD360 equivalent: match two frames' PbMaps and solve pose."""

    def __init__(self, cfg: MatcherConfig = MatcherConfig()):
        self.cfg = cfg

    def register(self, ref: PlaneSet, trg: PlaneSet, mode: int = PLANAR_3DOF) -> MatchResult:
        """T_ref<-trg from the two plane sets; the result stays on the
        device (identity pose unless `success`)."""
        cfg = self.cfg
        pairs, n = match_planes(ref, trg, cfg, mode)
        pose, info, observable = pose_from_matches(ref, trg, pairs, n)
        vmask = pairs[:, 0] >= 0
        area = torch.sum(torch.where(vmask, ref.area[torch.clamp(pairs[:, 0], min=0).long()], 0.0))
        success = observable & (n >= cfg.min_planes_recognition)
        return MatchResult(
            pairs=pairs,
            n_matches=n,
            area_matched=area,
            pose=torch.where(success, pose, torch.eye(4, device=pose.device)),
            information=info,
            success=success,
        )

