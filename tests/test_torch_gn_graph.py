"""The dense GN loop on static tensors (`dense._gn_graph_loop`) and its
cache of graphs, on the CPU: the same body runs eagerly here, the card
replays it from CUDA graphs (`tests/test_torch_cuda.py` holds the two
against each other there).

The loop is held bit for bit to a copy of the closure loop it replaced
(`_closure_gn_loop` below), through one level and through whole single
and batched alignments; the cache is keyed by what the captured code
reads; the rig aligner's joint sweep and the sharded sweep, which a graph
must not capture, never reach it."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch.config import DenseRegConfig
from rgbd360_tpu_torch.ops import se3
from rgbd360_tpu_torch.parallel import sharded as S
from rgbd360_tpu_torch.registration import dense as D
from rgbd360_tpu_torch.registration import rig_dense as R

CFG = DenseRegConfig(pyramid_levels=3)
H, W = 48, 288


def _sphere_pair(seed: int, h: int = H, w: int = W):
    """A textured sphere and the same sphere turned by two columns, with
    sensor noise from `seed`: (gray, depth) pairs on the CPU."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ph = rng.uniform(0, 2 * np.pi, 3)
    gray = (0.5 + 0.25 * np.sin(xx * 0.35 + ph[0]) + 0.2 * np.cos(yy * 0.45 + ph[1])
            + 0.1 * np.sin((xx + yy) * 0.2 + ph[2]))
    depth = 3.0 + 0.8 * np.sin(xx * 0.25 + ph[1]) + 0.5 * np.cos(yy * 0.3 + ph[2])
    gray2 = np.roll(gray, 2, axis=1) + rng.normal(0, 0.002, (h, w))
    depth2 = np.roll(depth, 2, axis=1)
    return [(torch.tensor(g, dtype=torch.float32), torch.tensor(d, dtype=torch.float32))
            for g, d in ((gray, depth), (gray2, depth2))]


def _pyramids(seed: int, cfg=CFG):
    (g1, d1), (g2, d2) = _sphere_pair(seed)
    return D.build_frame_pyramid(g2, d2, cfg), D.build_frame_pyramid(g1, d1, cfg)


def _seed_pose(seed: int, n: int | None = None):
    rng = np.random.default_rng(100 + seed)
    xi = rng.normal(0, 0.01, (n or 1, 6)).astype(np.float32)
    pose = se3.se3_exp(torch.tensor(xi))
    return pose if n else pose[0]


def _closure_gn_loop(sweep, pose, ill, cfg, max_iters, st_best):
    """The dense GN loop as it stood before it ran on static tensors, kept
    verbatim as the reference: a closure sweep and functional updates."""
    dev = pose.device
    batch = pose.shape[:-2]
    cand, best = pose, pose
    err_best = torch.full(batch, math.inf, device=dev)
    it = torch.full(batch, -1, dtype=torch.int64, device=dev)
    upd = torch.ones(batch, device=dev)
    diff = torch.ones(batch, device=dev)
    ill = ill.expand(batch)
    h_best = torch.zeros(batch + (6, 6), device=dev)
    trips = 0

    def active():
        return (it < max_iters) & (upd > cfg.tol_update) & (diff > cfg.tol_residual) & ~ill

    run = active()
    while bool(run.any()):
        trips += 1
        hess, grad, stats = sweep(cand)
        err = stats["mean_err"]
        bad, update = D._solve_step(hess, grad)
        accept = ((err_best - err) > cfg.tol_residual) & ~bad
        step = run & accept
        best = D._where(step, cand, best)
        h_best = D._where(step, hess, h_best)
        st_best = {k: D._where(step, stats[k], st_best[k]) for k in st_best}
        cand = D._where(step, se3.se3_exp(update) @ cand, D._where(run, best, cand))
        it = it + step.to(it.dtype)
        diff = D._where(run, torch.where(bad, 0.0, err_best - err), diff)
        err_best = D._where(step, err, err_best)
        upd = D._where(run, torch.linalg.norm(update, dim=-1), upd)
        ill = ill | (run & bad)
        run = active()
    return (best, err_best, it, ill, h_best, st_best), trips


def _closure_gn_level(trips: list):
    """`_gn_level` over the closure loop, adding each level's trips to
    `trips[0]`."""

    def level(src_gray, pts, valid_src, trg_pack, pose, ill, cfg, method, occlusion, intr,
              max_iters):
        def sweep(cand):
            return D._hess_grad_packed(src_gray, pts, valid_src, trg_pack, cand, cfg, method,
                                       occlusion, intr)

        out, n = _closure_gn_loop(sweep, pose, ill, cfg, max_iters,
                                  D._stats0(method, pose.shape[:-2], pose.device))
        trips[0] += n
        return out

    return level


def _assert_equal_out(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
        else:
            assert torch.equal(x, y)


def _level_inputs(src, trg, lvl, cfg=CFG):
    g, pts, valid = D._flat_points(src.depth[lvl][None], src.gray[lvl][None], cfg)
    pack = D._pack_target({k: getattr(trg, k)[lvl][None] for k in D._CHANNELS}, cfg.bilinear)
    return g, pts, valid, pack


@pytest.mark.parametrize("occlusion", [0, 2])
@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batch3"])
def test_gn_level_equals_the_closure_loop(batch, occlusion):
    """One level from a perturbed seed, single and batched (a shared source
    against three seeds): the static-tensor loop gives the closure loop's
    pose, error, iterations, flags, Hessian and statistics bit for bit,
    in as many trips, none of them replayed."""
    src, trg = _pyramids(0)
    g, pts, valid, pack = _level_inputs(src, trg, 1)
    pose = _seed_pose(0, batch).expand(batch or 1, 4, 4)
    ill = torch.zeros(batch or 1, dtype=torch.bool)
    st0 = D._stats0(D.PHOTO_DEPTH, pose.shape[:-2], pose.device)

    def sweep(cand):
        return D._hess_grad_packed(g, pts, valid, pack, cand, CFG, D.PHOTO_DEPTH, occlusion)

    want, trips = _closure_gn_loop(sweep, pose, ill, CFG, CFG.max_iters_per_level, st0)
    before = dict(D.GN_COUNTS)
    got = D._gn_level(g, pts, valid, pack, pose, ill, CFG, D.PHOTO_DEPTH, occlusion, None,
                      CFG.max_iters_per_level)
    assert D.GN_COUNTS["sweep"] - before["sweep"] == trips >= 2
    assert D.GN_COUNTS["replay"] == before["replay"]
    _assert_equal_out(got, want)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch3"])
def test_align_equals_the_closure_loop(monkeypatch, batched):
    """Whole coarse-to-fine solves, salient levels and dense polish
    included: one pair, and one source against three targets with their
    own seeds (the verification's batch).  Every field of the result and
    the trip count equal the closure loop's; `replays` is 0 off the card."""
    cfg = dataclasses.replace(CFG, salient_pixels=1024, polish_iters=2)
    al = D.DenseAligner(cfg)
    src, trg = _pyramids(1, cfg)
    if batched:
        trgs = [trg, _pyramids(2, cfg)[1], _pyramids(3, cfg)[1]]
        seeds = list(_seed_pose(1, 3))

        def solve():
            return D.batch_align_targets_dispatch(al, src, trgs, seeds)
    else:
        def solve():
            return al.align(src, trg, _seed_pose(1))
    got = solve()
    trips = [0]
    monkeypatch.setattr(D, "_gn_level", _closure_gn_level(trips))
    want = solve()
    assert got.sweeps == trips[0] > 0 and got.replays == 0 and want.replays == 0
    for k, v in vars(want).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(got, k), v), k


def test_static_tensors_are_reloaded_and_results_are_the_callers():
    """A second solve of the same shapes reuses the first's static tensors
    (one cache entry a level) and gives its own answer; the result the
    first handed back is untouched by the second."""
    al = D.DenseAligner(CFG)
    a_src, a_trg = _pyramids(4)
    b_src, b_trg = _pyramids(5)
    first = al.align(a_src, a_trg, _seed_pose(4))
    kept = {k: v.clone() for k, v in vars(first).items() if isinstance(v, torch.Tensor)}
    n_keys = len(D._GRAPHS)
    second = al.align(b_src, b_trg, _seed_pose(5))
    assert len(D._GRAPHS) == n_keys
    for k, v in kept.items():
        assert torch.equal(getattr(first, k), v), k
    D._GRAPHS.clear()
    fresh = al.align(b_src, b_trg, _seed_pose(5))
    for k, v in vars(fresh).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(second, k), v), k
    assert not torch.equal(first.pose, second.pose)


def test_coarse_align_on_static_tensors():
    """`coarse_align` over a 16-hypothesis yaw grid on static tensors: the
    plain refinement's poses and errors, twice over different data."""
    al = D.DenseAligner(CFG)
    cands = torch.as_tensor(se3.yaw_grid(16), dtype=torch.float32)
    for seed in (6, 7):
        src, trg = _pyramids(seed)
        got = al.coarse_align(src, trg, cands, iters=4)
        (g, pts, valid, pack), _ = al._coarsest(src, trg)
        want = D._coarse_refine(dict(src_gray=g, pts=pts, valid_src=valid, trg_pack=pack),
                                cands, CFG, D.PHOTO_DEPTH, 4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _key(inputs, pose, ill, cfg=CFG, method=D.PHOTO_DEPTH, occlusion=0, max_iters=10):
    return D._graph_key("gn", dict(inputs, pose=pose, ill=ill), cfg, method, occlusion,
                        max_iters)


def test_graph_key_separates_what_the_capture_reads():
    """Same shapes with other data share a key; another level's shapes, a
    batch, the method, the occlusion mode, the loop's bound, a pinhole K or
    a number the sweep reads each make another."""
    src, trg = _pyramids(0)
    g, pts, valid, pack = _level_inputs(src, trg, 1)
    inp = dict(src_gray=g, pts=pts, valid_src=valid, trg_pack=pack)
    pose, ill = torch.eye(4).expand(1, 4, 4), torch.zeros(1, dtype=torch.bool)
    base = _key(inp, pose, ill)
    other = dict(src_gray=g + 1, pts=pts * 2, valid_src=~valid, trg_pack=pack * 3)
    assert _key(other, se3.se3_exp(torch.ones(1, 6)), ill | True) == base
    g2, pts2, valid2, pack2 = _level_inputs(src, trg, 2)
    variants = [
        _key(dict(src_gray=g2, pts=pts2, valid_src=valid2, trg_pack=pack2), pose, ill),
        _key(inp, pose.expand(3, 4, 4), ill.expand(3)),
        _key(inp, pose, ill, method=D.PHOTO_CONSISTENCY),
        _key(inp, pose, ill, occlusion=1),
        _key(inp, pose, ill, max_iters=2),
        _key(dict(inp, intr=torch.eye(3)), pose, ill),
        _key(inp, pose, ill, cfg=dataclasses.replace(CFG, std_depth=0.02)),
        D._graph_key("coarse", dict(inp, pose=pose), CFG, D.PHOTO_DEPTH, 0, 10),
    ]
    assert len({base, *variants}) == len(variants) + 1
    # configuration fields the sweep does not read do not split the cache
    assert _key(inp, pose, ill, cfg=dataclasses.replace(CFG, salient_pixels=7)) == base


class _Reads:
    """A configuration that records the fields read from it."""

    def __init__(self, cfg):
        self._cfg, self.read = cfg, set()

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(self._cfg, name)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("occlusion", [0, 2])
def test_key_holds_every_field_the_trip_reads(bilinear, occlusion):
    """The captured trip (sweep and update) reads no configuration field
    outside `_SWEEP_FIELDS`: a field it read that the key left out would
    replay a stale graph."""
    cfg = dataclasses.replace(CFG, bilinear=bilinear)
    src, trg = _pyramids(0, cfg)
    g, pts, valid, pack = _level_inputs(src, trg, 1, cfg)
    reads = _Reads(cfg)
    s = D._gn_start(torch.eye(4)[None], torch.zeros(1, dtype=torch.bool),
                    D._stats0(D.PHOTO_DEPTH, (1,), "cpu"), reads, 10)
    sweep = D._hess_grad_packed(g, pts, valid, pack, s["cand"], reads, D.PHOTO_DEPTH, occlusion)
    D._gn_trip(s, *sweep, reads, 10)
    assert reads.read and reads.read <= set(D._SWEEP_FIELDS), reads.read - set(D._SWEEP_FIELDS)


def test_rig_and_sharded_sweeps_never_take_the_static_path():
    """The rig aligner's joint sweep runs the closure loop (`_gn_loop`) and
    the sharded pair sweep calls a collective: neither adds a cache entry,
    while a dense solve of the same run does."""
    rng = np.random.default_rng(0)
    k = np.array([[40.0, 0, 15.5], [0, 40.0, 11.5], [0, 0, 1]], np.float32)
    rts = np.stack([np.eye(4, dtype=np.float32)] * 2)
    rts[1, :3, 3] = [0.05, 0.0, 0.0]
    yy, xx = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    gray = np.stack([0.5 + 0.2 * np.sin(xx * 0.4 + i) + 0.2 * np.cos(yy * 0.5) for i in range(2)])
    depth = np.stack([2.5 + 0.3 * np.sin(xx * 0.2 + i) for i in range(2)])
    cfg = DenseRegConfig(pyramid_levels=2, sal_intensity=0.0, sal_depth=0.0)
    g = torch.tensor(gray + rng.normal(0, 0.002, gray.shape), dtype=torch.float32)
    pyr = R.build_rig_pyramid(g, torch.tensor(depth, dtype=torch.float32), cfg)
    D._GRAPHS.clear()
    sweeps = D.GN_COUNTS["sweep"]
    res = R.RigDenseAligner(k, rts, cfg).align(pyr, pyr)
    assert D.GN_COUNTS["sweep"] > sweeps and bool(torch.isfinite(res.pose).all())
    gray_s, depth_s = _sphere_pair(0, 16, 96)[0]
    pack = D._pack_target({c: getattr(D.build_frame_pyramid(gray_s, depth_s, CFG), c)[0][None]
                           for c in D._CHANNELS})
    S.sharded_pair_align(S.Mesh(None, 0, 1), gray_s[None], depth_s[None], pack,
                         torch.eye(4)[None], CFG, D.PHOTO_DEPTH)
    assert not D._GRAPHS
    D.DenseAligner(CFG).align(*_pyramids(0))
    assert len(D._GRAPHS) == CFG.pyramid_levels
