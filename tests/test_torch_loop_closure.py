"""The loop closer and the relocaliser of the port against the reference's,
on ONE map: built in the port from synthetic loop frames at
`synthetic.config(4, 3)` and carried into the reference leaf by leaf
(`convert.map_to_numpy`), so both packages scan, verify and relocalise on
identical data.

Tolerances.  Gates, candidate indices, match counts and accept/reject
decisions are compared exactly.  Plane poses: 1e-5 m / rad (closed form on
the same matches).  Pyramids rebuilt from the bfloat16 payload: 1e-6
absolute (the kernels' plain versions against the reference's).  The dense
verification is the salient solve (`verify_salient_pixels`), which has
several solutions within reach of rounding (PERF.md): its poses are held to
VERIFY_TOL_M = 2e-3 m / rad and its residuals to 2% (measured 1e-6 m on
these frames).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu import config as jconfig
from rgbd360_tpu.ops.segmentation import PlaneSet as JPlaneSet
from rgbd360_tpu.registration import dense as JD
from rgbd360_tpu.slam import loop_closure as JLC
from rgbd360_tpu.slam.map import Map360 as JMap
from rgbd360_tpu.slam.relocalizer import Relocalizer as JRelocalizer
from rgbd360_tpu_torch import convert, synthetic
from rgbd360_tpu_torch.core.frame import FrameBuilder
from rgbd360_tpu_torch.registration import dense as TD
from rgbd360_tpu_torch.slam import loop_closure as TLC
from rgbd360_tpu_torch.slam.map import Map360
from rgbd360_tpu_torch.slam.odometry import KeyframeSLAM, fetch
from rgbd360_tpu_torch.slam.relocalizer import Relocalizer

from test_torch_segmentation import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SUB, LEVELS, LOOP = 4, 3, 16
FRAMES = [0, 1, 2, 3, 4, 5, 15]  # keyframes 0-5, and the query: keyframe 6
QUERY = 6
VERIFY_TOL_M = 2e-3


def _cfg():
    cfg = synthetic.config(SUB, LEVELS)
    return cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=8, max_edges=16))


@pytest.fixture(scope="module")
def scene():
    """(port map, reference map, frame states, ground-truth poses): seven
    keyframes at their ground-truth poses, keyframe 1 holding a COPY of
    keyframe 0's planes (so their match counts tie), odometry edges, and
    three areas."""
    cfg = _cfg()
    builder = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    slam = KeyframeSLAM(builder, cfg)
    states = [slam.make_state(r) for r in chip_smoke.loop_raws(LOOP, SUB, frames=FRAMES)]
    gt = synthetic.loop_poses(LOOP)[FRAMES].astype(np.float32)
    m = Map360.empty(cfg.map, cfg.sphere.height, cfg.sphere.width, cfg.seg.max_planes,
                     cfg.seg.hull_dirs, "cpu")
    for k, st in enumerate(states):
        planes = states[0].planes if k == 1 else st.planes
        m = m.add_keyframe(gt[k], st.sphere.sphere_gray, st.sphere.sphere_depth, planes, n_live=k)
    ij = np.array([[k, k + 1] for k in range(6)], np.int32)
    m = m.add_edges(ij, np.tile(np.eye(4, dtype=np.float32), (6, 1, 1)),
                    np.tile(np.eye(6, dtype=np.float32), (6, 1, 1)),
                    np.float32([0.9, 0.8, 0.2, 0.8, 0.7, 0.6]), np.zeros(6, bool), n_live=0)
    m.area.copy_(torch.tensor([0, 0, 0, 1, 1, 2, 2, 0], dtype=torch.int32))
    m.n_areas.fill_(3)
    return m, _to_jax(m), states, gt


def _to_jax(m: Map360) -> JMap:
    cfg = _cfg()
    template = JMap.empty(convert.config_to_reference(cfg.map, jconfig), cfg.sphere.height,
                          cfg.sphere.width, cfg.seg.max_planes, cfg.seg.hull_dirs)
    flat, treedef = jax.tree_util.tree_flatten(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a, dtype=x.dtype) for a, x in zip(convert.map_to_numpy(m), flat)])


def _jplanes(p) -> JPlaneSet:
    return JPlaneSet(**{k: jnp.asarray(v) for k, v in convert.plane_set_to_numpy(p).items()})


def _jpyr(pyr: TD.FramePyramid) -> JD.FramePyramid:
    return JD.FramePyramid(**{
        f.name: tuple(jnp.asarray(x.numpy()) for x in getattr(pyr, f.name))
        for f in dataclasses.fields(pyr)
    })


@pytest.fixture(scope="module")
def closers():
    cfg = _cfg()
    return TLC.LoopCloser(cfg), JLC.LoopCloser(convert.config_to_reference(cfg, jconfig))


@pytest.mark.parametrize("n_areas", [1, 3], ids=["unpartitioned", "three_areas"])
@pytest.mark.parametrize("query_kf,exclude", [(6, 2), (6, 0), (3, 1), (9, 2)])
def test_candidate_gate(scene, n_areas, query_kf, exclude):
    m, jm, _, gt = scene
    cfg = _cfg()
    jcfg = convert.config_to_reference(cfg, jconfig)
    m.n_areas.fill_(n_areas)
    jm = dataclasses.replace(jm, n_areas=jnp.int32(n_areas))
    try:
        got = TLC.candidate_gate(m, gt[min(query_kf, 6)], query_kf, exclude, cfg.lc)
    finally:
        m.n_areas.fill_(3)
    ref = JLC.candidate_gate(jm, jnp.asarray(gt[min(query_kf, 6)]), query_kf, exclude, jcfg.lc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if n_areas == 1 and query_kf == 6 and exclude == 2:
        assert got.numpy().tolist() == [True] * 4 + [False] * 4
    ungated = TLC.candidate_gate(m, gt[6], 6, 2, dataclasses.replace(cfg.lc, area_gating=False))
    assert ungated.numpy().tolist() == [True] * 4 + [False] * 4


def test_scan_select_with_tied_match_counts(scene, closers):
    """The scan's survivors, in order: keyframes 0 and 1 hold the same
    planes, tie on the match count, and the older one comes first."""
    m, jm, states, gt = scene
    closer, jcloser = closers
    m.n_areas.fill_(1)  # plain radius scan: both copies are candidates
    try:
        got = fetch(closer.scan_dispatch(m, states[QUERY].planes, gt[QUERY], QUERY))
        capped = fetch(closer.scan_dispatch(m, states[QUERY].planes, gt[QUERY], QUERY,
                                            n_kf_snapshot=3, n_edges_snapshot=2))
    finally:
        m.n_areas.fill_(3)
    jm1 = dataclasses.replace(jm, n_areas=jnp.int32(1))
    ref = jax.device_get(jcloser.scan_dispatch(
        jm1, _jplanes(states[QUERY].planes), jnp.asarray(gt[QUERY]), QUERY))
    jcap = jax.device_get(jcloser.scan_dispatch(
        jm1, _jplanes(states[QUERY].planes), jnp.asarray(gt[QUERY]), QUERY,
        n_kf_snapshot=3, n_edges_snapshot=2))
    for g, r in ((got, ref), (capped, jcap)):
        np.testing.assert_array_equal(g[0].numpy(), r[0])
        np.testing.assert_array_equal(g[1].numpy(), r[1])
        ok = r[1]
        dt, dr = chip_smoke._pose_gaps(g[2].numpy()[ok], r[2][ok])
        assert dt < 1e-5 and dr < 1e-5, (dt, dr)
    idx, ok = got[0].numpy(), got[1].numpy()
    assert ok[:2].all() and idx[:2].tolist() == [0, 1], (idx, ok)
    cand, cand_pose = closer.select_host(got)
    assert cand == [int(i) for i, v in zip(idx, ok) if v] and set(cand_pose) == set(cand)
    # the stable top-k itself, on a score with ties everywhere
    score = torch.tensor([3, 5, 5, -1, 5, 3, -1, -1])
    assert TLC.top_k_stable(score, 4)[1].tolist() == [1, 2, 4, 0]
    assert np.asarray(jax.lax.top_k(jnp.asarray(score.numpy()), 4)[1]).tolist() == [1, 2, 4, 0]


def test_kf_pyramid_from_the_payload(scene, closers):
    """The pyramid rebuilt from the bfloat16 payload (no seam masks) is the
    reference's, differs from the tracker's own seam-masked f32 pyramid of
    the same keyframe, and is memoized."""
    m, jm, states, _ = scene
    closer, jcloser = closers
    cache: dict = {}
    pyr = closer.kf_pyramid(m, 2, cache)
    assert closer.kf_pyramid(m, 2, cache) is pyr and list(cache) == [2]
    ref = jcloser.kf_pyramid(jm, 2)
    for f in dataclasses.fields(pyr):
        for a, b in zip(getattr(pyr, f.name), getattr(ref, f.name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    own = states[2].pyramid
    assert not torch.equal(own.gray[0], pyr.gray[0])  # bfloat16 rounding
    seam_cols = (own.gray_gx[0] == 0).all(dim=0) & ~(pyr.gray_gx[0] == 0).all(dim=0)
    assert not torch.equal(own.gray_gx[0] == 0, pyr.gray_gx[0] == 0) or seam_cols.any()


@pytest.fixture(scope="module")
def verified(scene, closers):
    """The dense verification of candidates 0 and 3 from their plane seeds,
    in both packages: (candidates, seeds, port result, reference result,
    port pyramids)."""
    m, jm, states, gt = scene
    closer, jcloser = closers
    cand = [0, 3]
    seeds = {k: np.linalg.inv(gt[k]) @ gt[QUERY] for k in cand}
    q = states[QUERY].pyramid
    res, pyrs = closer.verify_dispatch(m, q, cand, seeds, {})
    jres, _ = jcloser.verify_dispatch(jm, _jpyr(q), cand,
                                      {k: jnp.asarray(v) for k, v in seeds.items()}, {})
    return cand, seeds, fetch(res), jax.device_get(jres), pyrs


def test_verify_and_gates(verified, closers):
    cand, _, res, jres, _ = verified
    closer, jcloser = closers
    dt, dr = chip_smoke._pose_gaps(res.pose.numpy(), jres.pose)
    assert dt < VERIFY_TOL_M and dr < VERIFY_TOL_M, (dt, dr)
    np.testing.assert_allclose(res.av_depth_residual.numpy(), jres.av_depth_residual, rtol=2e-2)
    np.testing.assert_allclose(res.av_photo_residual.numpy(), jres.av_photo_residual, rtol=2e-2)
    np.testing.assert_array_equal(res.ill_posed.numpy(), jres.ill_posed)
    for ref_photo in (None, 1.0, 30.0):
        for i in range(len(cand)):
            one = TD._result_item(res, i)
            jone = jax.tree_util.tree_map(lambda a: a[i], jres)
            assert closer.gates_ok(one, ref_photo) == jcloser.gates_ok(jone, ref_photo)
    lc = closer.accept(TD._result_item(res, 0), cand[0], QUERY)
    assert (lc.kf_from, lc.kf_to) == (0, QUERY) and lc.rel.shape == (4, 4)
    assert lc.info.shape == (6, 6) and lc.depth_residual == float(res.av_depth_residual[0])


def test_both_rescues(scene, closers, verified):
    """The heading rescue from a plane seed turned by 90 degrees: the split
    form (coarse sweep, fetch, verify) and the fused form agree, and they
    rank the 16 hypotheses and end where the reference's do (in this
    eightfold-symmetric room that need not be the true heading: the gates
    decide, and they are compared too)."""
    from rgbd360_tpu_torch.ops import se3

    m, jm, states, gt = scene
    closer, jcloser = closers
    _, seeds, _, _, pyrs = verified
    q, kf_pyr = states[QUERY].pyramid, pyrs[0]
    aliased = se3.yaw_grid(16)[4] @ seeds[0]
    refined, errs = fetch(closer.rescue_coarse_dispatch(q, kf_pyr, aliased))
    split = fetch(closer.rescue_align_dispatch(q, kf_pyr, refined, errs))
    fused = fetch(closer.rescue_fused_dispatch(q, kf_pyr, aliased))
    assert torch.equal(split.pose, fused.pose)
    jfused = jax.device_get(jcloser.rescue_fused_dispatch(
        _jpyr(q), jcloser.kf_pyramid(jm, 0), aliased))
    jref, jerrs = jax.device_get(jcloser.rescue_coarse_dispatch(
        _jpyr(q), jcloser.kf_pyramid(jm, 0), aliased))
    assert int(np.argmin(errs.numpy())) == int(np.argmin(jerrs))
    np.testing.assert_allclose(errs.numpy(), jerrs, rtol=1e-3)
    dt, dr = chip_smoke._pose_gaps(fused.pose[None].numpy(), jfused.pose[None])
    assert dt < VERIFY_TOL_M and dr < VERIFY_TOL_M, (dt, dr)
    for ref_photo in (None, 5.0):
        assert closer.gates_ok(fused, ref_photo) == jcloser.gates_ok(jfused, ref_photo)


def test_search_end_to_end(scene, closers):
    m, jm, states, gt = scene
    closer, jcloser = closers
    st = states[QUERY]
    got = closer.search(m, st.planes, st.sphere.sphere_gray, st.sphere.sphere_depth, gt[QUERY],
                        QUERY, pyr_cache={}, q_pyr=st.pyramid)
    ref = jcloser.search(jm, _jplanes(st.planes), jnp.asarray(st.sphere.sphere_gray.numpy()),
                         jnp.asarray(st.sphere.sphere_depth.numpy()), jnp.asarray(gt[QUERY]),
                         QUERY, pyr_cache={}, q_pyr=_jpyr(st.pyramid))
    assert [c.kf_from for c in got] == [c.kf_from for c in ref] and len(got) >= 1
    for a, b in zip(got, ref):
        dt, dr = chip_smoke._pose_gaps(a.rel[None], np.asarray(b.rel)[None])
        assert dt < VERIFY_TOL_M and dr < VERIFY_TOL_M, (dt, dr)
        assert a.kf_to == QUERY and a.depth_residual < _cfg().lc.max_depth_residual
    # a map with too few keyframes has no candidates
    few = dataclasses.replace(m, n_kf=torch.tensor(3, dtype=torch.int32))
    assert closer.search(few, st.planes, None, None, gt[2], 2, q_pyr=st.pyramid) == []


def test_relocalizer(scene):
    m, jm, states, gt = scene
    cfg = _cfg()
    reloc, jreloc = Relocalizer(cfg), JRelocalizer(convert.config_to_reference(cfg, jconfig))
    for k in (QUERY, 3):
        got = reloc.relocalize(m, states[k].planes)
        ref = jreloc.relocalize(jm, _jplanes(states[k].planes))
        assert got.success and ref.success
        assert (got.kf, got.n_matches) == (ref.kf, ref.n_matches) == (k, got.n_matches)
        dt, dr = chip_smoke._pose_gaps(got.pose[None], ref.pose[None])
        assert dt < 1e-5 and dr < 1e-5
        np.testing.assert_allclose(got.area_matched, ref.area_matched, rtol=1e-5)
    # keyframes 0 and 1 hold the same planes: never the older of a tie
    tie = reloc.relocalize(m, states[0].planes)
    assert tie.kf == jreloc.relocalize(jm, _jplanes(states[0].planes)).kf and tie.kf != 0
    empty = Map360.empty(cfg.map, cfg.sphere.height, cfg.sphere.width, cfg.seg.max_planes,
                         cfg.seg.hull_dirs, "cpu")
    assert not reloc.relocalize(empty, states[0].planes).success
    sel = Relocalizer._select(torch.tensor([7, 7, 2], dtype=torch.int32),
                              torch.tensor([20.0, 20.0, 20.0]), torch.tensor([True, True, True]),
                              torch.eye(4).repeat(3, 1, 1), torch.eye(6).repeat(3, 1, 1), 5, 10.0)
    assert int(sel[1]) == 1 and sel[4].dtype == torch.int32
