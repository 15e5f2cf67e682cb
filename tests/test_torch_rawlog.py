"""The port's rawlog, PbMap and stereo I/O (`io/rawlog.py`, `io/pbmap.py`,
`io/stereo.py`, copies of the reference's) against the reference's
modules: each package reads what the other writes, both write the same
bytes, and the reference's own test cases (`tests/test_rawlog.py`,
`tests/test_pbmap.py`, `tests/test_extras.py::TestStereoIO`) run against
the port on synthetic captures.  Tolerances: the codecs are exact
(bit-equal) except a color image, which rides as JPEG (OpenCV, lossy: the
reference's bound, mean error under 4 of 255)."""

import gzip
import io
import struct

import numpy as np
import pytest
import torch

from rgbd360_tpu.io import pbmap as JP
from rgbd360_tpu.io import rawlog as JR
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.io import pbmap as P
from rgbd360_tpu_torch.io import rawlog as R
from rgbd360_tpu_torch.io import stereo as S
from rgbd360_tpu_torch.io.bin_format import RawRigFrame

from test_torch_segmentation import one_torch_thread  # noqa: F401


def _smooth_rgb(rng, shape):
    """A smooth structured image (JPEG round-trips these closely)."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    p = rng.uniform(0.02, 0.2, 6)
    img = np.stack([127 + 120 * np.sin(p[2 * i] * xx + p[2 * i + 1] * yy + i)
                    for i in range(3)], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _obs(mod, rng, label, ts, shape=(24, 32), color=True):
    rt = np.eye(4)
    a, b = rng.uniform(-np.pi, np.pi, 2)
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    rt[:3, :3] = (np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
                  @ np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]]))
    rt[:3, 3] = rng.uniform(-1, 1, 3)
    img = _smooth_rgb(rng, shape)
    return mod.Obs3DRangeScan(sensor_label=label, timestamp=ts, sensor_pose=rt,
                              range_image=rng.uniform(0.3, 9.0, shape).astype(np.float32),
                              intensity_image=img if color else img[..., 1])


def _stream(mod, seed=0, color=True):
    rng = np.random.default_rng(seed)
    t0 = mod.unix_to_mrpt_timestamp(1.4e9)
    obs = [_obs(mod, rng, f"RGBD{i + 1}", t0 + i, color=color) for i in range(3)]
    obs.append(mod.Obs2DRangeScan(sensor_label="LASER", timestamp=t0,
                                  ranges=rng.uniform(0, 50, 181).astype(np.float32),
                                  validity=(rng.uniform(size=181) > 0.1).astype(np.uint8)))
    return obs


@pytest.mark.parametrize("color", [True, False])
def test_same_bytes_as_reference(tmp_path, color):
    """Both packages write the same uncompressed stream for the same
    observations (JPEG encoding included), and each reads the other's."""
    R.write_rawlog(tmp_path / "port.rawlog", _stream(R, color=color), compress=False)
    JR.write_rawlog(tmp_path / "ref.rawlog", _stream(JR, color=color), compress=False)
    assert (tmp_path / "port.rawlog").read_bytes() == (tmp_path / "ref.rawlog").read_bytes()
    for a, b in zip(R.read_rawlog(tmp_path / "ref.rawlog"), JR.read_rawlog(tmp_path / "port.rawlog")):
        assert type(a).__name__ == type(b).__name__ and a.sensor_label == b.sensor_label
        for f in ("range_image", "intensity_image", "sensor_pose", "ranges", "validity"):
            if getattr(a, f, None) is not None:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("compress", [True, False])
def test_roundtrip(tmp_path, compress):
    """The reference's `test_roundtrip` against the port's codec."""
    obs = _stream(R)
    path = tmp_path / "log.rawlog"
    R.write_rawlog(path, obs, compress=compress)
    assert (path.read_bytes()[:2] == b"\x1f\x8b") == compress
    back = list(R.read_rawlog(path))
    assert len(back) == 4
    for a, b in zip(obs[:3], back[:3]):
        assert b.sensor_label == a.sensor_label and b.timestamp == a.timestamp
        np.testing.assert_allclose(b.sensor_pose, a.sensor_pose, atol=1e-12)
        np.testing.assert_array_equal(b.range_image, a.range_image)
        err = np.abs(b.intensity_image.astype(np.int32) - a.intensity_image.astype(np.int32))
        assert err.mean() < 4.0, err.mean()
    np.testing.assert_array_equal(back[3].ranges, obs[3].ranges)
    np.testing.assert_array_equal(back[3].validity, obs[3].validity)


def test_timestamp_conversion():
    t = 1.7e9 + 0.1234567
    assert abs(R.mrpt_to_unix_timestamp(R.unix_to_mrpt_timestamp(t)) - t) < 1e-6
    assert R.unix_to_mrpt_timestamp(t) == JR.unix_to_mrpt_timestamp(t)


@pytest.mark.parametrize("gray", [False, True])
def test_rig_frame_roundtrip(tmp_path, gray):
    """A synthetic rig capture -> rawlog -> assembled rig frame: depth
    exact; color through JPEG (mean error < 3), gray exact and replicated
    to the three channels; the same frames as the reference assembles."""
    rgb, dmm = synthetic.captures(1, 4)[0]
    raw = RawRigFrame(rgb=rgb, depth_mm=dmm, timestamp=0)
    obs = R.rig_frame_to_observations(raw, timestamp=R.unix_to_mrpt_timestamp(1e9))
    if gray:
        for o in obs:
            o.intensity_image = o.intensity_image[..., 1].copy()
    R.write_rawlog(tmp_path / "rig.rawlog", obs)
    frames = list(R.assemble_rig_frames(R.read_rawlog(tmp_path / "rig.rawlog"), num_sensors=8))
    ref = list(JR.assemble_rig_frames(JR.read_rawlog(tmp_path / "rig.rawlog"), num_sensors=8))
    assert len(frames) == len(ref) == 1
    np.testing.assert_array_equal(frames[0].depth_mm, dmm)
    np.testing.assert_array_equal(frames[0].rgb, ref[0].rgb)
    if gray:
        np.testing.assert_array_equal(frames[0].rgb, np.repeat(rgb[..., 1:2], 3, axis=-1))
    else:
        assert np.abs(frames[0].rgb.astype(np.int32) - rgb.astype(np.int32)).mean() < 3.0


def test_four_camera_tiling():
    rng = np.random.default_rng(1)
    t0 = R.unix_to_mrpt_timestamp(1e9)
    obs = [_obs(R, rng, f"RGBD{i + 1}", t0 + i) for i in range(4)]
    obs += [_obs(R, rng, f"RGBD{i + 1}", t0 + 500000 + i) for i in range(4)]
    frames = list(R.assemble_rig_frames(obs, num_sensors=8))
    assert len(frames) == 2 and frames[0].rgb.shape == (8, 24, 32, 3)
    for slot in range(8):
        np.testing.assert_array_equal(frames[0].rgb[slot],
                                      obs[R.DEFAULT_ARRANGEMENT[slot % 4]].intensity_image)


def test_sync_window_drops_mixed_frames():
    rng = np.random.default_rng(2)
    t0 = R.unix_to_mrpt_timestamp(1e9)
    second = R.unix_to_mrpt_timestamp(1e9 + 1.0)
    obs = [_obs(R, rng, "RGBD1", t0), _obs(R, rng, "RGBD2", t0 + 1),
           _obs(R, rng, "RGBD1", second), _obs(R, rng, "RGBD2", second + 1)]
    assert len(list(R.assemble_rig_frames(obs, num_cameras=2, num_sensors=2))) == 2
    mixed = [obs[0], _obs(R, rng, "RGBD2", second)]
    assert not list(R.assemble_rig_frames(mixed, num_cameras=2, num_sensors=2))


def test_unsupported_version_raises(tmp_path):
    name = b"CObservation3DRangeScan"
    with gzip.open(tmp_path / "bad.rawlog", "wb") as f:
        f.write(bytes([0x80 | len(name)]) + name + bytes([42]))
    with pytest.raises(R.UnsupportedVersionError, match="version 42"):
        list(R.read_rawlog(tmp_path / "bad.rawlog"))


def test_mrpt_wire_layout_golden():
    """A gray CImage v7 hand-assembled as `CImage::writeToStream` lays it
    out parses, and the writer's stream reads back."""
    img = np.arange(36, dtype=np.uint8).reshape(6, 6)
    name = b"CImage"
    payload = (b"\x00\x00" + struct.pack("<iiiI", 6, 6, 0, 48) + b"\x00"
               + b"".join(bytes(row) + b"\x00\x00" for row in img))
    wire = bytes([0x80 | len(name)]) + name + bytes([7]) + payload + b"\x88"
    np.testing.assert_array_equal(R._read_object(R._Reader(io.BytesIO(wire)))[1], img)
    buf = io.BytesIO()
    R._write_object(R._Writer(buf), "CImage", img)
    assert buf.getvalue() == wire


def _frame(name: bytes, version: int, payload: bytes) -> bytes:
    return bytes([0x80 | len(name)]) + name + bytes([version & 0xFF]) + payload + b"\x88"


def test_cpose3d_legacy_versions():
    rt = np.eye(4)
    rt[:3, 3] = [1.5, -2.0, 0.25]
    m32 = _frame(b"CMatrix", 0, struct.pack("<II", 4, 4) + rt.astype("<f4").tobytes())
    m64 = _frame(b"CMatrixD", 0, struct.pack("<II", 4, 4) + rt.astype("<f8").tobytes())
    for ver, nested in ((0, m32), (1, m64)):
        got = R._read_object(R._Reader(io.BytesIO(_frame(b"CPose3D", ver, nested))))[1]
        np.testing.assert_allclose(got, rt, atol=1e-6)


def test_sensory_frame_and_actions(tmp_path):
    """Format-#1 rawlogs: CSensoryFrame containers flatten, unknown action
    objects are skipped by resynchronizing."""
    rng = np.random.default_rng(5)
    obs = [_obs(R, rng, f"RGBD{i + 1}", 2000 + i) for i in range(2)]
    inner = io.BytesIO()
    for o in obs:
        R._write_object(R._Writer(inner), "CObservation3DRangeScan", o)
    sf = _frame(b"CSensoryFrame", 2, struct.pack("<I", 2) + inner.getvalue())
    junk = bytes(rng.integers(0, 256, 257, dtype=np.uint8))
    (tmp_path / "f1.rawlog").write_bytes(_frame(b"CActionCollection", 0, junk) + sf
                                         + _frame(b"CActionRobotMovement2D", 1, junk[::-1]))
    back = list(R.read_rawlog(tmp_path / "f1.rawlog"))
    assert [o.sensor_label for o in back] == ["RGBD1", "RGBD2"]
    np.testing.assert_array_equal(back[0].range_image, obs[0].range_image)
    (tmp_path / "junk.rawlog").write_bytes(_frame(b"CActionCollection", 0, b"\x01\x02\x03" * 11))
    assert list(R.read_rawlog(tmp_path / "junk.rawlog")) == []


def test_tcamera_roundtrip():
    cam = R.TCamera(intrinsics=np.array([[520.0, 0, 319.5], [0, 521.0, 239.5], [0, 0, 1]]),
                    dist=np.array([0.1, -0.2, 0.001, 0.002, 0.05]),
                    focal_length_meters=0.0021, nrows=480, ncols=640)
    buf = io.BytesIO()
    R._write_object(R._Writer(buf), "TCamera", cam)
    buf.seek(0)
    got = R._read_object(R._Reader(buf))[1]
    np.testing.assert_array_equal(got.intrinsics, cam.intrinsics)
    np.testing.assert_array_equal(got.dist, cam.dist)
    assert (got.nrows, got.ncols, got.focal_length_meters) == (480, 640, 0.0021)


def test_empty_cimage_rewrite():
    buf = io.BytesIO()
    R._write_object(R._Writer(buf), "CImage", np.zeros((0, 0, 3), np.uint8))
    buf.seek(0)
    assert R._read_object(R._Reader(buf))[1].shape == (0, 0, 3)


def test_adversarial_streams(tmp_path):
    """Truncation, external storage and unsupported versions fail loudly."""
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    R._write_object(R._Writer(buf), "CObservation3DRangeScan", _obs(R, rng, "RGBD1", 5))
    wire = buf.getvalue()
    for cut in (len(wire) // 4, len(wire) // 2, len(wire) - 1):
        (tmp_path / f"c{cut}.rawlog").write_bytes(wire[:cut])
        with pytest.raises(R.RawlogError):
            list(R.read_rawlog(tmp_path / f"c{cut}.rawlog"))
    ext = _frame(b"CImage", 7, b"\x01" + struct.pack("<I", 8) + b"img_0001")
    with pytest.raises(R.RawlogError, match="external storage"):
        R._read_object(R._Reader(io.BytesIO(ext)))
    for cls, supported in R._SUPPORTED_VERSIONS.items():
        assert supported == JR._SUPPORTED_VERSIONS[cls]
        name = cls.encode()
        for ver in (-3, 34, 127):
            if ver not in supported:
                with pytest.raises(R.UnsupportedVersionError):
                    R._read_object(R._Reader(io.BytesIO(
                        bytes([0x80 | len(name)]) + name + struct.pack("<b", ver))))


def test_color_needs_opencv(monkeypatch):
    """A color CImage needs `cv2` (JPEG) and its ImportError is not caught;
    a gray one needs no codec."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2 here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="no cv2"):
        R._write_object(R._Writer(io.BytesIO()), "CImage", np.zeros((4, 4, 3), np.uint8))
    R._write_object(R._Writer(io.BytesIO()), "CImage", np.zeros((4, 4), np.uint8))


# ------------------------------------------------------------------ PbMap

def _pbplanes(mod, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        nrm = rng.normal(size=3).astype(np.float32)
        nrm /= np.linalg.norm(nrm)
        out.append(mod.PbPlane(num_observations=10 + k, area_voxels=1.5, area_hull=2.0 + k,
                               elongation=1.2, normal=nrm,
                               center=rng.uniform(-2, 2, 3).astype(np.float32),
                               hist_h=rng.uniform(0, 1, 37).astype(np.float32),
                               inliers=np.arange(5, dtype=np.int32), label=f"p{k}",
                               polygon=rng.uniform(-1, 1, (6, 3)).astype(np.float32)))
    return out


@pytest.mark.parametrize("compress", [True, False])
def test_pbmap_roundtrip_and_bytes(tmp_path, compress):
    """Both packages write the same .pbmap and read each other's."""
    P.write_pbmap(tmp_path / "p.pbmap", _pbplanes(P), compress=False)
    JP.write_pbmap(tmp_path / "r.pbmap", _pbplanes(JP), compress=False)
    assert (tmp_path / "p.pbmap").read_bytes() == (tmp_path / "r.pbmap").read_bytes()
    P.write_pbmap(tmp_path / "c.pbmap", _pbplanes(P), compress=compress)
    for a, b in zip(_pbplanes(P), JP.read_pbmap(tmp_path / "c.pbmap")):
        for f in ("normal", "center", "hist_h", "inliers", "polygon"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.label, a.num_observations) == (b.label, b.num_observations)


def test_pbmap_layout_mismatch_is_loud(tmp_path):
    P.write_pbmap(tmp_path / "p.pbmap", _pbplanes(P, 1), compress=False)
    raw = bytearray((tmp_path / "p.pbmap").read_bytes())
    raw[-2] ^= 0xFF  # the Plane's end flag
    (tmp_path / "bad.pbmap").write_bytes(bytes(raw))
    with pytest.raises(R.RawlogError):
        P.read_pbmap(tmp_path / "bad.pbmap")
    name = b"PbMap"
    (tmp_path / "v.pbmap").write_bytes(bytes([0x80 | len(name)]) + name + bytes([9]))
    with pytest.raises(R.UnsupportedVersionError):
        P.read_pbmap(tmp_path / "v.pbmap")


def test_planeset_bridge(tmp_path):
    """A built frame's plane set -> .pbmap -> the port's PlaneSet of tensors:
    the same records and the same padded set as the reference's bridge."""
    from rgbd360_tpu_torch.core.frame import FrameBuilder, RigFrame

    cfg = synthetic.config(4, 3)
    b = FrameBuilder(synthetic.calibration(cfg.rig), cfg, device="cpu")
    rgb, dmm = synthetic.captures(1, 4)[0]
    ps = b.segment_planes(b.build(RigFrame(torch.from_numpy(rgb), torch.from_numpy(dmm))))
    recs = P.planeset_to_pbplanes(ps)
    assert len(recs) == int(ps.valid.sum()) > 0
    np_ps = ps.map(lambda _, a: a.numpy())
    ref_recs = JP.planeset_to_pbplanes(np_ps)
    for a, r in zip(recs, ref_recs):
        for f in ("normal", "center", "ppal_dir", "hist_h", "polygon"):
            np.testing.assert_array_equal(getattr(a, f), getattr(r, f))
    P.write_pbmap(tmp_path / "f.pbmap", recs)
    back = P.pbplanes_to_planeset(P.read_pbmap(tmp_path / "f.pbmap"), device="cpu")
    ref = JP.pbplanes_to_planeset(JP.read_pbmap(tmp_path / "f.pbmap"))
    for f in ("normal", "center", "d", "area", "n_inliers", "hull", "hue_hist", "valid"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert back.normal.device.type == "cpu"


# ------------------------------------------------------------------ stereo

def test_stereo_depth_roundtrip_and_bytes(tmp_path):
    from rgbd360_tpu.io.stereo import write_stereo_depth as j_write

    d = np.random.default_rng(0).uniform(0.5, 8.0, (64, 384)).astype(np.float32)
    S.write_stereo_depth(tmp_path / "d.bin", d)
    j_write(tmp_path / "r.bin", d)
    assert (tmp_path / "d.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    np.testing.assert_array_equal(S.read_stereo_depth(tmp_path / "d.bin"), d)


def test_stereo_frame_with_png(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    d = rng.uniform(1, 5, (64, 128)).astype(np.float32)
    S.write_stereo_depth(tmp_path / "d.bin", d)
    img = rng.integers(0, 255, (64, 128, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "rgb.png")
    f = S.read_stereo_frame(tmp_path / "d.bin", tmp_path / "rgb.png")
    np.testing.assert_array_equal(f.rgb[..., ::-1], img)  # BGR storage
    assert S.read_stereo_frame(tmp_path / "d.bin").rgb is None


def test_stereo_truncated_raises(tmp_path):
    (tmp_path / "bad.bin").write_bytes(b"\x10\x00\x10\x00abc")
    with pytest.raises(ValueError):
        S.read_stereo_depth(tmp_path / "bad.bin")


def test_stereo_into_slam_path(tmp_path):
    """A depth-only stereo sphere read back flows into the sphere-input
    tracking state (`make_state_from_sphere`): the plane set is the
    reference's `segment_planes_from_sphere` of the same depth, and two
    such states of the walk align to its 0.1 m step (phase m's gate)."""
    import sys
    from pathlib import Path

    import jax.numpy as jnp

    from rgbd360_tpu_torch.core.frame import FrameBuilder

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root)]
    import chip_smoke
    from _reference import reference_builder

    cfg = synthetic.config(4, 3)
    b = FrameBuilder(chip_smoke.extras_calibration(cfg), cfg, device="cpu")
    raws = [RawRigFrame(rgb=r, depth_mm=d, timestamp=0) for r, d in synthetic.captures(2, 4)]
    got = chip_smoke.run_stereo(b, raws, tmp_path)
    chip_smoke.check_stereo(got, "stereo", launches=False)  # no kernel on the CPU
    depth = S.read_stereo_depth(tmp_path / "stereo_0.bin")
    # every 2nd pixel (the tracker's default 4 leaves too few at this size)
    ref = reference_builder(cfg).segment_planes_from_sphere(jnp.asarray(depth), downsample=2)
    port = b.segment_planes_from_sphere(torch.from_numpy(depth), downsample=2)
    assert int(port.valid.sum()) == int(np.asarray(ref.valid).sum()) > 0
    # each port plane against the reference plane of the nearest centre
    # (slots of near-equal size may come in another order): phase g's
    # plane tolerances
    pv, rv = port.valid.numpy(), np.asarray(ref.valid)
    pc, rc = port.center.numpy()[pv], np.asarray(ref.center)[rv]
    near = np.argmin(np.linalg.norm(pc[:, None] - rc[None], axis=-1), axis=1)
    assert np.linalg.norm(pc - rc[near], axis=-1).max() < chip_smoke.PLANE_TOL_M
    cos = np.sum(port.normal.numpy()[pv] * np.asarray(ref.normal)[rv][near], axis=-1)
    assert np.arccos(np.clip(cos, -1, 1)).max() < chip_smoke.PLANE_TOL_RAD
