"""The port's host I/O (copies of the reference's numpy modules) against
the reference's: the capture format (`io/bin_format.py`), the datasets
(`io/dataset.py`), the PCD writer (`io/pcd.py`, read back by the
reference's reader), the PLY and PNG writers (`utils/viz.py`) and the
point filters (`ops/filters.py`).  Byte formats
must be byte-equal and numpy results equal (tolerance 0: the same
operations on the same inputs)."""

import threading
import time

import numpy as np
import pytest

from rgbd360_tpu.io import bin_format as JBF, pcd as JPCD
from rgbd360_tpu.ops import filters as JF
from rgbd360_tpu.utils import viz as JV
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.core import frame as core_frame
from rgbd360_tpu_torch.io import bin_format as BF, pcd as PCD
from rgbd360_tpu_torch.io.dataset import SequenceDataset, StreamingDataset
from rgbd360_tpu_torch.ops import filters as F
from rgbd360_tpu_torch.utils import viz as V

SUB = 4


@pytest.fixture(scope="module")
def caps():
    return synthetic.loop_captures(16, SUB, frames=range(3))


def _raw(rgb, depth, ts=0):
    return BF.RawRigFrame(rgb=rgb, depth_mm=depth, timestamp=ts)


def test_one_raw_frame_class():
    """`core.frame` re-exports the reader's class: one RawRigFrame."""
    assert core_frame.RawRigFrame is BF.RawRigFrame


@pytest.mark.parametrize("ts", [0, 1000007], ids=["empty-timestamp", "timestamp"])
def test_rig_frame_bytes_equal_reference(tmp_path, caps, ts):
    rgb, depth = caps[0]
    BF.write_rig_frame(tmp_path / "port.bin", _raw(rgb, depth, ts))
    JBF.write_rig_frame(tmp_path / "ref.bin", JBF.RawRigFrame(rgb=rgb, depth_mm=depth, timestamp=ts))
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    back, ref = BF.read_rig_frame(tmp_path / "ref.bin"), JBF.read_rig_frame(tmp_path / "port.bin")
    for got in (back, ref):
        assert np.array_equal(got.rgb, rgb) and np.array_equal(got.depth_mm, depth)
        assert got.timestamp == ts
    assert back.rgb.shape == (8, 240 // SUB, 320 // SUB, 3)  # the header carries cols and rows
    with pytest.raises(ValueError, match="archive"):
        (tmp_path / "bad.bin").write_bytes(b"\0" * 64)
        BF.read_rig_frame(tmp_path / "bad.bin")


def test_sequence_dataset_order_and_prefetch(tmp_path, caps):
    for i, idx in enumerate((10, 2, 7)):  # numeric, not lexical, order
        BF.write_rig_frame(tmp_path / f"sphere_images_{idx}.bin", _raw(*caps[i], ts=idx))
    (tmp_path / "sphere_images_x.bin").write_bytes(b"")  # not a capture name
    for prefetch in (0, 2):
        ds = SequenceDataset(tmp_path, prefetch=prefetch)
        assert ds.indices == [2, 7, 10] and len(ds) == 3
        assert [r.timestamp for r in ds] == [2, 7, 10]
    assert np.array_equal(SequenceDataset(tmp_path)[2].rgb, caps[0][0])


def test_sequence_dataset_error_propagates(tmp_path, caps):
    BF.write_rig_frame(tmp_path / "sphere_images_1.bin", _raw(*caps[0]))
    (tmp_path / "sphere_images_2.bin").write_bytes(b"\0" * 64)
    it = iter(SequenceDataset(tmp_path, prefetch=2))
    next(it)
    with pytest.raises(ValueError):
        next(it)


def test_streaming_dataset_torn_write_and_done(tmp_path, caps):
    """A producer thread writes captures, one of them in two chunks (the
    torn-write settle), then the `capture_done` marker; the stream yields
    every frame in order and ends on the marker (the reference's
    `tests/test_apps.py::test_online_odometry_live_stream`)."""
    d = tmp_path / "live"
    d.mkdir()

    def producer():
        for i, cap in enumerate(caps):
            raw = _raw(*cap, ts=i + 1)
            if i == 1:  # torn write: half the bytes, a pause, then the rest
                BF.write_rig_frame(tmp_path / "staging.bin", raw)
                data = (tmp_path / "staging.bin").read_bytes()
                with open(d / f"sphere_images_{i}.bin", "wb") as f:
                    f.write(data[: len(data) // 2])
                    f.flush()
                    time.sleep(0.4)
                    f.write(data[len(data) // 2:])
            else:
                BF.write_rig_frame(d / f"sphere_images_{i}.bin", raw)
            time.sleep(0.15)
        (d / "capture_done").touch()

    t = threading.Thread(target=producer)
    t.start()
    try:
        ds = StreamingDataset(d, idle_timeout=30)
        got = list(ds)
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert ds.indices == [0, 1, 2] and [r.timestamp for r in got] == [1, 2, 3]
    assert all(np.array_equal(r.depth_mm, c[1]) for r, c in zip(got, caps))


def test_streaming_dataset_idle_timeout(tmp_path):
    t0 = time.monotonic()
    assert list(StreamingDataset(tmp_path, poll=0.01, idle_timeout=0.2)) == []
    assert time.monotonic() - t0 < 5


def _cloud(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[::97] = np.nan
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return pts, cols


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_write_pcd_bytes_equal_reference(tmp_path, binary):
    pts, cols = _cloud()
    n = PCD.write_pcd(tmp_path / "port.pcd", pts, cols, binary=binary)
    assert n == JPCD.write_pcd(tmp_path / "ref.pcd", pts, cols, binary=binary)
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "ref.pcd").read_bytes()
    xyz, rgb = JPCD.read_pcd(tmp_path / "port.pcd")  # the reference's reader
    keep = np.isfinite(pts).all(1)
    np.testing.assert_allclose(xyz, pts[keep], rtol=0 if binary else 1e-5)
    if binary:  # ascii's `%.6g` does not keep the packed colour's bits
        assert np.array_equal(rgb, cols[keep])


def test_ply_writers_bytes_equal_reference(tmp_path):
    pts, cols = _cloud(500, 1)
    valid = np.arange(500) % 3 > 0
    for mod, tag in ((V, "port"), (JV, "ref")):
        assert mod.save_ply(tmp_path / f"{tag}_c.ply", pts, cols, valid) == \
            int((np.isfinite(pts).all(1) & valid).sum())
        mod.save_ply(tmp_path / f"{tag}_p.ply", pts)
        poses = np.tile(np.eye(4), (5, 1, 1))
        poses[:, :3, 3] = pts[:5]
        mod.save_trajectory_ply(tmp_path / f"{tag}_t.ply", poses)
        mod.save_graph_ply(tmp_path / f"{tag}_g.ply", pts[:5], np.array([[0, 1], [1, 4]]),
                           mod.AREA_COLORS[np.arange(5) % len(mod.AREA_COLORS)])
        mod.save_png(tmp_path / f"{tag}.png", cols[:100].reshape(10, 10, 3))
    for name in ("_c.ply", "_p.ply", "_t.ply", "_g.ply", ".png"):
        assert (tmp_path / f"port{name}").read_bytes() == (tmp_path / f"ref{name}").read_bytes()


def test_voxel_downsample_and_passthrough_equal_reference():
    pts, cols = _cloud(5000, 2)
    got, ref = F.voxel_downsample(pts, 0.3, cols), JF.voxel_downsample(pts, 0.3, cols)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert len(got[0]) < len(pts)
    got, ref = F.voxel_downsample(pts, 0.3), JF.voxel_downsample(pts, 0.3)
    assert np.array_equal(got[0], ref[0]) and got[1] is None
    assert np.array_equal(F.passthrough_box(pts[:100]), JF.passthrough_box(pts[:100]))
    empty = F.voxel_downsample(np.full((3, 3), np.nan), 0.1)
    assert empty[0].shape == (0, 3)
