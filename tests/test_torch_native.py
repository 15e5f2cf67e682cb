"""The port's native capture decoder (`rgbd360_tpu_torch/native/loader.cpp`,
`io/native.py`) against the JAX package's reader
(`rgbd360_tpu.io.bin_format.read_rig_frame`): the same bytes for the same
file (tolerance 0), at the rig's full size and at a reduced one, with and
without a timestamp, one file at a time and in a threaded batch; the same
errors on a file that is no archive or is cut short; `io/dataset` decodes
natively by default and with the Python reader under `native=False`, equal;
a failed build raises."""

import numpy as np
import pytest

from rgbd360_tpu.io import bin_format as JBF
from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.io import bin_format as BF, dataset as DS, native


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    out = {}
    for sub, ts in ((1, 0), (4, 123456789)):
        rgb, depth = synthetic.loop_captures(16, sub, frames=[sub])[0]
        p = root / f"sphere_images_{sub}.bin"
        BF.write_rig_frame(p, BF.RawRigFrame(rgb=rgb, depth_mm=depth, timestamp=ts))
        out[sub] = p
    return out


@pytest.mark.parametrize("sub", [1, 4], ids=["8x240x320", "8x60x80"])
def test_native_matches_reference_reader(files, sub):
    got = native.read_rig_frame(files[sub])
    ref = JBF.read_rig_frame(files[sub])
    assert got.rgb.dtype == np.uint8 and got.depth_mm.dtype == np.uint16
    assert got.rgb.shape == np.asarray(ref.rgb).shape
    assert got.rgb.tobytes() == np.asarray(ref.rgb).tobytes()
    assert got.depth_mm.tobytes() == np.asarray(ref.depth_mm).tobytes()
    assert got.timestamp == ref.timestamp


def test_native_batch_matches_reference_reader(files):
    paths = [files[4]] * 3
    for got in native.read_rig_frame_batch(paths, n_threads=2):
        ref = JBF.read_rig_frame(files[4])
        assert got.rgb.tobytes() == np.asarray(ref.rgb).tobytes()
        assert got.depth_mm.tobytes() == np.asarray(ref.depth_mm).tobytes()
        assert got.timestamp == ref.timestamp


def test_native_errors(tmp_path, files):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 64)
    for reader in (native.read_rig_frame, JBF.read_rig_frame):
        with pytest.raises(ValueError, match="archive"):
            reader(bad)
    cut = tmp_path / "cut.bin"
    cut.write_bytes(files[4].read_bytes()[:5000])
    with pytest.raises(ValueError, match="truncated"):
        native.read_rig_frame(cut)
    with pytest.raises(ValueError, match="cannot open"):
        native.read_rig_frame(tmp_path / "absent.bin")


def test_dataset_decodes_natively_by_default(files, tmp_path, monkeypatch):
    root = files[4].parent
    fast, slow = DS.SequenceDataset(root), DS.SequenceDataset(root, native=False)
    assert fast._decode is native.read_rig_frame and slow._decode is BF.read_rig_frame
    for a, b in zip(fast, slow):
        assert a.rgb.tobytes() == b.rgb.tobytes() and a.depth_mm.tobytes() == b.depth_mm.tobytes()
        assert a.timestamp == b.timestamp
    # the live stream decodes every file natively
    live = tmp_path / "live"
    live.mkdir()
    for p in files.values():
        (live / p.name).write_bytes(p.read_bytes())
    (live / "capture_done").touch()
    decoded = []
    monkeypatch.setattr(native, "read_rig_frame",
                        lambda p, _f=native.read_rig_frame: decoded.append(p) or _f(p))
    stream = list(DS.StreamingDataset(live, poll=0.01))
    assert [p.name for p in decoded] == [p.name for p in sorted(files.values())]
    for a, b in zip(stream, slow):
        assert a.rgb.tobytes() == b.rgb.tobytes() and a.depth_mm.tobytes() == b.depth_mm.tobytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native._compile(tmp_path / "never.so")
