"""The port's top-level entry points (`rgbd360_tpu_torch/entry.py`) against
the JAX package's `__graft_entry__`.

* `entry()` at the reference's own size, 320x1920 (3 levels), on the CPU
  against `data/entry_golden.npz` (the reference's `entry()` forward step,
  `tools/torch_port_golden.py --entry-only`): the inputs are the
  reference's bit for bit, the pose within 1e-4, the Hessian within 1e-3 of
  its norm, the error 1e-3 relative (test_entry_forward_twin's bounds; the
  64x384 twin runs live there) and the same GN iterations per level;
* `dryrun_multichip(2, "gloo", "cpu")`: two spawned ranks run the
  production tracker sharded and single with the reference's dryrun gates
  (track error < 0.06 m, sharded against single < 0.01 m) and every stage
  check; the ranks agree.
"""

from pathlib import Path

import numpy as np
import pytest

from rgbd360_tpu_torch.entry import ENTRY_SHAPE, _box_room_sphere, _synthetic_pair, entry

import __graft_entry__ as GE

GOLDEN = Path(__file__).resolve().parents[1] / "rgbd360_tpu_torch" / "data" / "entry_golden.npz"


def test_inputs_are_the_references():
    for a, b in zip(_synthetic_pair(*ENTRY_SHAPE), GE._synthetic_pair(*ENTRY_SHAPE)):
        np.testing.assert_array_equal(a, np.asarray(b))
    origin = np.array([0.08, 0.0, 0.04])
    for a, b in zip(_box_room_sphere(32, 192, origin), GE._box_room_sphere(32, 192, origin)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_entry_matches_reference_golden():
    g = np.load(GOLDEN)
    fn, args = entry(device="cpu")
    assert args[0].shape == ENTRY_SHAPE and args[4].shape == (4, 4)
    res = fn(*args)
    np.testing.assert_allclose(res.pose.numpy(), g["pose"], atol=1e-4)
    assert np.abs(res.hessian.numpy() - g["hessian"]).max() <= 1e-3 * np.abs(g["hessian"]).max()
    np.testing.assert_allclose(float(res.error), float(g["error"]), rtol=1e-3)
    np.testing.assert_array_equal(res.iters.numpy(), g["iters"])
    assert not bool(res.ill_posed)


def test_entry_needs_a_device_or_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_dryrun_multichip_two_gloo_ranks():
    from rgbd360_tpu_torch.entry import dryrun_multichip

    runs = dryrun_multichip(2, "gloo", "cpu", timeout=300)
    assert len(runs) == 2
    for r in runs:
        p, s = r["production"], r["stages"]
        assert p["track_err"] < 0.06 and p["sharded_vs_single_dev_m"] < 0.01
        assert p["n_kf"] >= 4 and any(n > 0 for n in p["pending_after"])
        assert s["batch"] == 4 and s["plane_matches"] >= 3
        assert np.isfinite([s["total_err"], s["graph_chi2"], s["plane_ba_chi2"]]).all()
        assert r["production"] == runs[0]["production"] and r["stages"] == runs[0]["stages"]
