"""The port's registration apps (`apps/register_pair.py`,
`apps/benchmark_registration.py`, `apps/register_sequence.py`) against the
reference's own `main` on the same capture files, at a small size:
`synthetic.config(4, 3)`, a calibration directory of the
construction-spec extrinsics (`--no-intrinsics`) and the walk's 6
captures, written by `synthetic.write_app_inputs`.

In the eightfold-symmetric octagon room a PbMap registration of the
walk's wall matches chooses between the room's aliases (rotations and
mirror images), whose votes tie up to the planes' rounding, and the two
packages may choose different ones (at this size the port's four largest
first-step votes on the pair (0, 2) are equal, 1402.9333, and the
reference's two best 1405.0696 and 1405.0597).  So PbMap is held on
success and matches, and `register_pair` and `register_sequence` run with
the reference's PbMap results in place of their own
(`chip_smoke.recorded_registration(seeds)`), so that what a PbMap pose
seeds (GICP, the dense solves, the sequence's graph) is held every time;
every dense solve of the reference is also solved again by the port from
the reference's own seed (`chip_smoke.resolve_registration`).

Tolerances (the smoke's): PbMap success and matches equal; ICP and
GICP poses within 5e-4 m / 2e-4 rad (a fixed iteration count: only the
sums' order and the warp's rounding separate the packages); each
re-solved dense solve within 5e-4 m / 2e-4 rad of the reference's, the
apps' own within 2e-3 m / 2e-4 rad (their stitch maps differ from the
reference's on the sensor-tie columns); `register_sequence`'s edges, edge
mask and padding equal, its information matrices within SEQ_INFO_RTOL
relative, its chi2 within 5e-3 relative, its chained initial poses
within 0.02 m / 0.01 rad, its trajectory within 5e-3 m / 1e-3 rad of the
reference's graph solved with the branches its edges matched and the
port's information matrices, its areas the same partition; the
solver on the reference's graph within 1e-3 relative in chi2 and 5e-4 m /
2e-4 rad in its poses.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbd360_tpu_torch import synthetic
from rgbd360_tpu_torch.apps import benchmark_registration, register_pair, register_sequence
from rgbd360_tpu_torch.io.bin_format import read_rig_frame
from rgbd360_tpu_torch.io.dataset import SequenceDataset

from test_torch_apps import port_builder
from test_torch_segmentation import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import chip_smoke  # noqa: E402

SUB, LEVELS = 4, 3


def _walk(paths) -> list:
    return sorted(paths["walk"].glob("sphere_images_*.bin"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))


def _gate(check, *args, **kw):
    """The smoke's `gate`, raising at once."""
    return check(*args, **kw)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return synthetic.write_app_inputs(tmp_path_factory.mktemp("reg"), SUB, loop_frames=0)


@pytest.fixture(scope="module")
def builder(paths):
    return port_builder(paths, synthetic.config(SUB, LEVELS))


@pytest.fixture(scope="module")
def golden(paths):
    import torch_port_golden as G

    return G.registration_jax(paths, SUB, LEVELS, n_jitters=1)


@pytest.mark.parametrize("bilinear", [False, True])
def test_register_pair_app_matches_reference(paths, builder, golden, bilinear, tmp_path):
    walk = _walk(paths)
    raws = [read_rig_frame(walk[i]) for i in chip_smoke.REG_PAIR]
    tag = "pair_bilinear" if bilinear else "pair"
    seeds = chip_smoke.golden_seeds(golden, f"{tag}_pbmap", f"{tag}_pb_success")
    with chip_smoke.recorded_registration(seeds) as log:
        rec = register_pair.run(builder, *raws, dense=True, bilinear=bilinear,
                                out=None if bilinear else tmp_path)
    chip_smoke.check_register_pair(rec, log, golden, tag, f"register_pair ({tag})", _gate)
    if not bilinear:
        chip_smoke.check_app_files(tmp_path, chip_smoke.PAIR_OUT_FILES, "register_pair")


def test_benchmark_registration_app_matches_reference(paths, builder, golden):
    walk = _walk(paths)
    raws = [read_rig_frame(walk[i]) for i in chip_smoke.REG_BENCH_PAIR]
    with chip_smoke.recorded_registration() as log:
        results = benchmark_registration.run(builder, *raws, repeats=1)
    assert list(results) == ["pbmap", *chip_smoke.BENCH_DENSE[:4], *chip_smoke.BENCH_ICP,
                             "rig_joint"]
    assert all(np.isfinite(r[1]) and r[1] > 0 for r in results.values())
    chip_smoke.check_benchmark(results, log, golden, "benchmark_registration", _gate)


def test_register_sequence_app_matches_reference(paths, builder, golden, tmp_path):
    seeds = chip_smoke.golden_seeds(golden, "seq_pb_poses", "seq_pb_success")
    with chip_smoke.recorded_registration(seeds) as log, chip_smoke.recorded_graph() as graph:
        traj, labels = register_sequence.run(SequenceDataset(paths["walk"]), builder,
                                             window=chip_smoke.REG_WINDOW, out=tmp_path)
    assert traj.shape == (len(_walk(paths)), 4, 4)
    chip_smoke.check_register_sequence(traj, labels, log, graph, golden, "register_sequence",
                                       _gate, "cpu")
    chip_smoke.check_app_files(tmp_path, chip_smoke.SEQ_OUT_FILES, "register_sequence")
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "areas.txt", dtype=int), labels)


def test_golden_solves_resolved_match_reference(paths, builder, golden):
    """Every dense solve of the reference's apps (register_pair's two, the
    benchmark's five, the sequence's edges) solved again by the port from
    the reference's own seed on the same captures."""
    raws = [read_rig_frame(p) for p in _walk(paths)]
    got = chip_smoke.resolve_registration(builder, raws, golden)
    chip_smoke.check_resolved(got, golden, "re-solved", _gate)


def test_register_sequence_sharded_raises(paths, builder, golden, tmp_path):
    """`--sharded` is ported (`parallel.sharded.distributed_pose_graph`) and
    no longer raises.  Seeded with the golden's PbMap results, the graph
    solved edge-sharded in a world of one and on 2 gloo ranks (spawned, each
    under a timeout) gives the unsharded run's trajectory to 1e-5 m (the
    same normal equations; on 2 ranks summed in two parts) and its areas;
    and `main --sharded --device cpu`, a user's single-process call, runs
    and writes its files (with the test's small builder)."""
    from _torch_ranks import register_sequence_rank
    from rgbd360_tpu_torch.parallel.sharded import make_mesh
    from rgbd360_tpu_torch.parallel.spawn import run_ranks

    seeds = chip_smoke.golden_seeds(golden, "seq_pb_poses", "seq_pb_success")
    runs = {}
    for name, mesh in (("unsharded", None), ("world of one", make_mesh())):
        with chip_smoke.recorded_registration(seeds):
            runs[name] = register_sequence.run(SequenceDataset(paths["walk"]), builder,
                                               window=chip_smoke.REG_WINDOW, mesh=mesh)
    maps = {k: v for k, v in builder.state_dict().items()
            if k in ("sensor", "u", "v", "scale", "valid") or k.startswith("seam_")}
    ranks = run_ranks(register_sequence_rank, 2, "gloo", "cpu", timeout=300, threads=1,
                      args=(str(paths["walk"]), str(paths["calib"]), SUB, LEVELS, maps, seeds,
                            chip_smoke.REG_WINDOW))
    ref_traj, ref_labels = runs["unsharded"]
    for name, (traj, labels) in [*runs.items(), *((f"rank {r}", (o["traj"], o["labels"]))
                                                  for r, o in enumerate(ranks))]:
        assert np.abs(traj - ref_traj).max() <= 1e-5, (name, np.abs(traj - ref_traj).max())
        np.testing.assert_array_equal(labels, ref_labels, err_msg=name)
    argv = [str(paths["walk"]), "--calib", str(paths["calib"]), "--no-intrinsics",
            "--sharded", "--device", "cpu", "--out", str(tmp_path)]
    traj, _ = register_sequence.main(argv, builder=builder)
    assert traj.shape == ref_traj.shape and np.isfinite(traj).all()
    chip_smoke.check_app_files(tmp_path, chip_smoke.SEQ_OUT_FILES, "register_sequence --sharded")


def test_registration_apps_need_a_device_or_the_card(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the apps' default device is the card")
    walk = [str(p) for p in _walk(paths)[:2]]
    calib = ["--calib", str(paths["calib"]), "--no-intrinsics"]
    for app, argv in ((register_pair, walk), (benchmark_registration, walk),
                      (register_sequence, [str(paths["walk"])])):
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(argv + calib)
