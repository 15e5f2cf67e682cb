"""The benchmark's `pbmap_rig8_qvga` configuration (`PbMapGraphSLAM`, what
`kf_slam --pbmap` runs, its pose graph in float64) through the harness on
the CPU at a small rig (subsample 5: 8x48x64 sensors, a 64x384 sphere, 3
levels), with the harness's look for a card skipped: a sound run is
correct under the cell's limits, a run whose graph solve gives back its
input poses is not where the sample holds a solve that moves, and the
limits file names every number the check computes for this tracker."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from test_torch_segmentation import one_torch_thread  # noqa: E402, F401

CELL = "pbmap.loop24"
FRAMES = 6
# every graph solve of the run drawn, the other kinds as the cell draws
# them: at full size a window's first graph solve moves and the next 15
# mostly do not, and the cell's own draw (4 of the 16) holds a moving one
# on about one seed in four, so this shows what the limit catches once a
# solve that moves is drawn
SAMPLE = {"frames": [2, FRAMES], "solves": [3, FRAMES], "graphs": [FRAMES, FRAMES],
          "registrations": [3, FRAMES - 1]}
LIMITS = json.loads((ROOT / "perfbench" / "limits" / f"{CELL}.json").read_text())


def run():
    return harness.run_cell(CELL, 2**31 + 11, 0.0, False, time.perf_counter(), device="cpu",
                            subsample=5, max_frames=FRAMES,
                            traffic_overrides={"warmup_laps": 0, "noise_laps": 1,
                                               "sample": SAMPLE})


def test_config_states_the_float64_graph_solve():
    cell = next(w for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]
                if w["name"] == CELL)
    cfg = harness.framework_config(harness.load_json(
        ROOT / "perfbench" / "configs" / f"{cell['config']}.json"))
    assert cfg.graph.dtype == "float64"
    kf = harness.framework_config(harness.load_json(
        ROOT / "perfbench" / "configs" / "kfslam_rig8_qvga.json"))
    assert kf.graph.dtype == "float32"
    # the rest of the deployment is the keyframe cell's
    assert cfg.replace(graph=kf.graph) == kf


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == FRAMES
    assert out["work"]["loop_closures"] > 0
    assert set(out["checks"]) == set(LIMITS) | {"failed_frames"}
    for name in LIMITS:
        assert out["checks"][name]["value"] is not None, name


def test_unchanged_graph_solve_is_not_correct(monkeypatch):
    """A step that returns its state unchanged: the pose-graph solve gives
    back its input poses."""
    from rgbd360_tpu_torch.slam import graph

    def lm(g, max_iters, lm_lambda0, lm_step, chi2_of, step_of):
        return g.poses.clone(), chi2_of(g.poses), 0

    monkeypatch.setattr(graph, "_lm_loop", lm)
    out = run()
    assert not out["correct"], out["checks"]
    c = out["checks"]["graph_cost_excess"]
    assert c["value"] > c["limit"], out["checks"]


def _numbers_the_check_writes() -> set:
    sys.path.insert(0, str(ROOT / "perfbench" / "tests"))
    from test_perfbench_manifest import _numbers_the_check_writes as names

    return names()


@pytest.mark.parametrize("number", sorted(LIMITS))
def test_limits_cover_the_tracker_and_are_no_looser(number):
    """Every number the check computes for the PbMap tracker (it makes no
    single-pair dense solve, so no `track_*` number) has a limit, none
    looser than the keyframe cell's."""
    kf = json.loads((ROOT / "perfbench" / "limits" / "kfslam.loop24.json").read_text())
    wanted = {n for n in _numbers_the_check_writes() if not n.startswith("track_")}
    assert set(LIMITS) == wanted
    assert 0 < LIMITS[number] <= kf[number]
