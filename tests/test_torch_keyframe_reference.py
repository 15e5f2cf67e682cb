"""`KeyframeSLAM` in both packages over the small loop of
`test_torch_keyframe.py` (its fixtures, scene and tolerances: see there),
with synchronous keyframe events: the port's record and the reference's
(`tools/torch_port_golden.keyframe_run_jax`) go through the gates
`chip_smoke.py` runs on the card (`check_keyframe_run`).  The edges'
measured poses are held to 0.03 m / 0.01 rad: measured 1.24e-2 m, 2.8e-3 rad
on the connection edges (degraded dense solves one level down) and 1.84e-2
m, 5.8e-3 rad on the loop closures (the salient verification, which has
several solutions within reach of rounding).  Against the NEAREST of the
reference's solves of each closure from 13 jittered seeds (the smoke's
`check_closure_edges`), 11 of the 12 closures lie within 1.9e-4 m, 3.2e-5
rad, inside the full-size tolerance; closure 2-5 stays 1.84e-2 m from all
of them (53 jitters too): its seeds differ by 1e-5 m between the packages
and the coarsest level takes 1 step here, 4 in the reference, on a solve
whose depth residual, 1.75-1.83, is a degraded one's.  Hence LC_TOL, the
edges' bound, with one straggler allowed beyond the full-size tolerance."""

import sys
from pathlib import Path

import pytest

from rgbd360_tpu_torch import synthetic

from test_torch_segmentation import one_torch_thread  # noqa: F401
from test_torch_keyframe import (  # noqa: F401
    LOOP, N, SMALL_TOL_M, SMALL_TOL_RAD, SUB, _cfg, builder, gt, raws, sync_run,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import chip_smoke  # noqa: E402


LC_JITTERS = 13  # the unjittered seed and +-1e-6, +-1e-5 m along each axis
LC_TOL = (0.03, 0.01)  # m, rad: the edges' bound (see above)
LC_STRAGGLERS = 1


@pytest.fixture(scope="module")
def ref_run(gt):  # noqa: F811
    """The reference's record of the small loop, and its closures verified
    again from jittered seeds (the golden's `lc_verify_*` keys)."""
    import torch_port_golden as tool

    caps = synthetic.loop_captures(LOOP, SUB, frames=range(N))
    calls: list = []
    slam, ref = tool.keyframe_run_jax(
        caps, False, config=_cfg(False), gt=gt,
        hook=lambda slam: tool.record_lc_verifies(slam, calls),
    )
    lc = tool.lc_verify_branches(slam, calls, LC_JITTERS)
    return ref, {k[len("lc_verify_"):]: v for k, v in lc.items()}


def test_loop_run_passes_the_smoke_gates_against_the_reference(sync_run, ref_run):  # noqa: F811
    """Synchronous events in both packages: the smoke's gates."""
    _, got = sync_run
    ref, _ = ref_run
    assert set(ref) <= set(got)
    chip_smoke.check_keyframe_run(got, ref, "small loop", SMALL_TOL_M, SMALL_TOL_RAD, 5e-3,
                                  edge_tol=(0.03, 0.01))
    assert got["keyframe"].all() and int(got["n_loop_closures"]) >= 3
    assert got["connections"].max() >= 3 and got["optimized"].sum() >= 4
    assert int(got["fused_track"]) == N - 1


def test_closure_edges_against_the_references_jittered_solves(sync_run, ref_run):  # noqa: F811
    """Every closure of the reference was solved again from LC_JITTERS
    seeds, through its verification or its heading rescue (the tool raises
    unless branch 0 reproduces the edge bit for bit), and the port's
    closure edges go through the smoke's gate against the nearest of those,
    at LC_TOL."""
    import numpy as np

    _, got = sync_run
    ref, lc = ref_run
    closures = ref["edges"][ref["edges"][:, 2] == 1][:, :2]
    assert sorted(map(tuple, lc["edges"].tolist())) == sorted(map(tuple, closures.tolist()))
    assert lc["branch_poses"].shape == (LC_JITTERS, len(closures), 4, 4)
    assert lc["rescued"].any() and not lc["rescued"].all()  # both solves are exercised
    gaps = chip_smoke.check_closure_edges(got, lc, "small loop", LC_TOL)
    assert len(gaps) == len(closures)
    # all but LC_STRAGGLERS of them at the full-size tolerance
    assert sum(dt > chip_smoke.LC_EDGE_TOL[0] or dr > chip_smoke.LC_EDGE_TOL[1]
               for dt, dr in gaps) <= LC_STRAGGLERS


def test_closure_gate_on_the_golden_file():
    """The smoke's closure gate on the committed golden: any of the
    golden's own jittered solves passes, a pose 5 mm off fails, and so does
    a run that lacks the closure."""
    import numpy as np

    golden = dict(np.load(chip_smoke.KEYFRAME_GOLDEN))
    lc = {k[len("lc_verify_"):]: v for k, v in golden.items() if k.startswith("lc_verify_")}
    assert len(lc["edges"]) == int(golden["loop_sync_n_loop_closures"]) >= 1
    got = {"edges": golden["loop_sync_edges"], "edge_rel": golden["loop_sync_edge_rel"].copy()}
    row = np.flatnonzero(got["edges"][:, 2] == 1)[0]
    np.testing.assert_array_equal(got["edge_rel"][row], lc["branch_poses"][0, 0])
    got["edge_rel"][row] = lc["branch_poses"][-1, 0]
    assert chip_smoke.check_closure_edges(got, lc, "golden")[0][0] == 0.0
    got["edge_rel"][row, 0, 3] += 5e-3
    with pytest.raises(AssertionError, match="leaves the golden's solves"):
        chip_smoke.check_closure_edges(got, lc, "golden")
    got["edges"] = got["edges"][got["edges"][:, 2] == 0]
    with pytest.raises(AssertionError, match="no edge of this run"):
        chip_smoke.check_closure_edges(got, lc, "golden")


def test_reference_record_has_the_smoke_record_keys(sync_run):  # noqa: F811
    """The golden tool's record and the smoke's hold the same keys (the
    smoke adds its timings), so a golden file feeds every gate."""
    import numpy as np

    _, got = sync_run
    golden = dict(np.load(chip_smoke.KEYFRAME_GOLDEN))
    for prefix in ("loop_async", "loop_sync", "kidnap"):
        keys = {k[len(prefix) + 1:] for k in golden if k.startswith(prefix + "_")}
        assert set(got) - {"process_ms"} <= keys, (prefix, sorted(set(got) - keys))
    assert "coarse_frames" in {k[7:] for k in golden if k.startswith("kidnap_")}
    assert {"ring64_poses", "ring64_chi2", "ring256_poses", "ring256_switches"} <= set(golden)
    assert {"lc_verify_edges", "lc_verify_branch_poses", "lc_verify_rescued"} <= set(golden)
