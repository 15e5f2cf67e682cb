"""What decides `correct`: the program's answers recorded in the window,
and their comparison with the plain reference (`perfbench.reference`)
once the window has closed.

`Recorder` wraps, for the window only, the calls whose results are the
answers: the frame build (`FrameBuilder.build_full`: the sphere and the
pyramid), the tracker's dense solve (`DenseAligner.align` of its
`aligner`), its plane registration (`PlaneRegistration.register` of its
`plane_reg`) and the pose-graph solves of the tracker's module
(`GRAPH_SOLVERS`).  Which calls of each kind it keeps is drawn from the
run's seed before the window opens: k of the first n calls, n a count
that every window of every cell reaches (the traffic's `sample`; a kind
the sample leaves out is drawn as none).  A call that is not drawn goes
straight to the program.  A drawn one keeps references to the program's
own output tensors; a drawn graph solve's input graph and a drawn
registration's two plane sets are cloned on the device, since the map is
updated in place.

The numbers compared (each the largest over the sample):

- `sphere_share`: the share of sphere pixels whose gray or depth differs
  from the reference's by more than 1e-5, where the reference's rounding
  does not decide the gather (`Rig.ambiguous`).
- `pyramid_share`: the share of pyramid values (6 channels, every level)
  that differ by more than 1e-5 + 1e-5 |reference| from the reference's
  pyramid of the program's sphere, outside the columns an ownership tie
  decides the seam mask of.
- `track_pose_gap_m`, `track_pose_gap_rad`: the translation and rotation
  between the pose a dense solve returned and the reference's solve from
  the same init pose over the program's pyramids of the two frames.
- `track_hessian_gap`: |H - H_ref|_F / |H_ref|_F of a dense solve's normal
  matrix at the pose it returned, the reference's from the same pyramids.
- `track_residual_gap`: the largest relative gap of the solve's mean
  photometric residual, mean depth residual and visible share.
- `graph_cost_excess`: how much higher the robust cost of the poses a
  graph solve returned is than that of the reference solve's from the same
  input graph, as a share of the input's cost (0 where it is not higher).
  The cost and not the positions: where closures alias, a graph's minimum
  is flat along some directions, and along them the solves' positions
  move by rounding.  The reference solves in float64.
- `plane_match_gap`: the program's match set replayed pick by pick
  through the reference's greedy (the program's earlier picks as the
  prefix): at each step, how far the program's pick's vote falls short of
  the reference's best live vote, as a share of it.  It reads 1 where the
  pick is not live under the reference's gates, where the program stops
  while the reference still has a positive vote, or where it picks and the
  reference has none.  A tie broken the other way reads about 1e-7.
- `plane_pose_gap_m`, `plane_pose_gap_rad`: the translation and rotation
  between the pose the registration returned and the reference's pose from
  the program's own pairs; infinite where their `success` differs.
- `plane_info_gap`: |I - I_ref|_F / |I_ref|_F of the information matrix
  from those pairs (0 where both are 0).

The control (`numbers(..., control=True)`) puts the reference in the
program's place, computed one step below the configuration's float32 with
TF32 off, and computes the same numbers: with TF32 matrix products where
the reference's work is long matrix products (the pyramid's blur and box
sums, J^T J), in bfloat16 where it is other float32 arithmetic (the
stitch and undistortion, the warp and residuals of the solve, the graph
solve); for the plane registration, the votes, the pose and its
information in bfloat16 (the decompositions in float32 of bfloat16
values), its gates in float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import math
import zlib

import numpy as np
import torch

from perfbench import reference as R

TOL = 1e-5

# the pose-graph solvers each tracker's module calls, by the names it
# calls them under
GRAPH_SOLVERS = {
    "rgbd360_tpu_torch.slam.odometry": ("optimize_pose_graph", "optimize_pose_graph_pcg"),
    "rgbd360_tpu_torch.slam.pbmap_slam": ("optimize_pose_graph",),
}
# the kinds drawn from the seed's first stream, in this order; every other
# kind is drawn from a stream of its own, so adding a kind leaves these
# draws as they were
FIRST_STREAM = ("frames", "graphs", "solves")


def _pyr_dict(pyr) -> dict:
    return {c: list(getattr(pyr, c)) for c in R.CHANNELS}


class Recorder:
    """The sampled answers of one window (see the module doc).  `sample`
    maps each kind (`frames`, `solves`, `graphs`, `registrations`) to
    [k, n]."""

    KINDS = ("frames", "solves", "graphs", "registrations")

    def __init__(self, seed: int, sample: dict):
        first = np.random.default_rng([int(seed), 7])
        self.drawn = {kind: set() for kind in self.KINDS}
        for kind, (k, n) in sorted(sample.items()):
            rng = first if kind in FIRST_STREAM else np.random.default_rng(
                [int(seed), 7, zlib.crc32(kind.encode())])
            self.drawn[kind] = {int(i) for i in rng.choice(int(n), size=min(int(k), int(n)),
                                                           replace=False)}
        self.calls = dict.fromkeys(self.drawn, 0)
        self.items = {kind: {} for kind in self.drawn}
        self.frame = -1
        self._undo = []

    def _draw(self, kind: str) -> int | None:
        """The ordinal of this call of `kind` if it is drawn, else None."""
        i = self.calls[kind]
        self.calls[kind] = i + 1
        return i if i in self.drawn[kind] else None

    def install(self, slam, builder, spans: bool) -> None:
        """Wrap the answer-producing calls; with `spans`, also mark the
        tracking calls and the keyframe-event engine as profiler ranges
        (`bench.register`, `bench.align`, `bench.event`).  A target the
        program no longer has, or a tracker module with no graph solvers
        listed, is an error, not a call left unchecked."""
        rec = self

        def patch(obj, name, make):
            orig = getattr(obj, name)
            setattr(obj, name, make(orig))
            self._undo.append((obj, name, orig))

        def build_full(orig):
            def call(frame, timer=None):
                out = orig(frame, timer)
                if rec._draw("frames") is not None:
                    sph, pyr, _ = out
                    rec.items["frames"][rec.frame] = (sph.sphere_gray, sph.sphere_depth, pyr)
                return out
            return call

        def align(orig):
            def call(src, trg, init_pose=None, *a, **kw):
                with _span(spans, "bench.align"):
                    res = orig(src, trg, init_pose, *a, **kw)
                single = init_pose is None or np.ndim(init_pose) == 2
                if single and src.gray[0].ndim == 2 and trg.gray[0].ndim == 2:
                    k = rec._draw("solves")
                    if k is not None:
                        dev = src.gray[0].device
                        init = (torch.eye(4, device=dev) if init_pose is None else
                                torch.as_tensor(init_pose, dtype=torch.float32, device=dev))
                        rec.items["solves"][k] = (src, trg, init.clone(), res)
                return res
            return call

        def register(orig):
            sig = inspect.signature(orig)

            def call(*a, **kw):
                args = sig.bind(*a, **kw)
                args.apply_defaults()
                ref, trg = args.arguments["ref"], args.arguments["trg"]
                k = None
                if ref.valid.ndim == 1 and trg.valid.ndim == 1:
                    k = rec._draw("registrations")
                if k is not None:
                    snap = tuple({f: getattr(p, f).clone() for f in R.PLANE_FIELDS}
                                 for p in (ref, trg))
                with _span(spans, "bench.register"):
                    res = orig(*a, **kw)
                if k is not None:
                    rec.items["registrations"][k] = (*snap, int(args.arguments["mode"]), res)
                return res
            return call

        def solver(orig):
            sig = inspect.signature(orig)

            def call(*a, **kw):
                k = rec._draw("graphs")
                if k is None:
                    return orig(*a, **kw)
                args = sig.bind(*a, **kw)
                args.apply_defaults()
                g = args.arguments["graph"]
                snap = {f.name: getattr(g, f.name).clone() for f in dataclasses.fields(g)}
                lm = args.arguments.get("loop_mask")
                snap["loop_mask"] = None if lm is None else lm.clone()
                for key in ("max_iters", "lm_lambda0", "lm_step", "dcs_phi"):
                    snap[key] = float(args.arguments[key])
                out = orig(*a, **kw)
                rec.items["graphs"][k] = (snap, out[0])
                return out
            return call

        def spanned(name):
            def make(orig):
                def call(*a, **kw):
                    with _span(True, name):
                        return orig(*a, **kw)
                return call
            return make

        module = type(slam).__module__
        if module not in GRAPH_SOLVERS:
            raise KeyError(f"no graph solvers listed for the tracker module {module}")
        patch(builder, "build_full", build_full)
        patch(slam.aligner, "align", align)
        patch(slam.plane_reg, "register", register)
        for fn in GRAPH_SOLVERS[module]:
            patch(importlib.import_module(module), fn, solver)
        if spans:
            patch(slam, "_advance_head", spanned("bench.event"))

    def uninstall(self) -> None:
        """Put back what `install` wrapped: a module's attribute, or the
        class's method under an instance's wrapper."""
        for obj, name, orig in reversed(self._undo):
            if inspect.ismodule(obj):
                setattr(obj, name, orig)
            else:
                del obj.__dict__[name]
        self._undo = []


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


# ------------------------------------------------------------- comparison


def _share_over(answer: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor, rel: bool):
    tol = TOL + (TOL * ref.abs() if rel else 0.0)
    bad = ((answer - ref).abs() > tol) & keep
    return int(bad.sum()), int(keep.sum())


def _rel(a, b) -> float:
    return float(abs(float(a) - float(b)) / max(abs(float(b)), 1e-12))


def match_gap(ref: dict, trg: dict, pairs: list, cfg: dict, mode: int) -> float:
    """`plane_match_gap` of one registration's match set [(i, j), ...]
    (module doc)."""
    cand = R.plane_candidates(ref, trg, cfg, mode)
    cons = R.plane_consistency(ref, trg, cand, cfg)
    w = R.plane_vote_weights(ref, trg)
    live, gap = cand, 0.0
    for step in range(int(cfg["max_matches"])):
        votes = R.plane_votes(cons, live, w)
        best = float(votes.max())
        if step == len(pairs):
            return 1.0 if best > 0.0 else gap
        i, j = pairs[step]
        if not bool(live[i, j]):
            return 1.0
        gap = max(gap, (best - float(votes[i, j])) / best)
        live = R.plane_live_after(live, cons, i, j)
    return gap


def info_gap(answer: torch.Tensor, ref: torch.Tensor) -> float:
    """`plane_info_gap` of one information matrix: |I - I_ref|_F / |I_ref|_F,
    the absolute gap where I_ref is 0."""
    norm = float(torch.linalg.norm(ref))
    diff = float(torch.linalg.norm(answer.float() - ref))
    return diff / norm if norm > 0.0 else diff


def numbers(rec: Recorder, rig_args: tuple, raw_of, cfg: dict, matcher: dict,
            control: bool = False) -> dict:
    """The compared numbers of the recorded answers (module doc); with
    `control`, of the control's answers in their place.  `raw_of(i)`
    is window frame i's capture; `cfg` holds the dense configuration
    (`min_depth`, `max_depth`, `pyramid_levels`, `std_photo`, `std_depth`,
    `sal_intensity`, `sal_depth`) and `matcher` the plane matcher's
    (`min_planes_recognition`, the unary and binary thresholds,
    `max_matches`)."""
    out = {}
    with R.precision(False):
        rig = R.Rig.build(*rig_args)
    seam = rig.seam_mask()
    shares = []
    pshares = []
    for idx, (g0, d0, pyr) in sorted(rec.items["frames"].items()):
        raw = raw_of(idx)
        with R.precision(False):
            g_ref, d_ref = R.sphere(raw.rgb, raw.depth_mm, rig)
        gray, depth = g0, d0
        if control:
            gray, depth = R.sphere(raw.rgb, raw.depth_mm, rig, dtype=torch.bfloat16)
        keep = ~rig.ambiguous
        bad = (((gray - g_ref).abs() > TOL) | ((depth - d_ref).abs() > TOL)) & keep
        shares.append(float(bad.sum()) / float(keep.sum()))

        # the pyramid stage, from the program's own sphere
        levels = int(cfg["pyramid_levels"])
        with R.precision(False):
            ref = R.pyramid(g0, d0, levels, seam, cfg["min_depth"], cfg["max_depth"])
        if control:
            with R.precision(True):
                ans = R.pyramid(g0, d0, levels, seam, cfg["min_depth"], cfg["max_depth"])
        else:
            ans = _pyr_dict(pyr)
        nb = tot = 0
        for c in R.CHANNELS:
            for lvl in range(levels):
                keep = ~rig.seam_tie[:: 2**lvl, :: 2**lvl]
                b, t = _share_over(ans[c][lvl], ref[c][lvl], keep, rel=True)
                nb, tot = nb + b, tot + t
        pshares.append(nb / tot)
    if shares:
        out["sphere_share"] = max(shares)
        out["pyramid_share"] = max(pshares)

    hgaps, rgaps, tgaps, agaps = [], [], [], []
    for _, (src, trg, init, res) in sorted(rec.items["solves"].items()):
        if bool(res.ill_posed):
            continue
        s, t = _pyr_dict(src), _pyr_dict(trg)
        with R.precision(False):
            ref_pose, _ = R.dense_solve(s, t, init, cfg)
            pose = R.dense_solve(s, t, init, cfg, torch.bfloat16)[0] if control else res.pose
        gap = R.se3_inv(ref_pose.double()) @ pose.double()
        tgaps.append(float(torch.linalg.norm(gap[:3, 3])))
        agaps.append(float(torch.linalg.norm(R.so3_log(gap[:3, :3]))))
        with R.precision(False):
            ref = R.track_stats(s, t, res.pose, cfg)
        if control:
            with R.precision(True):
                ans = R.track_stats(s, t, res.pose, cfg)
            ans.update({k: v for k, v in R.track_stats(s, t, res.pose, cfg, torch.bfloat16).items()
                        if k != "hessian"})
        else:
            ans = {"hessian": res.hessian, "av_photo": res.av_photo_residual,
                   "av_depth": res.av_depth_residual, "sso": res.sso}
        hgaps.append(float(torch.linalg.norm(ans["hessian"] - ref["hessian"])
                           / torch.clamp(torch.linalg.norm(ref["hessian"]), min=1e-30)))
        rgaps.append(max(_rel(ans[k], ref[k]) for k in ("av_photo", "av_depth", "sso")))
    if hgaps:
        out["track_pose_gap_m"] = max(tgaps)
        out["track_pose_gap_rad"] = max(agaps)
        out["track_hessian_gap"] = max(hgaps)
        out["track_residual_gap"] = max(rgaps)

    excess = []
    for _, (snap, poses) in sorted(rec.items["graphs"].items()):
        n = int(snap["vmask"].sum())
        em = snap["emask"]
        lm = snap["loop_mask"]
        is_loop = (torch.zeros_like(em) if lm is None else lm)[em]
        edges = (snap["edges_ij"][em], snap["rel"][em], snap["info"][em], is_loop)
        start = snap["poses"][:n]
        with R.precision(False):
            ref = R.graph_solve(start, *edges, snap["dcs_phi"], int(snap["max_iters"]),
                                snap["lm_lambda0"], snap["lm_step"], dtype=torch.float64)
        if control:
            poses = R.graph_solve(start, *edges, snap["dcs_phi"], int(snap["max_iters"]),
                                  snap["lm_lambda0"], snap["lm_step"], dtype=torch.bfloat16)
        c_in, c_ans, c_ref = (R.graph_cost(x[:n], *edges, snap["dcs_phi"])
                              for x in (start, poses, ref))
        excess.append(max(0.0, c_ans - c_ref) / max(c_in, 1e-30))
    if excess:
        out["graph_cost_excess"] = max(excess)

    mgaps, pgaps_m, pgaps_r, igaps = [], [], [], []
    for _, (ref, trg, mode, res) in sorted(rec.items["registrations"].items()):
        if control:
            ans = R.plane_register(ref, trg, matcher, mode, torch.bfloat16)
            pairs = ans["pairs"]
        else:
            n = int(res.n_matches)
            pairs = [tuple(p) for p in res.pairs[:n].tolist()]
            ans = {"pose": res.pose, "information": res.information,
                   "success": bool(res.success)}
        with R.precision(False):
            mgaps.append(match_gap(ref, trg, pairs, matcher, mode))
            want = R.plane_pose(ref, trg, pairs, matcher)
        if ans["success"] != want["success"]:
            pgaps_m.append(math.inf)
            pgaps_r.append(math.inf)
        else:
            gap = R.se3_inv(want["pose"].double()) @ ans["pose"].double()
            pgaps_m.append(float(torch.linalg.norm(gap[:3, 3])))
            pgaps_r.append(float(torch.linalg.norm(R.so3_log(gap[:3, :3]))))
        igaps.append(info_gap(ans["information"], want["information"]))
    if mgaps:
        out["plane_match_gap"] = max(mgaps)
        out["plane_pose_gap_m"] = max(pgaps_m)
        out["plane_pose_gap_rad"] = max(pgaps_r)
        out["plane_info_gap"] = max(igaps)
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number the limits name
    is present and at most its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = nums.get(name)
        finite = v is not None and bool(np.isfinite(v))
        # a value that is not finite goes on the result line as its name
        checks[name] = {"value": v if v is None or finite else str(v), "limit": limit}
        if not finite or v > limit:
            ok = False
    return ok, checks
