"""The ring cell's float64 reference (``portbench/reference/turntable.py``)
alone and against the port, on the CPU.

Rules: run in float64, the port's ``refine_turntable`` and ``run_ba``
(dense) take the reference's steps, to 1e-9 (their rules are the
same; the sums run in other orders).  The tracks of the same matches
are the port's exactly.

On ``synthetic_ring.injected_ring``'s 12 frames (the port's turntable
tests' ring: 160 points, 0.3 px noise, the bas-relief-collapsed chain)
the port (float32) and the reference (float64) end within
``INJECTED_TOL``: f32 rounding of ~1,900 observations' LM moves the
steps by ~1e-5 deg and f by ~4e-7 (measured), a hundredth of the
tolerances; and the reference alone meets r5's bar on it.

The cell's renderer (``portbench/gen/ring.py``) draws the repository's
ring exactly.  The cell: one rehearsed run (``portbench/run.py --rehearse``: 36 frames
of 432 x 540 on the CPU, seed 1) is correct; a similarity transform of
the port's whole output leaves every judged number as it was, to 1e-9
relative (the free BA holds no camera: the two sides may end under
different gauges); planted faults fail a limit (a frame turned 0.01
deg, a ring built without its wrap edges, the control).
"""

import ast
import contextlib
import io
import json
import math
import pathlib
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench.harness import bench
from portbench.reference import turntable as ref
from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.models import turntable as tt
from synthetic_ring import INJECTED_FRAMES, INJECTED_K, injected_ring
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "dino_ring36_720x576.turntable"
N = INJECTED_FRAMES
D = torch.float64
# Port (float32) against reference (float64) on the injected ring: the
# steps and the aligned rotations to 1e-3 deg, f to 1e-5 relative, the
# kept observations to 1%; the port's end 1e-6 from the float64 optimum
# of its own last BA (measured: 1.3e-5 deg, 1.0e-5 deg, 4e-7, 0 and
# 2.4e-8).
INJECTED_TOL = {"step_gap_deg": 1e-3, "rot_gap_deg": 1e-3, "f_gap": 1e-5, "keep": 0.01,
                "ba_descent": 1e-6}


def _feats(frames):
    return [types.SimpleNamespace(
        keypoints=types.SimpleNamespace(x=torch.as_tensor(f["x"]), y=torch.as_tensor(f["y"]),
                                        valid=torch.as_tensor(f["valid"])),
        descriptors=torch.as_tensor(f["descriptors"])) for f in frames]


@pytest.fixture(scope="module")
def injected():
    """The injected ring, the port's reconstruct_turntable on it, and the
    reference on the port's ring matches from the same chain's frames 0
    and 1."""
    frames, Rc, tc, R_gt, _ = injected_ring()
    port = tt.reconstruct_turntable(_feats(frames), Rc, tc, INJECTED_K, PipelineConfig(),
                                    pose_valid=np.ones(N, bool))
    uv = np.stack([np.stack([f["x"], f["y"]], -1) for f in frames])
    valid = np.stack([f["valid"] for f in frames])
    ring = ref.run(uv, valid, port.matches, Rc[:2].astype(np.float64),
                   tc[:2].astype(np.float64), INJECTED_K)
    return types.SimpleNamespace(frames=frames, Rc=Rc, tc=tc, R_gt=R_gt, port=port, ring=ring,
                                 uv=uv, valid=valid)


def test_reference_tracks_are_the_ports(injected):
    p, r = injected.port.tracks, injected.ring.tracks
    assert r.n == p.n_tracks > 100
    for a, b in ((r.cam, p.cam_idx), (r.slot, p.slot), (r.pt, p.pt_idx)):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(r.uv, p.uv_pix.numpy().astype(np.float64))


def test_port_rules_in_float64_are_the_references(injected):
    """refine_turntable and run_ba fed float64 take the reference's
    steps: the same poses, intrinsics, kept observations and costs."""
    ts = injected.port.tracks
    R0 = torch.as_tensor(injected.Rc[0], dtype=D)
    C0 = -R0.T @ torch.as_tensor(injected.tc[0], dtype=D)
    axis = R0.T @ torch.tensor([0.0, 1.0, 0.0], dtype=D)
    centre = C0 + 5.0 * R0.T[:, 2]
    port_model = tt.TurntableModel(axis=axis, center=centre, R0=R0, C0=C0,
                                   sign=torch.tensor(1.0, dtype=D))
    A = ref.Arith(False)
    rt = injected.ring.tracks
    for hub, pru, intr in ((64.0, 4000.0, False), (2.0, 8.0, True)):
        p = tt.refine_turntable(port_model, ts.cam_idx, ts.pt_idx, ts.uv_pix.double(),
                                ts.mask, torch.as_tensor(INJECTED_K, dtype=D), n_frames=N,
                                n_points=ts.n_tracks, iters=12, tri_rounds=2, huber_px=hub,
                                prune_px=pru, estimate_intrinsics=intr)
        r = ref.refine(A, ref.Model(axis, centre, R0, C0, 1.0), rt,
                       torch.ones(len(rt.cam), dtype=torch.bool), INJECTED_K, N, iters=12,
                       rounds=2, huber=hub, prune=pru, intrinsics=intr)
        assert (p[2] - r[2]).abs().max() < 1e-9
        assert float(p[1][0]) == pytest.approx(float(r[1][0]), rel=1e-12)
        assert float(p[1][1]) == pytest.approx(float(r[1][1]), abs=1e-9)
        assert torch.equal(p[5], r[5]) and p[6] == pytest.approx(r[6], rel=1e-9)
    R, t, X, keep = p[2], p[3], p[4], p[5]
    R = R @ ref.rodrigues(torch.as_tensor(np.random.default_rng(0).normal(size=(N, 3)) * 1e-3))
    uvn = (ts.uv_pix.double() - torch.tensor([360.0, 288.0], dtype=D)) / 1800.0
    problem = ba.BAProblem(ts.cam_idx, ts.pt_idx, uvn, keep, torch.zeros(N, dtype=torch.bool))
    st, costs = ba.run_ba(R, t, X, problem, iters=10, huber_delta=2.0 / 1800, solver="dense")
    sel = torch.nonzero(keep).flatten()
    ids, sub = torch.unique(ts.pt_idx[sel], return_inverse=True)
    Rr, tr_, Xr, cr = ref.lm(A, R, t, X[ids], ts.cam_idx[sel], sub, uvn[sel], 2.0 / 1800, 10)
    assert (st.R - Rr).abs().max() < 1e-9 and (st.X[ids] - Xr).abs().max() < 1e-9
    np.testing.assert_allclose(costs.numpy(), cr, rtol=1e-9)


def test_port_and_reference_agree_on_the_injected_ring(injected):
    p, r = injected.port, injected.ring
    steps = ref.step_gaps(p.R.numpy(), r.R)
    after, _, _ = ref.aligned_rotation_gaps(p.R.numpy(), r.R)
    tracks = ref.Tracks(p.tracks.cam_idx.numpy(), p.tracks.slot.numpy(),
                        p.tracks.pt_idx.numpy(), p.tracks.uv_pix.numpy().astype(np.float64),
                        p.tracks.n_tracks)
    descent, _ = ref.ba_descent(p.R.numpy(), p.t.numpy(), p.X.numpy(), tracks, p.ba_obs, p.f,
                                p.k1, p.k2, INJECTED_K, ref.SNAP_SCHEDULE[-1][0] / 1800.0)
    assert steps.max() < INJECTED_TOL["step_gap_deg"], steps
    assert after.max() < INJECTED_TOL["rot_gap_deg"], after
    assert abs(p.f - r.f) / r.f < INJECTED_TOL["f_gap"]
    assert abs(int(p.keep.sum()) - int(r.keep.sum())) <= INJECTED_TOL["keep"] * r.keep.sum()
    assert 0 <= descent < INJECTED_TOL["ba_descent"]


def test_reference_alone_meets_the_bar_on_the_injected_ring(injected):
    """r5's bar (chip_smoke.RING_BAR) against the rendered ring, and
    the rotations within 0.05 deg of the rendered ones once the world
    rotation is removed."""
    r = injected.ring
    step = 360.0 / N
    assert abs(r.step_deg.mean() - step) <= 0.2 and r.step_deg.std() <= 0.3
    assert abs(r.total_deg - 360.0) <= 2.0 and r.rms_px <= 1.5
    gaps, _, _ = ref.aligned_rotation_gaps(r.R, injected.R_gt)
    assert gaps.max() < 0.05, gaps


def test_the_cells_renderer_draws_the_repositorys_ring(monkeypatch):
    """``portbench/gen/ring.py`` with numpy's draws gives
    ``tests/synthetic_ring.py``'s frames, poses and K exactly (at a
    64-texel texture on both sides, to keep the numpy painter quick)."""
    import synthetic_ring as sr

    from portbench.gen import ring as gen
    from portbench.gen import scene

    monkeypatch.setattr(sr, "TEXTURE_N", 64)
    a = sr.synthetic_ring(40, 56, n_frames=3, seed=5)
    b = gen.synthetic_ring(40, 56, 3, sr.STEP_DEG, sr.FOCAL_PX, a["k1"],
                           scene=scene.NumpyDraws(5), noise=scene.NumpyDraws(6), device="cpu",
                           texture_n=64)
    assert (a["images"] > 0).mean() > 0.5
    np.testing.assert_array_equal(a["images"], b["images"].numpy())
    for k in ("K", "R", "t"):
        np.testing.assert_array_equal(a[k], b[k])


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "portbench" / "reference" / "turntable.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert not names & {"jax", "jaxlib", "flax", "sfm_tpu", "sfm_tpu_torch"}


@pytest.fixture(scope="module")
def rehearsal():
    """One rehearsed traced run of the cell, seed 1: its result line, and
    the entry and judged outputs it checked (as in
    test_torch_sequence_reference.py)."""
    seen = {}
    judge = bench.judge
    loaded = set(sys.modules)
    forbidden = bench.devmod.forbidden_modules

    def keep(entry, outputs, limits, control=False):
        seen.update(entry=entry, outputs=outputs, limits=limits, refs={})
        reference = entry.reference

        def kept(r, control=False):
            if control:
                return reference(r, control=True)
            if r not in seen["refs"]:
                seen["refs"][r] = reference(r)
            return seen["refs"][r]

        entry.reference = kept
        return judge(entry, outputs, limits, control)

    calls = []
    reconstruct_turntable = tt.reconstruct_turntable

    def turntable(*args, **kwargs):     # the judged request's turntable stage, kept
        calls.append((args, kwargs))
        return reconstruct_turntable(*args, **kwargs)

    n = torch.get_num_threads()
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
            mp.setattr(tt, "reconstruct_turntable", turntable)
            mp.setattr(bench, "judge", keep)
            mp.setattr(bench.devmod, "forbidden_modules",
                       lambda: [m for m in forbidden() if m not in loaded])
            rc = bench.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace",
                             "1", "--rehearse"], ROOT, time.time())
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    seen["result"] = json.loads(out.getvalue().strip().splitlines()[-1])
    (r, got), = seen["outputs"].items()
    seen["got"], seen["ref"], seen["r"] = got, seen["refs"][r], r
    seen["turntable_call"] = calls[-1]
    return seen


def _passes(checks, limits):
    return {k: v <= limits[k]["limit"] for k, v in checks.items()}


def test_rehearsed_run_is_correct_and_reads_its_metrics(rehearsal):
    res = rehearsal["result"]
    assert res["correct"] is True, res["checks"]
    assert {"chain_ms.ring", "pinned_lm_ms.ring", "free_ba_ms.ring"} <= set(res["read"])
    assert set(res["checks"]) == set(rehearsal["entry"].compared)


def _similar(got, seed):
    """``got`` with its poses and points moved by one similarity: X' = s
    Q X + c."""
    rng = np.random.default_rng(seed)
    Q = ref.rodrigues(torch.as_tensor(rng.normal(size=3))).numpy()
    s, c = 3.7, rng.normal(size=3) * 5.0
    R = np.asarray(got["R"], np.float64)
    t = np.asarray(got["t"], np.float64)
    out = dict(got)
    out["R"] = R @ Q.T
    out["t"] = s * t - np.einsum("mij,j->mi", out["R"], c)
    out["X"] = s * np.asarray(got["X"], np.float64) @ Q.T + c
    return out


def test_a_similarity_of_the_ports_output_changes_no_judged_number(rehearsal):
    e, got, r = rehearsal["entry"], rehearsal["got"], rehearsal["ref"]
    base = e.compare(got, r)
    for seed in (0, 1):
        moved = e.compare(_similar(got, seed), r)
        for k, v in base.items():
            assert moved[k] == pytest.approx(v, rel=1e-9, abs=1e-300), (k, v, moved[k])


@pytest.mark.parametrize("fault", ["turned_frame", "no_wrap", "control"])
def test_a_planted_fault_fails(rehearsal, fault):
    """One frame turned 0.01 deg fails ``frame_descent``; a ring built
    without its wrap edges fails ``corr_miss`` (its wrap pairs are
    unmatched) and ``track_gap``; the control (the reference one
    precision down) fails a limit."""
    e, r = rehearsal["entry"], rehearsal["r"]
    if fault == "turned_frame":
        got = dict(rehearsal["got"])
        R = np.asarray(got["R"], np.float64).copy()
        R[5] = ref.rodrigues(torch.tensor([0.0, math.radians(0.01), 0.0],
                                          dtype=D)).numpy() @ R[5]
        got["R"] = R
        names = ["frame_descent"]
    elif fault == "no_wrap":     # the judged request's turntable stage again, unwrapped
        args, kwargs = rehearsal["turntable_call"]
        res = tt.reconstruct_turntable(*args, **{**kwargs, "wrap": False})
        ts = res.tracks
        got = dict(rehearsal["got"])
        got.update({k: v.numpy() if torch.is_tensor(v) else v for k, v in dict(
            R=res.R, t=res.t, X=res.X, f=res.f, k1=res.k1, k2=res.k2, step_deg=res.step_deg,
            total_deg=res.total_deg, ba_obs=res.ba_obs, kept=res.keep, cam=ts.cam_idx,
            pt=ts.pt_idx, slot=ts.slot, uv_pix=ts.uv_pix, n_tracks=ts.n_tracks).items()})
        got["matches"] = {k: v for k, v in got["matches"].items()
                          if k in res.matches or k not in e.ring_pairs}
        names = ["corr_miss", "track_gap"]
    else:
        got = e.reference(r, control=True)
        names = list(e.compared)
    checks = e.compare(got, rehearsal["ref"])
    passes = _passes(checks, rehearsal["limits"])
    assert not all(passes[n] for n in names), checks
