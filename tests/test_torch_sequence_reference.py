"""The sequence cell's float64 reference (``portbench/reference/sequence.py``)
alone and against the port, on the CPU.

Alone: its PnP recovers an exact pose from noiseless correspondences
(float64 leaves ~1e-13 deg; the bar is 1e-9), its LM leaves an exact
problem at zero cost and brings a perturbed one back, and its closure
merges two ids of one point.

Against the port: one rehearsed run of the cell
(``portbench/run.py --rehearse``: 6 frames of 432 x 528 on the CPU,
seed 1) is correct and reads its host-clock metrics; on its judged
request the port and the reference register the same frames, their
rotations agree within ``ROT_TOL_DEG`` and ``ba_descent`` is under the
cell's limit; the control (the reference one precision down) fails at
least one of the cell's limits; planted faults fail them too (one
frame's rotation turned by 0.01 deg, a closure that does nothing, a
registration that carries no track ids over).  ``run_incremental``'s
callable minimal sets give the same run as the index sets they return.
A hand-built closure (a merge, an id passed on each way, a refused one,
a new point) gives the map worked out by hand, in the port and in the
reference.
"""

import ast
import contextlib
import io
import json
import math
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from portbench.harness import bench, compare as cmp, draws
from portbench.reference import sequence as ref
from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu_torch.models import incremental
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "dino_seq12_720x576.incremental"
# The port's float32 LM and the reference's float64 LM take their accept
# decisions on costs that differ in the seventh digit, so after the
# sequence's ~80 LM steps their poses part along the cost's flat valley:
# on the worst frame, at the rehearsal size by 5.7e-4 deg (seed 1, the
# run's four threads; 0.021 on eight), at the cell's size by up to
# 5.4e-3 (PERF.md).  The bar is half the cell's limit, 0.02, on every
# frame; the control parts by whole degrees at this size.
ROT_TOL_DEG = 0.01


def _rot(axis, deg):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = math.radians(deg)
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def _scene(n_cams=4, n_pts=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_pts, 3)) + [0, 0, 6.0]
    R = np.stack([_rot([0, 1, 0.1], 3.0 * i) for i in range(n_cams)])
    t = np.stack([[-0.4 * i, 0.05 * i, 0.02 * i] for i in range(n_cams)], 0).astype(float)
    Xc = np.einsum("mij,pj->mpi", R, X) + t[:, None]
    return R, t, X, Xc[..., :2] / Xc[..., 2:]


def test_reference_pnp_recovers_an_exact_pose():
    A = ref.Arith(False)
    R, t, X, uv = _scene(n_cams=2, n_pts=80)
    x = torch.as_tensor(np.concatenate([uv[1], np.ones((80, 1))], 1))
    mask = np.ones(80, bool)
    u = draws.uniforms(7, 64, 6, "cpu")
    Rg, tg, inl = ref.ransac_pnp(A, x, torch.as_tensor(X), mask,
                                 lambda m: draws.minimal_sets(u, m), 1.2e-5,
                                 torch.eye(3, dtype=torch.float64),
                                 torch.zeros(3, dtype=torch.float64))
    assert inl.all()
    assert cmp.rotation_gap_deg(Rg.numpy(), R[1]) < 1e-9
    assert np.abs(tg.numpy() - t[1]).max() < 1e-9


def _problem(uv, n_cams, n_pts):
    cam = torch.arange(n_cams).repeat_interleave(n_pts)
    pt = torch.arange(n_pts).repeat(n_cams)
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[0] = True
    return ref.Problem(cam, pt, torch.as_tensor(uv.reshape(-1, 2)), fixed)


def test_reference_ba_keeps_an_exact_problem_and_restores_a_perturbed_one():
    A = ref.Arith(False)
    R, t, X, uv = _scene()
    prob = _problem(uv, 4, 60)
    T = torch.as_tensor
    _, _, _, costs = ref.lm(A, T(R), T(t), T(X), prob, 3)
    assert costs[0] < 1e-28 and costs[-1] <= costs[0]
    rng = np.random.default_rng(1)
    Rp = np.stack([R[0]] + [_rot(rng.normal(size=3), 0.5) @ r for r in R[1:]])
    tp = t + np.vstack([np.zeros(3), rng.normal(scale=0.01, size=(3, 3))])
    Xp = X + rng.normal(scale=0.02, size=X.shape)
    Rf, _, _, costs = ref.lm(A, T(Rp), T(tp), T(Xp), prob, 30)
    assert costs[0] > 1e-4 and costs[-1] < 1e-20
    # The rotations are fixed by camera 0 (the scale is not).
    assert max(cmp.rotation_gap_deg(Rf[m].numpy(), R[m]) for m in range(4)) < 1e-6


def test_reference_closure_merges_two_ids_of_one_point():
    A = ref.Arith(False)
    R, t, X, uv = _scene(n_cams=2, n_pts=1)
    m = ref._Map(A, 2, 4, 8)
    m.R, m.t = torch.as_tensor(R), torch.as_tensor(t)
    m.pose_valid[:] = True
    m.append(torch.as_tensor(np.stack([X[0], X[0] + 1e-4])), np.ones(2, bool))
    m.pid[0] = [0, -1, -1, -1]
    m.pid[1] = [-1, -1, 1, -1]
    x = torch.zeros((2, 4, 3), dtype=torch.float64)
    x[..., 2] = 1.0
    x[0, 0, :2] = torch.as_tensor(uv[0, 0])
    x[1, 2, :2] = torch.as_tensor(uv[1, 0])
    idx = np.array([2, 0, 1, 3])
    ok = np.array([True, False, False, False])
    ref._closure(A, m, 0, 1, x, idx, ok, 3e-6 * 4 * 64)
    assert m.pid[1].tolist() == [-1, -1, 0, -1] and m.pid[0].tolist() == [0, -1, -1, -1]
    assert m.X_valid[:2].tolist() == [True, False]


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((ROOT / "portbench" / "reference" / "sequence.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert not names & {"jax", "jaxlib", "flax", "sfm_tpu", "sfm_tpu_torch"}


@pytest.fixture(scope="module")
def rehearsal():
    """One rehearsed traced run of the cell, seed 1: its result line, and
    the entry and judged outputs it checked.  The test process has JAX
    loaded (``conftest.py``), so the run's check of ``sys.modules`` looks
    at what the run itself loads."""
    seen = {}
    judge = bench.judge
    loaded = set(sys.modules)
    forbidden = bench.devmod.forbidden_modules

    def keep(entry, outputs, limits, control=False):
        seen.update(entry=entry, outputs=outputs, limits=limits, refs={})
        reference = entry.reference

        def kept(r, control=False):     # the check's reference, kept for the tests
            if control:
                return reference(r, control=True)
            if r not in seen["refs"]:
                seen["refs"][r] = reference(r)
            return seen["refs"][r]

        entry.reference = kept
        return judge(entry, outputs, limits, control)

    n = torch.get_num_threads()
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
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
    seen["got"], seen["ref"] = got, seen["refs"][r]
    seen["r"] = r
    return seen


def _passes(checks, limits):
    return {k: v <= limits[k]["limit"] for k, v in checks.items()}


def test_rehearsed_run_is_correct_and_reads_its_metrics(rehearsal):
    res = rehearsal["result"]
    assert res["correct"] is True
    assert {"register_ms.seq", "ba_ms.seq"} <= set(res["read"])
    assert set(res["checks"]) == set(rehearsal["entry"].compared)


def test_port_and_reference_agree(rehearsal):
    got, r = rehearsal["got"], rehearsal["ref"]
    assert (got["pose_valid"] == r["pose_valid"]).all() and got["pose_valid"].sum() >= 5
    gaps = [cmp.rotation_gap_deg(got["R"][f], r["R"][f])
            for f in np.nonzero(got["pose_valid"])[0]]
    assert max(gaps) < ROT_TOL_DEG, gaps
    checks = rehearsal["entry"].compare(got, r)
    assert checks["ba_descent"] < rehearsal["limits"]["ba_descent"]["limit"]
    assert all(_passes(checks, rehearsal["limits"]).values()), checks


def test_control_fails_a_limit(rehearsal):
    e = rehearsal["entry"]
    control = e.reference(rehearsal["r"], control=True)
    checks = e.compare(control, rehearsal["ref"])
    assert not all(_passes(checks, rehearsal["limits"]).values()), checks


def _drop_carried_ids(register):
    """``_register_image`` that keeps none of the ids it carries over: the
    registered frame holds its fresh points only."""
    def drop(state, cur_idx, *args, **kwargs):
        n0 = state.n_points
        state, n = register(state, cur_idx, *args, **kwargs)
        pid = state.point_id.clone()
        pid[cur_idx] = torch.where(pid[cur_idx] >= n0, pid[cur_idx], -1)
        return state._replace(point_id=pid), n
    return drop


@pytest.mark.parametrize("fault", ["turned_frame", "closure_skipped", "tracks_dropped"])
def test_a_planted_fault_fails(rehearsal, fault):
    """One frame's rotation turned by 0.01 deg fails ``ba_descent``; a
    closure that does nothing, or a registration that carries no ids
    over, leaves the poses near the reference's and fails ``track_gap``."""
    e, r = rehearsal["entry"], rehearsal["r"]
    if fault == "turned_frame":
        got = dict(rehearsal["got"])
        R = got["R"].copy()
        R[3] = _rot([0, 1, 0], 0.01).astype(R.dtype) @ R[3]
        got["R"] = R
        name = "ba_descent"
    else:
        with pytest.MonkeyPatch.context() as mp:
            if fault == "closure_skipped":
                mp.setattr(incremental, "_apply_closure", lambda state, *a, **k: (state, 0))
            else:
                mp.setattr(incremental, "_register_image",
                           _drop_carried_ids(incremental._register_image))
            e.prepare(r)
            got = e.request(r, None, keep=True)
            e.release()
        name = "track_gap"
    checks = e.compare(got, rehearsal["ref"])
    assert not _passes(checks, rehearsal["limits"])[name], checks


def test_callable_minimal_sets_equal_the_sets_they_return():
    """``run_incremental`` with callables gives bit for bit what it gives
    with the index sets they returned, on the masks the run handed them."""
    from synthetic_sequence import synthetic_sequence

    seq = synthetic_sequence(144, 176, n_frames=4)
    images = [torch.as_tensor(im) for im in seq["images"]]
    cfg = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=128),
                         ransac=RansacConfig(n_hyps=128, threshold=3e-6, chunk=64))
    drawn, masks = {}, {}

    def hook(i, k):
        u = draws.uniforms(20 + i, 128, k, "cpu")

        def draw(mask):
            masks[i] = mask.clone()
            drawn[i] = draws.minimal_sets(u, mask)
            return drawn[i]
        return draw

    def run(sets):
        return incremental.run_incremental(images, seq["K"], cfg, ba_iters=2, local_ba_iters=1,
                                           closure_pairs=[(0, 3)], device="cpu",
                                           minimal_sets=sets)

    a = run({0: hook(0, 8), 2: hook(2, 6), 3: hook(3, 6)})
    assert sorted(drawn) == [0, 2, 3] and all(m.any() for m in masks.values())
    b = run(dict(drawn))
    for p, q in zip([*a.state, a.ba_costs, a.mean_reproj, a.kept],
                    [*b.state, b.ba_costs, b.mean_reproj, b.kept]):
        assert torch.equal(p, q)
    assert set(a.matches) == {(0, 1), (1, 2), (0, 2), (2, 3), (1, 3), (0, 3)}


def _closure_scene():
    """Three frames of 6 slots and the points 0-4 of a hand-built closure
    of frames 0 and 1 (frame 0's slot k matches frame 1's slot idx[k],
    kept where ``ok``): (R, t, points [6, 3], rays [3, 6, 3], point ids
    [3, 6], idx, ok).

    slot 0 holds 0, its match 1 (the same place, 1e-4 off): a merge, and
    frame 2's 1 becomes 0 too; slot 1 holds 2, its match none: frame 1
    takes 2; slot 2 holds none, its match 3: frame 0 takes 3; slot 3
    holds 4, its match none and sees a place 0.1 away: nothing; slot 4
    and its match hold none and see point 5's place: a new point 5;
    slot 5 is not kept."""
    R = np.stack([np.eye(3), _rot([0, 1, 0], 3.0), _rot([0, 1, 0], 6.0)])
    t = np.array([[0.0, 0, 0], [-0.4, 0.02, 0.01], [-0.8, 0.03, 0.02]])
    P = np.array([[0.2, 0.1, 6.0], [0.2001, 0.1001, 6.0001], [-0.5, 0.3, 5.5],
                  [0.6, -0.4, 6.5], [-0.2, -0.6, 7.0], [0.4, 0.5, 6.2]])

    def ray(m, point):
        Xc = R[m] @ P[point] + t[m]
        return Xc / Xc[2]

    x = np.zeros((3, 6, 3))
    x[..., 2] = 1.0
    for slot, point in [(0, 0), (1, 2), (2, 3), (3, 4), (4, 5)]:
        x[0, slot] = ray(0, point)
    for slot, point in [(2, 0), (3, 2), (0, 3), (1, 4), (5, 5)]:
        x[1, slot] = ray(1, point)
    x[1, 1, 0] += 0.1
    pid = np.array([[0, 2, -1, 4, -1, -1],
                    [3, -1, 1, -1, -1, -1],
                    [-1, 2, -1, -1, 1, -1]])
    idx = np.array([2, 3, 0, 1, 5, 4])
    ok = np.array([True] * 5 + [False])
    return R, t, P, x, pid, idx, ok


CLOSED = [[0, 2, 3, 4, 5, -1], [3, -1, 0, 2, -1, 5], [-1, 2, -1, -1, 0, -1]]


@pytest.mark.parametrize("side", ["port", "reference"])
def test_closure_merges_passes_on_and_makes_ids_as_hand_built(side):
    R, t, P, x, pid, idx, ok = _closure_scene()
    gate = 3e-6 * 4 * 64
    if side == "reference":
        m = ref._Map(ref.Arith(False), 3, 6, 8)
        m.R, m.t = torch.as_tensor(R), torch.as_tensor(t)
        m.pose_valid[:] = True
        m.append(torch.as_tensor(P[:5]), np.ones(5, bool))
        m.pid = pid.copy()
        ref._closure(m.A, m, 0, 1, torch.as_tensor(x), idx, ok, gate)
        table, X, X_valid = m.pid, m.X.numpy(), m.X_valid
    else:
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        X0 = torch.zeros((8, 3))
        X0[:5] = f32(P[:5])
        state = incremental._empty_state(3, 6, 8, device="cpu")._replace(
            X=X0, X_valid=torch.arange(8) < 5, n_points=torch.tensor(5), R=f32(R), t=f32(t),
            pose_valid=torch.ones(3, dtype=torch.bool), point_id=torch.as_tensor(pid))
        state, n = incremental._apply_closure(state, 0, 1, f32(x[0]), f32(x[1]),
                                              torch.as_tensor(idx), torch.as_tensor(ok), gate)
        assert int(n) == 4     # a merge, two passed on, a new point
        table, X, X_valid = (state.point_id.numpy(), state.X.numpy(),
                             state.X_valid.numpy())
    assert table.tolist() == CLOSED
    assert X_valid.tolist() == [True, False, True, True, True, True, False, False]
    assert np.abs(X[5] - P[5]).max() < 1e-4
