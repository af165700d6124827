"""The program's spans and counters (``sfm_tpu_torch/utils/timing.py``)
and their reading over a profiled slice
(``portbench/harness/program_spans.py``), on the CPU.

Off, a span is the shared null context: no record, no synchronize, no
profiler range, no tensor.  On, records nest by ``parent`` and
``request``, the ring keeps its newest, and the counters' deltas land
in the span that saw them.  The geometry's and the frontend's spans
open in their order and leave the results bit for bit as they are, and
so do ``run_incremental``'s, under its stages, whose ``timer=`` keys
stay as they were.
Under ``torch.profiler`` each record lies within 100 us inside its
profiler range (the same clock), and the first call of each name is
recorded once.
"""

import gc
import warnings
from collections import deque

import pytest
import torch

from synthetic_pair import synthetic_pair
from portbench.harness import program_spans
from portbench.harness.trace import Profile
from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu_torch.models import incremental, two_view
from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.sift import frontend
from sfm_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=128),
                     ransac=RansacConfig(n_hyps=128, threshold=3e-6, chunk=64))
GEOMETRY = ["geometry.bank", "geometry.score", "geometry.refit", "geometry.multistart",
            "geometry.probe"] + ["geometry.refine"] * CFG.refine_rounds + [
            "geometry.tvote"] * (CFG.tvote_rounds + (CFG.tvote_rounds > 0)) + [
            "geometry.final"]
SIFT = ["sift.chain", "sift.detect", "sift.select", "sift.atlas", "sift.sample",
        "sift.describe"]
STAGES = {"extract", "match", "bootstrap", "register", "local_ba", "closure", "global_ba"}
LM = ["ba.system", "ba.solve", "ba.step"]


@pytest.fixture(autouse=True)
def fresh():
    timing.disable()
    timing.reset()
    yield
    timing.disable()
    timing.reset()


@pytest.fixture(scope="module")
def pair():
    p = synthetic_pair(144, 176, seed=0)
    return tuple(torch.as_tensor(p[k]) for k in ("img1", "img2", "K"))


def _children(recs, parent):
    return [r.name for r in sorted(recs, key=lambda r: r.index) if r.parent == parent]


class _NoTorch(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the off path called {func}")


def test_off_path_is_the_shared_null_context(monkeypatch):
    with timing.span("off.a"):     # the cold record of the name
        pass

    def refuse(*a, **k):
        raise AssertionError("the off path synchronized or opened a range")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(timing, "_range", refuse)
    with _NoTorch():
        ctx = timing.span("off.a")
        with ctx:
            pass
    assert ctx is timing.span("off.a")
    assert timing.records() == []
    assert list(timing.first_calls()) == ["off.a"]


def test_on_path_nests_parents_and_requests():
    timing.enable()
    with timing.span("a"):
        with timing.span("b"):
            with timing.span("c"):
                pass
        with timing.span("d"):
            pass
    with timing.span("e"):
        pass
    with timing.request(41):
        with timing.span("f"):
            with timing.span("g"):
                pass
        with timing.span("h"):
            pass
    recs = {r.name: r for r in timing.records()}
    assert [r.name for r in timing.records()] == ["c", "b", "d", "a", "e", "g", "f", "h"]
    assert recs["a"].parent == -1 and recs["b"].parent == recs["a"].index
    assert recs["c"].parent == recs["b"].index and recs["d"].parent == recs["a"].index
    assert {recs[n].request for n in "abcd"} == {recs["a"].request}
    assert recs["e"].request == recs["a"].request + 1
    assert {recs[n].request for n in "fgh"} == {41}
    for r in recs.values():
        assert 0 < r.t0_ns <= r.t1_ns
    assert recs["a"].t0_ns <= recs["b"].t0_ns <= recs["c"].t1_ns <= recs["a"].t1_ns


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(timing._S, "ring", deque(maxlen=4))
    timing.enable()
    for i in range(6):
        with timing.span(f"s{i}"):
            pass
    assert [r.name for r in timing.records()] == ["s2", "s3", "s4", "s5"]
    assert [r.index for r in timing.records()] == [2, 3, 4, 5]


def test_counter_deltas_land_in_their_span(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    before = dict(_cuda.LAUNCHES)
    timing.enable()
    try:
        with timing.span("outer"):
            _cuda.launched("match_top2")
            with timing.span("inner"):
                for _ in range(3):
                    _cuda.launched("detect_maps")
                for _ in range(2):   # every occurrence, one call site
                    warnings.warn("called a synchronizing CUDA operation")
            with warnings.catch_warnings(record=True) as other:
                warnings.warn("something else")
    finally:
        _cuda.LAUNCHES.update(before)
    recs = {r.name: r for r in timing.records()}
    assert (recs["inner"].kernel_launches, recs["inner"].host_syncs) == (3, 2)
    assert (recs["outer"].kernel_launches, recs["outer"].host_syncs) == (4, 2)
    assert modes == ["warn", 0]      # on with the outermost span, then restored
    assert [str(w.message) for w in other] == ["something else"]


def test_cold_record_holds_one_entry_per_name(pair):
    img1 = pair[0]
    for _ in range(2):
        frontend.extract_sift(img1, CFG.sift)
    first = timing.first_calls()
    assert sorted(first) == sorted(SIFT + ["sift.extract"])
    assert all(s > 0 for s in first.values())
    assert first["sift.extract"] >= max(first[n] for n in SIFT)
    assert timing.records() == []


def test_timer_span_records_into_the_stage_timer():
    timer = timing.StageTimer()
    for _ in range(2):
        with timing.span("stage", timer=timer):
            pass
    assert timer.counts["stage"] == 2 and timer.totals["stage"] >= 0
    assert timing.records() == []


def test_geometry_spans_in_order_and_results_unchanged(pair):
    uv1, uv2, mask = two_view.frontend_stage(pair[0], pair[1], CFG)

    def run():
        g = torch.Generator()
        g.manual_seed(3)
        return two_view.two_view_geometry(uv1, uv2, mask, pair[2], CFG, generator=g)

    off = run()
    timing.enable()
    on = run()
    timing.disable()
    recs = timing.records()
    (top,) = [r for r in recs if r.parent == -1]
    assert top.name == "two_view.geometry"
    assert _children(recs, top.index) == GEOMETRY
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_frontend_spans_in_order_and_results_unchanged(pair):
    off = frontend.extract_sift(pair[0], CFG.sift)
    timing.enable()
    on = frontend.extract_sift(pair[0], CFG.sift)
    timing.disable()
    recs = timing.records()
    (top,) = [r for r in recs if r.parent == -1]
    assert top.name == "sift.extract"
    assert _children(recs, top.index) == SIFT
    for a, b in zip([*off.keypoints, off.descriptors], [*on.keypoints, on.descriptors]):
        assert torch.equal(a, b)


def test_xla_route_detection_is_all_in_sift_detect(pair):
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=128, fused_detect=False)
    off = frontend.extract_sift(pair[0], cfg)
    timing.enable()
    on = frontend.extract_sift(pair[0], cfg)
    timing.disable()
    recs = timing.records()
    (top,) = [r for r in recs if r.parent == -1]
    assert _children(recs, top.index) == (["sift.chain"] + ["sift.detect"] * 3 + [
        "sift.atlas", "sift.sample", "sift.describe"])
    for a, b in zip([*off.keypoints, off.descriptors], [*on.keypoints, on.descriptors]):
        assert torch.equal(a, b)


def test_match_stage_spans(pair):
    s1, s2 = (frontend.extract_sift(im, CFG.sift) for im in pair[:2])
    timing.enable()
    two_view.match_stage(s1, s2, CFG)
    recs = timing.records()
    (top,) = [r for r in recs if r.parent == -1]
    assert top.name == "two_view.match_stage"
    assert _children(recs, top.index) == ["match.match", "match.compact"]
    (m,) = [r for r in recs if r.name == "match.match"]
    assert _children(recs, m.index) == ["match.top2", "match.ratio"]


def test_records_lie_inside_their_profiler_ranges(pair):
    frontend.extract_sift(pair[0], CFG.sift)     # warm
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            frontend.extract_sift(pair[0], CFG.sift)
    finally:
        gc.enable()
    recs = timing.records()
    names = {r.name for r in recs}
    assert names == set(SIFT) | {"sift.extract"}
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names and ev.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    for name in names:
        mine = sorted((r.t0_ns, r.t1_ns) for r in recs if r.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs)
        for (t0, t1), (s, e) in zip(mine, theirs):
            assert 0 <= t0 - s <= 100_000, (name, t0 - s)
            assert 0 <= e - t1 <= 100_000, (name, e - t1)


@pytest.fixture(scope="module")
def frames():
    from synthetic_sequence import synthetic_sequence

    seq = synthetic_sequence(144, 176, n_frames=4)
    return [torch.as_tensor(im) for im in seq["images"]], seq["K"]


def _sequence(frames, timer=None):
    images, K = frames
    return incremental.run_incremental(images, K, CFG, seed=2, ba_iters=2, local_ba_iters=1,
                                       closure_pairs=[(0, 3)], device="cpu", timer=timer)


def test_incremental_spans_nest_under_their_stages(frames):
    off = _sequence(frames)
    assert timing.records() == []
    timing.enable()
    on = _sequence(frames)
    timing.disable()
    recs = timing.records()
    (top,) = [r for r in recs if r.parent == -1]
    assert top.name == "incremental.run"
    assert set(_children(recs, top.index)) == STAGES

    def children(name):
        return [_children(recs, r.index) for r in recs if r.name == name]

    assert children("register") == [["pnp.bank", "pnp.lo", "register.tracks"]] * 2
    # One LM step after each of frames 2 and 3, then the 3 point-only steps.
    assert children("local_ba") == [LM, LM, LM * 3]
    assert children("global_ba") == [LM * 2 + ["global_ba.prune"] + LM * 5]
    for a, b in zip([*off.state, off.ba_costs, off.mean_reproj, off.kept],
                    [*on.state, on.ba_costs, on.mean_reproj, on.kept]):
        assert torch.equal(a, b)


def test_incremental_stage_times_keep_their_keys(frames):
    timer = timing.StageTimer()
    _sequence(frames, timer)
    assert set(timer.summary()) == STAGES
    assert timing.records() == []


def _rec(index, name, parent, t0, t1, syncs=0, launches=0):
    return timing.Record(index, name, parent, 0, int(t0 * 1e9), int(t1 * 1e9),
                         syncs, launches)


def test_program_spans_give_ops_and_gaps_to_the_innermost_span():
    t = 1_700_000_000.0
    recs = [_rec(0, "outer", -1, t + 1, t + 9, syncs=5, launches=1),
            _rec(1, "a", 0, t + 2, t + 4), _rec(2, "b", 1, t + 2.5, t + 3),
            _rec(3, "c", 0, t + 5, t + 8, syncs=2),
            _rec(4, "late", -1, t + 9.5, t + 11)]   # past the slice: left out
    ops = [("k0", t + 0.5, t + 0.6, ""), ("k1", t + 2.1, t + 2.2, ""),
           ("k2", t + 2.6, t + 2.7, ""), ("k3", t + 4.5, t + 4.6, ""),
           ("k4", t + 6.0, t + 7.5, "")]
    prof = Profile(ops, [], t, t + 10, 2)
    a = program_spans.attribute(prof, recs)
    names = [a.records[k][0].name if k >= 0 else None for k in a.op_span]
    assert names == [None, "a", "b", "outer", "c"]
    assert [op[0] for op in a.ops_in(("a",))] == ["k1", "k2"]
    assert [op[0] for op in a.ops_in(("outer",))] == ["k1", "k2", "k3", "k4"]
    assert [r.name for r in a.outermost()] == ["outer"]
    gaps = [(round(s - t, 3), round(n, 3), a.records[k][0].name if k >= 0 else None)
            for s, n, k in a.gaps]
    assert gaps == [(0.0, 0.5, None), (0.6, 1.5, None), (2.2, 0.4, "a"),
                    (2.7, 1.8, "b"), (4.6, 1.4, "outer"), (7.5, 2.5, "c")]
    assert [op[0] for op in a.ops_in(("c",))] == ["k4"]
    assert program_spans.attribute(prof, recs[-1:]) is None
    assert program_spans.attribute(None, recs) is None


def test_readers_read_none_without_the_program_spans(monkeypatch):
    t = 1_700_000_000.0

    class Run:
        profile = Profile([("k", t + 1, t + 2, "")], [], t, t + 3, 1)

    monkeypatch.delattr(timing, "records")
    monkeypatch.delattr(timing, "first_calls")
    assert program_spans.launches(Run, ("geometry.bank",)) is None
    assert program_spans.host_syncs(Run) is None
    assert program_spans.first_calls() == {}
