"""The readers of the program's own trace (``benchmark/spans.py``) on
synthetic device operations and host ranges: per-frame stage ms from the
marks, an idle gap split by the innermost of nested harness and program
ranges, None from a trace without marks; and a tiny cell's traced run on
the CPU, where the readers find nothing and the new metrics are absent."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import run, spans
from benchmark.tests.cells import tiny_root

SEED = 3_000_000_011
NEW = ("replay_contact_ms.realtime", "replay_solve_ms.realtime",
       "rollout_idle_ms.realtime", "capture_s")


def mark(stage, t):
    return (f"phyx_mark_{stage}", t, t + 1.0)


def frame_ops(t0, contact=100.0, solve=500.0, finish=50.0):
    """One frame's operations from ``t0`` us: its frame mark, then each
    stage's kernel followed by the stage's mark (1 us each), so that the
    prepare mark starts ``contact`` us after the frame mark and the solve
    mark ``solve`` us after that.  Returns (ops, the frame's end)."""
    ops, t = [mark("frame", t0)], t0 + 1.0
    for stage, us in (("integrate", 10.0), ("broadphase", 30.0),
                      ("narrowphase", 30.0), ("cache_join", 10.0),
                      ("prepare", contact - 80.0), ("solve", solve),
                      ("build_cache", finish)):
        ops.append((f"void kernel_of_{stage}", t, t + us - 1.0))
        ops.append(mark(stage, t + us - 1.0))
        t += us
    return ops, t


def test_mark_names():
    assert spans.mark_stage("phyx_mark_cache_join") == "cache_join"
    assert spans.mark_stage("void phyx::levels::level_solve<1>") is None


def test_marks_give_stage_ms_a_frame():
    ops, t = frame_ops(0.0, contact=100.0, solve=500.0)
    more, _ = frame_ops(t + 300.0, contact=120.0, solve=700.0)
    ops += more
    frames = spans.frames(ops)
    assert len(frames) == 2 and frames[1]["frame"] == t + 300.0
    contact = spans.stage_ms(ops, "frame", "prepare")
    solve = spans.stage_ms(ops, "prepare", "solve")
    assert contact == pytest.approx(0.110)
    assert solve == pytest.approx(0.600)
    assert spans.stage_ms(ops, "solve", "build_cache") == \
        pytest.approx(0.050)


def test_idle_inside_a_stage_is_not_its_time():
    """The device waits 300 us inside the broadphase (the host still
    launching the graph): the contact stage reads its busy time."""
    ops, _ = frame_ops(0.0, contact=100.0)
    late = [(n, s + 300.0, e + 300.0) if s >= 11.0 else (n, s, e)
            for n, s, e in ops]
    assert spans.frames(late)[0]["prepare"] == 399.0 + 1.0
    assert spans.stage_ms(late, "frame", "prepare") == pytest.approx(0.100)
    assert spans.stage_ms(late, "prepare", "solve") == pytest.approx(0.500)


def test_a_frame_cut_by_the_trace_is_left_out():
    ops, t = frame_ops(0.0)
    ops = ops[1:]                              # its frame mark is not traced
    whole, _ = frame_ops(t + 10.0, solve=800.0)
    assert spans.stage_ms(ops + whole, "prepare", "solve") == \
        pytest.approx(0.8)
    assert spans.stage_ms(whole[:3], "prepare", "solve") is None


def test_no_marks_no_reading():
    ops = [("void k", 0.0, 5.0), ("void k", 10.0, 20.0)]
    traced = SimpleNamespace(trace=dict(ops=ops),
                             window=SimpleNamespace(profiler=None))
    assert spans.frames(ops) == []
    assert spans.replay_contact_ms(traced) is None
    assert spans.replay_solve_ms(traced) is None
    assert spans.rollout_idle_ms(traced) is None
    assert spans.frame_span(ops) is None
    untraced = SimpleNamespace(trace=None, window=None)
    assert spans.replay_contact_ms(untraced) is None
    assert spans.rollout_idle_ms(untraced) is None


def test_idle_gaps_of_a_stretch():
    line = spans.Timeline([("a", 0.0, 10.0), ("b", 5.0, 12.0),
                           ("c", 20.0, 30.0), ("d", 35.0, 40.0)])
    assert line.gaps(0.0, 35.0) == [(12.0, 20.0), (30.0, 35.0)]
    assert line.gaps(8.0, 50.0) == [(12.0, 20.0), (30.0, 35.0), (40.0, 50.0)]
    # an operation that started before the stretch covers its start
    assert line.gaps(6.0, 25.0) == [(12.0, 20.0)]
    assert line.gaps(14.0, 18.0) == [(14.0, 18.0)]
    assert line.gaps(22.0, 28.0) == []


def test_a_gap_is_split_by_the_innermost_range():
    """A gap from 100 to 200 us under the harness's ``rollout`` (90-210),
    inside which the program's ``phyx.rollout`` (95-190) holds
    ``phyx.copy_in`` (110-130) and ``phyx.copy_out`` (150-170); then
    ``readback`` from 210 on and nothing between 200 and 210."""
    ops = [("k", 0.0, 100.0), ("k", 200.0, 300.0), ("k", 320.0, 330.0)]
    ranges = [("rollout", 90.0, 210.0), ("phyx.rollout", 95.0, 190.0),
              ("phyx.copy_in", 110.0, 130.0),
              ("phyx.copy_out", 150.0, 170.0),
              ("readback", 305.0, 315.0)]
    split = spans.idle_by_host(ops, ranges, 0.0, 330.0)
    assert split == pytest.approx({
        "phyx.rollout": 10.0 + 20.0 + 20.0, "phyx.copy_in": 20.0,
        "phyx.copy_out": 20.0, "rollout": 10.0, "readback": 10.0,
        "none": 10.0})
    assert sum(split.values()) == pytest.approx(100.0 + 20.0)


def test_rollout_idle_ms_counts_the_programs_spans_a_frame():
    """Three frames in the trace (two between the first and last frame
    marks); the profiler's start-up gap before the first mark is left
    out."""
    ops = [("startup", 0.0, 1.0)]
    t = 1000.0
    for _ in range(3):
        frame, end = frame_ops(t)
        ops += frame
        t = end + 400.0
    starts = [s for n, s, _ in ops if n == "phyx_mark_frame"]
    # between frames: 400 us idle, 100 under phyx.copy_in inside the
    # harness's rollout, the rest under readback
    ranges = []
    for s in starts[1:]:
        ranges += [("rollout", s - 150.0, s + 10.0),
                   ("phyx.rollout", s - 120.0, s + 5.0),
                   ("phyx.copy_in", s - 110.0, s - 10.0),
                   ("readback", s - 400.0, s - 150.0)]
    events = [SimpleNamespace(name=n, time_range=SimpleNamespace(
        start=s, end=e), device_type=torch.autograd.DeviceType.CPU)
        for n, s, e in ranges]
    traced = SimpleNamespace(trace=dict(ops=ops), window=SimpleNamespace(
        profiler=SimpleNamespace(events=lambda: events)))
    # a frame's idle under the program: phyx.rollout 20 (120 - 100 of its
    # child), phyx.copy_in 100
    assert spans.rollout_idle_ms(traced) == pytest.approx(0.120)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def test_traced_cpu_run_leaves_the_new_metrics_out(root):
    """On the CPU the trace has no device operation and no capture runs:
    each new metric is absent from the result, and the run raises
    nothing."""
    result, lines = run.run_cell(root, "tiny-realtime", SEED, 1.0, True,
                                 device="cpu")
    assert result["correct"], lines
    assert "contact_stage_ms.realtime" in result["metrics"]
    assert not set(NEW) & set(result["metrics"])
