"""Tracing inside the port on the CPU (``phyx_tpu_torch/tracing.py``): host
spans nested, timed and, under torch.profiler, FUNCTION-scope ranges named
``phyx.<name>`` (none without a session); the stage marks' table of the
latest frame; a frame equal to the bit with and without its marks; a hook
passed to ``step`` replacing them; the marks' names against the stages and
the CUDA source; the ``build`` span around ``nvcc``.  The card's side is
``tests/test_torch_tracing_card.py``."""

import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phyx_tpu_torch import scenes, tracing
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels import nvcc
from phyx_tpu_torch.profiling import STAGES, STAGES_JOINTS
from phyx_tpu_torch.step import _leaves, rollout, step

torch.set_num_threads(1)

PILE = SimConfig(max_bodies=64, max_pairs=256, broadphase="n2",
                 solver_backend="pallas")
CHAIN = SimConfig(max_bodies=64, max_pairs=256, max_joints=8,
                  broadphase="n2", solver_backend="pallas")
FUNCTION_SCOPE = 0   # torch's RecordScope.FUNCTION, an aten op's scope


def scene(kind):
    if kind == "pile":
        return PILE, scenes.pile(PILE, 12, seed=3).build("cpu")
    return CHAIN, scenes.chain(CHAIN, 3).build("cpu")


def assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert (x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                == y.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())


@pytest.fixture(autouse=True)
def fresh_totals():
    tracing.reset_totals()
    yield
    tracing.reset_totals()


# --- host spans ----------------------------------------------------------------

def test_spans_nest_in_a_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(3).add_(1.0)
    ev = {e.name: e for e in prof.events() if e.name.startswith("phyx.")}
    assert set(ev) == {"phyx.outer", "phyx.inner"}
    assert all(int(e.scope) == FUNCTION_SCOPE for e in ev.values())
    assert ev["phyx.inner"].cpu_parent.name == "phyx.outer"
    inner, outer = ev["phyx.inner"].time_range, ev["phyx.outer"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


@pytest.mark.parametrize("repeats", [1, 3])
def test_totals_count_and_time_spans(repeats):
    """Each span's count, host seconds and self seconds (less the spans
    inside it)."""
    for _ in range(repeats):
        with tracing.span("outer"):
            time.sleep(0.002)
            with tracing.span("inner"):
                time.sleep(0.004)
    t = tracing.totals()
    assert set(t) == {"outer", "inner"}
    assert t["outer"]["count"] == t["inner"]["count"] == repeats
    assert t["inner"]["s"] >= 0.004 * repeats
    assert t["inner"]["self_s"] == t["inner"]["s"]
    assert t["outer"]["s"] >= t["inner"]["s"] + 0.002 * repeats
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["s"] - t["inner"]["s"], abs=1e-9)


def test_a_span_that_raises_is_closed():
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("fault")
    with tracing.span("after"):
        pass
    t = tracing.totals()
    assert t["inner"]["count"] == t["outer"]["count"] == 1
    # "after" opened at the top: nothing of it was charged to "outer"
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["s"] - t["inner"]["s"], abs=1e-9)
    assert t["after"]["self_s"] == t["after"]["s"]


class _Recorder:
    """Stands for the profiler's range: records the names it opens."""
    opened = []

    def __init__(self, name):
        _Recorder.opened.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(tracing, "_RANGE", _Recorder)
    _Recorder.opened = []
    with tracing.span("quiet"):
        pass
    assert _Recorder.opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("heard"):
            pass
    assert _Recorder.opened == ["phyx.heard"]
    assert tracing.totals()["quiet"]["count"] == 1


def test_rollout_span_holds_the_frames():
    cfg, st = scene("pile")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rollout(st, cfg, 2)
    assert tracing.totals()["rollout"]["count"] == 1
    rng = next(e for e in prof.events() if e.name == "phyx.rollout")
    inside = [e for e in prof.events() if e.name.startswith("aten::")
              and rng.time_range.start <= e.time_range.start
              and e.time_range.end <= rng.time_range.end]
    assert inside
    # no span opens inside the frames
    assert {e.name for e in prof.events()
            if e.name.startswith("phyx.")} == {"phyx.rollout"}


def test_build_span_wraps_the_nvcc_runs(monkeypatch, tmp_path):
    """``compile_all`` opens ``build`` only where a library is missing, and
    the span's seconds leave the self seconds of a span around it."""
    ran = []

    def fake_nvcc(missing):
        ran.append([s.name for s, _ in missing])
        time.sleep(0.003)
        return {}

    monkeypatch.setattr(nvcc, "_run_nvcc", fake_nvcc)
    source = tracing.SOURCE
    monkeypatch.setattr(nvcc, "library_path",
                        lambda s: tmp_path / f"{s.name}.so")
    with tracing.span("capture"):
        nvcc.compile_all([source])
    (tmp_path / f"{source.name}.so").write_bytes(b"")
    nvcc.compile_all([source])
    t = tracing.totals()
    assert ran == [[source.name]]
    assert t["build"]["count"] == 1 and t["build"]["s"] >= 0.003
    assert t["capture"]["self_s"] == pytest.approx(
        t["capture"]["s"] - t["build"]["s"], abs=1e-9)


# --- stage marks ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pile", "chain"])
def test_last_frame_ms_after_a_cpu_step(kind):
    cfg, st = scene(kind)
    step(st, cfg)
    table = tracing.last_frame_ms("cpu")
    assert list(table) == (STAGES_JOINTS if kind == "chain" else STAGES)
    assert all(isinstance(v, float) and v >= 0.0 for v in table.values())


@pytest.mark.parametrize("kind", ["pile", "chain"])
def test_marks_leave_the_frame_bit_equal(kind):
    """A CPU ``rollout`` (frames with their marks) equals a loop of
    ``step`` with a hook that marks nothing, to the bit."""
    cfg, st = scene(kind)
    marked = rollout(st, cfg, 3)
    plain = st
    for _ in range(3):
        plain = step(plain, cfg, mark=lambda stage: None)
    assert_bit_equal(marked, plain)


def test_a_hook_replaces_the_marks():
    """A hook passed to ``step`` sees the stages (no "frame") and the
    table keeps the frame before."""
    cfg, st = scene("pile")
    step(st, cfg)
    before = tracing.last_frame_ms("cpu")
    seen = []
    step(st, cfg, seen.append)
    assert seen == STAGES
    assert tracing.last_frame_ms("cpu") == before


def test_the_frame_mark_clears_the_table():
    mark = tracing.stage_marks("cpu")
    assert mark is tracing.stage_marks(torch.device("cpu"))
    mark("frame")
    mark("integrate")
    assert list(tracing.last_frame_ms("cpu")) == ["integrate"]
    mark("frame")
    assert tracing.last_frame_ms("cpu") == {}
    with pytest.raises(KeyError):
        mark("no such stage")


def test_no_table_no_frame():
    assert tracing.last_frame_ms("meta") == {}


def test_marks_match_the_stages_and_the_source():
    """``MARKS`` is "frame" then the stages in ``step``'s order; the CUDA
    source numbers its slots alike and names a kernel after each; no name
    holds what the benchmark's solve-kernel reader looks for."""
    assert tracing.MARKS == ("frame",) + tuple(STAGES_JOINTS)
    text = tracing.SOURCE.read_text()
    enum = re.search(r"enum \{([^}]*)\}", text).group(1)
    slots = [w.strip() for w in enum.split(",")]
    assert slots == [m.upper() for m in tracing.MARKS] + ["N_MARKS"]
    for stage in tracing.MARKS:
        name = tracing.MARK_PREFIX + stage
        assert re.search(rf"\b{name}\b", text), name
        assert "visit_levels" not in name and "level_solve" not in name

