"""The stage marks and host spans on the card (``phyx_tpu_torch/tracing.py``):
a replayed frame with its marks equal to the bit to one without, the table
of the latest frame against a profiler trace of the same frame, and the
spans leaving no device-side operation in the benchmark's reduction.

Run on a machine with a CUDA device (this file imports no JAX, so the
test directory's ``conftest.py``, which does, is left out):

    python -m pytest --noconftest -m card -q tests/test_torch_tracing_card.py

Elsewhere each test skips."""

import pytest
import torch

from phyx_tpu_torch import bench, tracing
from phyx_tpu_torch.step import (_leaves, release_graphs, rollout,
                                  run_frames, step)

pytestmark = pytest.mark.card

BOXES = 4000


@pytest.fixture(scope="module")
def settled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, st = bench.build("pile", BOXES, "pallas", "sap_grid", 192)
    st = rollout(st, cfg, 40)
    torch.cuda.synchronize()
    yield cfg, st
    release_graphs()


def assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                           y.contiguous().reshape(-1).view(torch.uint8))


def test_replayed_frame_with_marks_is_bit_equal(settled):
    """Two replayed frames (marks captured in the graph) equal two
    uncaptured ``step``s with no marks and two replays of a frame captured
    without marks, to the bit."""
    cfg, st = settled
    quiet = lambda s: step(s, cfg, mark=lambda stage: None)  # noqa: E731
    rollout(st, cfg, 2)                      # the graph is held
    marked = rollout(st, cfg, 2)
    plain = quiet(quiet(st))
    key = (cfg, st.bodies.pos.device, "no marks")
    run_frames(st, key, quiet, 2)            # captured here
    unmarked = run_frames(st, key, quiet, 2)
    release_graphs(cfg)
    assert_bit_equal(marked, plain)
    assert_bit_equal(marked, unmarked)


@pytest.fixture(scope="module")
def traced(settled):
    """One torch.profiler session (a second session in a process has
    shown no device events on the card) over three calls of one replayed
    frame, each under the harness's labels ``rollout`` and ``readback``:
    (the profiler's events, ``last_frame_ms`` after the last call)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cfg, st = settled
    rollout(st, cfg, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with record_function("rollout"):
                out = rollout(st, cfg, 1)
            with record_function("readback"):
                out.bodies.pos.cpu()
        torch.cuda.synchronize()
    return prof.events(), tracing.last_frame_ms()


def test_last_frame_agrees_with_the_trace(traced):
    """``last_frame_ms`` of the last replayed frame against its mark
    kernels' start times in the trace: the contact stage (frame to
    prepare), the solve (prepare to solve) and the whole frame within
    2 %; every stage in the trace's order."""
    events, table = traced
    starts = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith(tracing.MARK_PREFIX)):
            starts[e.name[len(tracing.MARK_PREFIX):]] = e.time_range.start
    print({"last_frame_ms": table, "trace_mark_us": starts})
    order = [s for s in sorted(starts, key=starts.get) if s != "frame"]
    assert list(table) == order
    stages = list(tracing.MARKS)
    for a, b in (("frame", "prepare"), ("prepare", "solve"),
                 ("frame", "build_cache")):
        traced_ms = (starts[b] - starts[a]) / 1e3
        marked = sum(table[s] for s in stages[stages.index(a) + 1:
                                              stages.index(b) + 1]
                     if s in table)
        assert marked == pytest.approx(traced_ms, rel=0.02), (a, b)


def test_spans_leave_no_device_operation(traced):
    """The spans are host ranges of the FUNCTION scope:
    ``benchmark/trace.reduce_events`` finds no operation named ``phyx.``,
    and the trace holds each span and each mark kernel."""
    from benchmark.trace import reduce_events
    events, _ = traced
    reduced = reduce_events(events)
    assert not [op for op in reduced["ops"] if op[0].startswith("phyx.")]
    names = {e.name for e in events}
    spans = {e.name: str(e.scope) for e in events
             if e.name.startswith(tracing.SPAN_PREFIX)}
    print({"spans": spans, "device_side": sorted(
        {e.name for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.name.startswith(("void", "Memcpy", "Memset"))})[:40]})
    assert {"phyx.rollout", "phyx.copy_in", "phyx.replay",
            "phyx.copy_out"} <= set(spans)
    assert {tracing.MARK_PREFIX + s for s in tracing.MARKS
            if s != "joint_prepare"} <= names
