"""Tracing inside the port: stage marks in every frame, host spans around
the calls that run frames.

**Stage marks.**  ``step`` marks its frame's start ("frame") and the end of
each stage (``MARKS``) through its ``mark`` hook, whose default is
``stage_marks(device)``.  On the card a mark launches one thread on the
current stream (``csrc/trace_marks.cu``, a kernel a stage named
``phyx_mark_<stage>``), so a frame captured into ``rollout``'s CUDA graph
carries its marks into every replay: a profiler trace splits the replayed
frame by stage on its own device clock, and each mark writes the device's
``%globaltimer`` into a small table of the latest frame, which
``last_frame_ms`` reads with no profiler.  On the CPU a mark writes
``time.perf_counter()`` into the same table.  The marks read nothing of
the frame and write nothing else: a frame is equal to the bit with and
without them.  A hook passed to ``step`` (``profiling.stage_times``')
replaces them.

**Host spans.**  ``span(name)`` adds its count, host seconds and self
seconds (its seconds less its child spans') to an always-on table
(``totals``), and while a torch.profiler session is active it opens a
range named ``phyx.<name>`` of the profiler's FUNCTION scope, the scope of
an aten operation: the span lands on the profiler's host timeline, on the
clock of its device trace, and the profiler lays no device-side copy of it
over the work it launched (as it does for a ``record_function`` range).
The port's spans, nested where they are opened:

* ``rollout``: ``step.run_frames`` (``rollout`` and the stacked states'
  frames), holding
* ``copy_in``: ``step.graph_for``'s signature check and, where a graph is
  held for the state's layout, the copy of the state into its buffers;
* ``capture``: a frame captured (``graph_for`` finding none): the warm-up
  frame and the capture, holding any ``build``;
* ``replay``: the loop of graph replays;
* ``copy_out``: the copy of the output;
* ``build``: ``kernels/nvcc.compile_all``'s runs of ``nvcc``.

    from phyx_tpu_torch import tracing
    st = rollout(st, cfg, 10)
    tracing.last_frame_ms()   # {"integrate": ..., ..., "build_cache": ...}
    tracing.totals()          # {"rollout": {"count", "s", "self_s"}, ...}

The tables are the process's: one a device for the marks, one for the
spans (``reset_totals`` empties it).

**Kernel counters.**  The level-scheduled solves (K1, K3, K5) and the
mega-scene sweep (K4) keep each call's counters in device memory, the
latest call's at ``<wrapper>.stats``, named by ``<wrapper>.counter_names``
(a frame captured into a graph rewrites its call's at every replay):
``solve_counters`` reads them.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
import time

import torch

# the marks of a frame, in their order in ``step``; ``csrc/trace_marks.cu``
# numbers its slots alike
MARKS = ("frame", "integrate", "broadphase", "narrowphase", "cache_join",
         "prepare", "joint_prepare", "solve", "build_cache")
_SLOT = {stage: k for k, stage in enumerate(MARKS)}
# the device kernels' names and the profiler ranges' names start so
MARK_PREFIX = "phyx_mark_"
SPAN_PREFIX = "phyx."
SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "trace_marks.cu"

# the profiler's range of the FUNCTION scope
_RANGE = torch._C._profiler._RecordFunctionFast

# device -> the latest frame's table (an int64 tensor of ns on the card, a
# list of perf_counter seconds on the host) and its mark hook
_TABLES: dict = {}
_MARKERS: dict = {}
# span name -> [count, seconds, self seconds]
_TOTALS: dict = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the marks (once per source hash) and load them.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    from phyx_tpu_torch.kernels import nvcc
    lib, report = nvcc.load(SOURCE)
    lib.phyx_stage_mark.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.phyx_stage_mark.restype = ctypes.c_int
    return lib, report


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


def _host_marker(dev):
    table = _TABLES[dev] = [None] * len(MARKS)

    def mark(stage: str) -> None:
        slot = _SLOT[stage]
        if slot == 0:
            table[1:] = [None] * (len(MARKS) - 1)
        table[slot] = time.perf_counter()

    return mark


def _cuda_marker(dev):
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a device's stage marks are made outside a CUDA "
                           "graph capture: run one frame uncaptured first")
    fn = build()[0].phyx_stage_mark
    table = _TABLES[dev] = torch.zeros((len(MARKS),), dtype=torch.int64,
                                       device=dev)
    ptr = table.data_ptr()

    def mark(stage: str) -> None:
        with torch.cuda.device(dev):
            err = fn(_SLOT[stage], ptr, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"phyx_mark_{stage} launch failed: CUDA error "
                               f"{err}")

    return mark


def stage_marks(device):
    """``step``'s default mark hook on ``device``: ``mark(stage)`` for a
    stage of ``MARKS`` writes the time into the device's table of the
    latest frame ("frame" clears the table first).  On the card the table
    is made, and the marks built, at the first call, which must not be
    inside a CUDA graph capture."""
    dev = _device(device)
    marker = _MARKERS.get(dev)
    if marker is None:
        marker = _MARKERS[dev] = (_cuda_marker(dev) if dev.type == "cuda"
                                  else _host_marker(dev))
    return marker


def last_frame_ms(device="cuda") -> dict:
    """{stage: ms} of the latest frame marked on ``device``: each stage
    marked since the frame's start, in the order the marks ran, the time
    from the mark before it (the frame's start for the first).  On the
    card one read of the table, which waits for the current stream; the
    times are the device's.  Empty where no frame was marked."""
    dev = _device(device)
    table = _TABLES.get(dev)
    if table is None:
        return {}
    if torch.is_tensor(table):
        values = [v or None for v in table.tolist()]
        scale = 1e-6
    else:
        values, scale = list(table), 1e3
    start = values[0]
    if start is None:
        return {}
    out, prev = {}, start
    for t, slot in sorted((t, k) for k, t in enumerate(values)
                          if k and t is not None):
        out[MARKS[slot]] = (t - prev) * scale
        prev = t
    return out


class _Span:
    __slots__ = ("name", "t0", "inner", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = _RANGE(SPAN_PREFIX + self.name)
            self.range.__enter__()
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].inner += seconds
        with _LOCK:
            row = _TOTALS.setdefault(self.name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += seconds
            row[2] += seconds - self.inner
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A context manager: the host span ``name`` (see the module's
    docstring)."""
    return _Span(name)


def totals() -> dict:
    """{span name: {"count", "s", "self_s"}} of every span closed in the
    process since the last ``reset_totals``: how many, their host seconds,
    and their seconds less those of the spans opened inside them."""
    with _LOCK:
        return {name: dict(count=row[0], s=row[1], self_s=row[2])
                for name, row in _TOTALS.items()}


def reset_totals() -> None:
    with _LOCK:
        _TOTALS.clear()


def solve_counters() -> dict:
    """{kernel: {counter: value}} of the latest call of each kernel that
    keeps counters, under the wrapper's own names: for the level-scheduled
    solves launched on the card (K1, K3, K5) "levels", "visits",
    "freed_visits", "fallbacks" (levels a pass, visits a pass, visits with
    a free endpoint, and whether the rerun over the full graph ran,
    ``csrc/levels.cuh``); for the mega-scene sweep (K4, on the card or its
    plain version) "pairs", "ovf_drop", "ovf_window" (pairs written, pairs
    past the budget, walks cut by their window).  One read of each
    kernel's counters, which waits for its stream; empty where none ran."""
    from phyx_tpu_torch.kernels import wrappers
    out = {}
    for name, wrapper in wrappers().items():
        stats = getattr(wrapper, "stats", None)
        if stats is not None:
            out[name] = dict(zip(wrapper.counter_names, stats.tolist()))
    return out
