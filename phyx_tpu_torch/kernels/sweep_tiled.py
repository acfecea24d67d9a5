"""K4, the slab-windowed sweep-and-prune: counterpart of
``phyx_tpu/kernels/sweep.py`` (``sweep_emit_tiled``), the mega-scene
broadphase's pair emission (``broadphase.broadphase_sap_tiled``).

The kernel is in ``csrc/sweep_tiled.cu`` (built with ``nvcc`` at first use,
``kernels/nvcc.py``, and called through ``ctypes``); in one launch it walks
each sweep once, stages the pairs of a tile of sweeps in shared memory,
finds the tile's first slot by a single-pass scan across blocks
(``csrc/onepass.cuh``) and writes them in order.

* ``sweep_emit_tiled`` is the wrapper: on CUDA tensors it launches the
  kernel (or raises); on CPU tensors it runs the plain version.
  ``tiled_pass`` is its launch, on buffers the caller gives.
* ``sweep_emit_tiled_plain`` computes the same buffer and counters as
  vectorized torch operations, one step of every open sweep at a time;
  ``sweep_emit_tiled_onepass_plain`` is the kernel's schedule (tiles of
  sweeps, their first slots from an exclusive scan over tiles, the stage
  and the second walk of the hits past it) on the same walk, equal to it.
  It runs on no card path.

What it computes (both): rows are the bodies sorted by (banded) min x and
padded to ``(n_slabs - 1) * slab_stride + window_rows`` rows.  Slab s
(base = s * slab_stride) starts a sweep at each row k < min(slab_stride,
nact - base), which walks the rows j = k+1, k+2, ... of the slab's window
while j < window_rows, base + j < nact and xlo[j] <= xhi[k], and emits the
body ids (order[k], order[j]) where the y-intervals overlap, dyn[k] +
dyn[j] > 0 and, with ``truex``, the true x-intervals overlap (tlo[j] <=
thi[k]).  Emissions are ordered (slab, k, j); the first ``max_pairs`` are
kept, the rest counted into ``ovf_drop``.  A walk that reached j =
window_rows while base + window_rows < nact and the window's last row is
still open counts into ``ovf_window``.

Layout: ``rows`` (4, npad) f32 [xlo, ylo, xhi, yhi], ``dyn`` and ``order``
(npad,) int32, ``nact`` () int32 on the device, ``truex`` (2, npad) f32
[tlo, thi] or None.  Returns (pi, pj) (max_pairs,) int32 — the kernel
writes only the slots below ``num`` — and ``num``, ``ovf_drop``,
``ovf_window``, () int32 on the device.

The wrapper keeps its latest call's counters (``COUNTERS``: the pairs
written, ``ovf_drop``, ``ovf_window``), (3,) int32 on the device, at
``sweep_emit_tiled.stats``: on the card the tensor the kernel writes, so a
call captured into a CUDA graph leaves there the graph's own buffer, which
each replay rewrites; on the CPU the plain version's three counters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import count_launch, nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import _check
from phyx_tpu_torch.kernels.sweep import (_launch, _require_cuda,
                                          _scan_scratch)
from phyx_tpu_torch.types import EMPTY

SOURCE = nvcc.CSRC / "sweep_tiled.cu"
TILE_SWEEPS = 256    # a tile: consecutive sweeps, a thread each
STAGE_PAIRS = 2048   # the pairs a tile stages in shared memory
# the sweep's counters, in the order of its stats tensor
COUNTERS = ("pairs", "ovf_drop", "ovf_window")


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    lib.phyx_sweep_tiled.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.phyx_sweep_tiled_tiles.argtypes = [ctypes.c_int]
    for fn in (lib.phyx_sweep_tiled, lib.phyx_sweep_tiled_tiles):
        fn.restype = ctypes.c_int
    return lib, report


def check_inputs(rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
                 window_rows, truex) -> int:
    """Checks the sweep's inputs (metadata only: nothing is read back).
    Returns npad."""
    device = rows.device
    npad = rows.shape[-1]
    _check("rows", rows, torch.float32, (4, npad), device)
    _check("dyn", dyn, torch.int32, (npad,), device)
    _check("order", order, torch.int32, (npad,), device)
    _check("nact", nact, torch.int32, (), device)
    if truex is not None:
        _check("truex", truex, torch.float32, (2, npad), device)
    if n_slabs < 1 or not 0 < slab_stride <= window_rows or max_pairs < 0:
        raise ValueError("need a slab, 0 < slab_stride <= window_rows and "
                         "max_pairs >= 0")
    if (n_slabs - 1) * slab_stride + window_rows > npad:
        raise ValueError(f"{n_slabs} windows of {window_rows} rows at "
                         f"stride {slab_stride} overrun {npad} rows")
    if window_rows >= 1 << 23:
        raise ValueError("window_rows must be below 2^23 (a hit's index "
                         "in its walk is kept in 24 bits)")
    return npad


def sweep_emit_tiled(
    rows: torch.Tensor,      # (4, npad) f32 [xlo, ylo, xhi, yhi], x-sorted
    dyn: torch.Tensor,       # (npad,) int32 1 = dynamic
    order: torch.Tensor,     # (npad,) int32 body id per row
    nact: torch.Tensor,      # () int32 rows that start sweeps, on the device
    max_pairs: int,
    n_slabs: int,
    slab_stride: int,
    window_rows: int,
    truex: Optional[torch.Tensor] = None,   # (2, npad) f32 true [xlo, xhi]
):
    """K4.  Returns (pi, pj, num, ovf_drop, ovf_window) — see the module
    docstring.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.  ``sweep_emit_tiled.launches`` counts kernel launches (one a
    call), ``sweep_emit_tiled.stats`` holds the latest call's counters
    (``COUNTERS``, on the device)."""
    args = (rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
            window_rows, truex)
    check_inputs(*args)
    device = rows.device
    if device.type == "cpu":
        out = sweep_emit_tiled_plain(*args)
        sweep_emit_tiled.stats = torch.stack(out[2:])
        return out
    _require_cuda(device)
    i32 = dict(dtype=torch.int32, device=device)
    pi, pj = (torch.empty((max_pairs,), **i32) for _ in range(2))
    counters = torch.empty((len(COUNTERS),), **i32)
    tiled_pass(*args, pi, pj, counters)
    sweep_emit_tiled.stats = counters
    count_launch(sweep_emit_tiled)
    return pi, pj, counters[0], counters[1], counters[2]


sweep_emit_tiled.launches = 0
sweep_emit_tiled.stats = None
sweep_emit_tiled.counter_names = COUNTERS


def tiled_pass(rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
               window_rows, truex, pi, pj, counters) -> None:
    """K4's one launch, on the current stream, into the buffers given:
    ``pi``, ``pj`` (max_pairs,) int32 at the slots below num, ``counters``
    (3,) int32 [num, ovf_drop, ovf_window].  Raises if the launch was
    refused."""
    lib = build()[0]
    ntiles = lib.phyx_sweep_tiled_tiles(n_slabs * slab_stride)
    scratch = _scan_scratch("K4", rows.device, ntiles,
                            ((torch.int32, ntiles),))
    _launch(lib.phyx_sweep_tiled, rows, truex, dyn, order, nact, *scratch,
            pi, pj, counters, rows.shape[-1], slab_stride, window_rows,
            n_slabs, max_pairs)


def _tiled_walk(rows, dyn, nact, n_slabs: int, K: int, W: int, truex):
    """Every sweep's walk (see the module docstring), all open sweeps one
    candidate a step, a sweep leaving the set at its first closed
    candidate.  Returns the hits of each step d = 1, 2, ... as (d, their
    sweeps ascending), and the count of walks still open at their window
    end, (), int32.  It reads ``nact`` and the open set back to the
    host."""
    device = rows.device
    na = int(nact)
    xlo, ylo, xhi, yhi = rows
    sweep = torch.arange(n_slabs * K, device=device)   # its row, too
    k = sweep % K
    walking = sweep[k < na - (sweep - k)]               # the starters
    steps, at_end = [], []
    for d in range(1, W):
        # candidate row q = base + k + d = walking + d
        walking = walking[(walking % K + d < W) & (walking + d < na)]
        q = walking + d
        still = xlo[q] <= xhi[walking]
        walking, q = walking[still], q[still]
        if walking.numel() == 0:
            break
        at_end.append(walking[walking % K + d == W - 1])
        ok = ((ylo[q] <= yhi[walking]) & (ylo[walking] <= yhi[q])
              & (dyn[walking] + dyn[q] > 0))
        if truex is not None:
            ok &= truex[0][q] <= truex[1][walking]
        steps.append((d, walking[ok]))
    # walks still open at j = W: rows left past the window, whose last row
    # is open for them
    ended = torch.cat(at_end) if at_end else sweep[:0]
    base = ended - ended % K
    still_open = ((base + W < na)
                  & (xlo[base + W - 1] <= xhi[ended])).sum(dtype=torch.int32)
    return steps, still_open


def _count(x, device):
    return torch.full((), x, dtype=torch.int32, device=device)


def sweep_emit_tiled_plain(rows, dyn, order, nact, max_pairs: int,
                           n_slabs: int, slab_stride: int, window_rows: int,
                           truex=None):
    """K4's plain version (see the module docstring): every open sweep
    takes its next candidate at once, a sweep leaving the set at its first
    closed candidate; the hits, keyed (sweep, offset), are ordered by one
    sort and cut at ``max_pairs``.  It reads ``nact`` and the open set back
    to the host: for tests and comparison with the kernel.  Slots past
    ``num`` hold EMPTY."""
    device = rows.device
    W = window_rows
    steps, still_open = _tiled_walk(rows, dyn, nact, n_slabs, slab_stride,
                                    W, truex)
    key = torch.sort(torch.cat([sw * W + d for d, sw in steps])
                     if steps else order[:0].long()).values
    total = key.numel()
    key = key[:max_pairs]
    first = torch.div(key, W, rounding_mode="floor")
    pi = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pj = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pi[:key.numel()] = order[first]
    pj[:key.numel()] = order[first + key % W]
    num = min(total, max_pairs)
    return (pi, pj, _count(num, device), _count(total - num, device),
            still_open)


def sweep_emit_tiled_onepass_plain(rows, dyn, order, nact, max_pairs: int,
                                   n_slabs: int, slab_stride: int,
                                   window_rows: int, truex=None,
                                   tile: int = TILE_SWEEPS,
                                   stage: int = STAGE_PAIRS):
    """K4's one-pass schedule in torch (``csrc/sweep_tiled.cu``) on the
    plain version's walk: tiles of ``tile`` consecutive sweeps; a sweep's
    count, its offset in its tile (an exclusive scan in sweep order), the
    tile's first slot (an exclusive scan over the tiles' counts); each hit
    at its tile's first slot plus its sweep's offset plus h, its index in
    the sweep's walk.  A tile stages its first ``stage`` hits (here in walk
    step order; the kernel's atomic order differs, and in either each
    sweep's staged hits are a prefix of its walk); the rest come from the
    second walk of their sweeps.  Slots below ``max_pairs`` get the pair,
    the rest EMPTY.  Returns (pi, pj, num, ovf_drop, ovf_window, the number
    of tiles that walked again).  Equal to ``sweep_emit_tiled_plain``; for
    tests."""
    device = rows.device
    steps, still_open = _tiled_walk(rows, dyn, nact, n_slabs, slab_stride,
                                    window_rows, truex)
    n_sweeps = n_slabs * slab_stride
    ntiles = -(-n_sweeps // tile)
    none = order[:0].long()
    sw = torch.cat([x for _, x in steps]) if steps else none   # step order
    cand = torch.cat([x + d for d, x in steps]) if steps else none
    counts = torch.bincount(sw, minlength=n_sweeps)
    before = torch.cumsum(counts, 0) - counts
    # h: a hit's index in its sweep's walk (steps come in walk order)
    srt = torch.argsort(sw, stable=True)
    h = torch.empty_like(srt)
    h[srt] = torch.arange(srt.numel(), device=device)
    h = h - before[sw]
    tiles = torch.arange(n_sweeps, device=device) // tile
    agg = torch.zeros((ntiles,), dtype=torch.int64, device=device)
    agg.index_add_(0, tiles, counts)
    tile_first = torch.cumsum(agg, 0) - agg
    off = before - before[tiles * tile]
    # the stage: a tile's hits in step order, the first ``stage`` kept
    t = tiles[sw]
    srt = torch.argsort(t, stable=True)
    fill = torch.empty_like(srt)
    fill[srt] = torch.arange(srt.numel(), device=device)
    fill = fill - (torch.cumsum(agg, 0) - agg)[t]
    staged = fill < stage
    again = int(torch.unique(t[~staged]).numel())
    slot = tile_first[t] + off[sw] + h
    total = sw.numel()
    keep = slot < max_pairs
    pi = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pj = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pi[slot[keep]] = order[sw[keep]]
    pj[slot[keep]] = order[cand[keep]]
    num = min(total, max_pairs)
    return (pi, pj, _count(num, device), _count(total - num, device),
            still_open, again)
