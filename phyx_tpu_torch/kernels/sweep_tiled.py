"""K4, the slab-windowed sweep-and-prune: counterpart of
``phyx_tpu/kernels/sweep.py`` (``sweep_emit_tiled``), the mega-scene
broadphase's pair emission (``broadphase.broadphase_sap_tiled``).

The kernel is in ``csrc/sweep_tiled.cu`` (built with ``nvcc`` at first use,
``kernels/nvcc.py``, and called through ``ctypes``); it counts each sweep's
emissions, takes their prefix sum on the device and writes them in order.

* ``sweep_emit_tiled`` is the wrapper: on CUDA tensors it launches the
  kernel (or raises); on CPU tensors it runs the plain version.
  ``count_pass`` and ``emit_pass`` are its two launches, on buffers the
  caller gives.
* ``sweep_emit_tiled_plain`` computes the same buffer and counters as
  vectorized torch operations, one step of every open sweep at a time.

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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import _check
from phyx_tpu_torch.kernels.sweep import _counters, _launch, _require_cuda
from phyx_tpu_torch.types import EMPTY

SOURCE = nvcc.CSRC / "sweep_tiled.cu"


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    lib.phyx_sweep_tiled_count.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.phyx_sweep_tiled_emit.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    for fn in (lib.phyx_sweep_tiled_count, lib.phyx_sweep_tiled_emit):
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
    call: the count and the emit pass)."""
    args = (rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
            window_rows, truex)
    check_inputs(*args)
    device = rows.device
    if device.type == "cpu":
        return sweep_emit_tiled_plain(*args)
    _require_cuda(device)
    counts = torch.empty((n_slabs * slab_stride,), dtype=torch.int32,
                         device=device)
    ovf_window = torch.zeros((1,), dtype=torch.int32, device=device)
    pi = torch.empty((max_pairs,), dtype=torch.int32, device=device)
    pj = torch.empty((max_pairs,), dtype=torch.int32, device=device)
    count_pass(*args, counts, ovf_window)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    emit_pass(*args, counts, ends, pi, pj)
    sweep_emit_tiled.launches += 1
    return (pi, pj) + _counters(ends[-1], max_pairs) + (ovf_window[0],)


sweep_emit_tiled.launches = 0


def count_pass(rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
               window_rows, truex, counts, ovf_window) -> None:
    """K4's first launch, on the current stream: each sweep's accepted
    candidates into ``counts`` (n_slabs * slab_stride,) int32, and the
    walks that overran their window added to ``ovf_window`` (1,) int32.
    Raises if the launch was refused.  (The wrapper's part; called alone
    only to time it.)"""
    _launch(build()[0].phyx_sweep_tiled_count, rows, truex, dyn, order, nact,
            counts, ovf_window, rows.shape[-1], slab_stride, window_rows,
            n_slabs)


def emit_pass(rows, dyn, order, nact, max_pairs, n_slabs, slab_stride,
              window_rows, truex, counts, ends, pi, pj) -> None:
    """K4's second launch, on the current stream: each sweep walks again
    and writes its pairs from the slot ``ends - counts`` ((n_sweeps,) int64
    inclusive prefix sum of ``counts``) while below ``max_pairs``.  Raises
    if the launch was refused."""
    _launch(build()[0].phyx_sweep_tiled_emit, rows, truex, dyn, order, nact,
            counts, ends, pi, pj, rows.shape[-1], slab_stride, window_rows,
            n_slabs, max_pairs)


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
    K, W = slab_stride, window_rows
    na = int(nact)
    xlo, ylo, xhi, yhi = rows
    sweep = torch.arange(n_slabs * K, device=device)   # its row, too
    k = sweep % K
    walking = sweep[k < na - (sweep - k)]               # the starters
    hits, at_end = [], []
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
        hits.append(walking[ok] * W + d)
    key = torch.sort(torch.cat(hits) if hits else sweep[:0]).values
    total = key.numel()
    key = key[:max_pairs]
    first = torch.div(key, W, rounding_mode="floor")
    pi = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pj = torch.full((max_pairs,), EMPTY, dtype=torch.int32, device=device)
    pi[:key.numel()] = order[first]
    pj[:key.numel()] = order[first + key % W]
    # walks still open at j = W: rows left past the window, whose last row
    # is open for them
    ended = torch.cat(at_end) if at_end else sweep[:0]
    base = ended - ended % K
    still_open = ((base + W < na)
                  & (xlo[base + W - 1] <= xhi[ended])).sum(dtype=torch.int32)

    def count(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    num = min(total, max_pairs)
    return pi, pj, count(num), count(total - num), still_open
