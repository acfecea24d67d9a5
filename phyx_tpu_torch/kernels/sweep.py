"""K6 and K7, the sweep-and-prune pair emission: counterparts of
``phyx_tpu/kernels/sweep.py`` (``sweep_emit_v2`` and ``sweep_emit``), the
kernels of ``broadphase.broadphase_sap_kernel``.  K4, the slab-windowed
sweep of the same reference module, is in ``kernels/sweep_tiled.py``.

The kernels are in ``csrc/sweep_emit.cu`` (built with ``nvcc`` at first
use, ``kernels/nvcc.py``, and called through ``ctypes``).  Each counts,
scans and writes in one launch: K6 over tiles of its cells with a
single-pass scan across blocks (``csrc/onepass.cuh``), K7 in one block, a
warp a sorted row.

* ``sweep_emit_v2`` (K6) and ``sweep_emit`` (K7) are the wrappers: on CUDA
  tensors they launch the kernel (or raise); on CPU tensors they run the
  plain version.  ``chunked_pass`` and ``warp_pass`` are their launches on
  buffers the caller gives.
* ``sweep_emit_v2_plain`` and ``sweep_emit_plain`` compute the same buffer
  and counters as vectorized torch operations; ``sweep_emit_warp_plain`` is
  K7's schedule (32-lane batches with their x-open and hit masks, each
  hit's slot from its row's first slot and its rank in the batch) in torch,
  equal to ``sweep_emit_plain``; ``sweep_emit_v2_onepass_plain`` is K6's
  (tiles, 32-candidate batches, the sorted proof and its short walk, slots
  from an exclusive scan over tiles and j-descending ranks), equal to
  ``sweep_emit_v2_plain``.  The schedules' versions run on no card path.

What they compute: bodies sorted by AABB min x, the active ones (``nact``)
first.  Source row k tests the rows j > k below ``nact`` and emits the body
ids ``(min, max)`` of each j with xlo[j] <= xhi[k], overlapping y-intervals
and dyn[k] + dyn[j] > 0.  The first ``max_pairs`` emissions are kept, the
rest counted into ``ovf``; slots from ``num`` on hold EMPTY.  The order of
the emissions decides which survive a full buffer, and it differs:

* K7: row si walks sj = si+1, ... while sj < nact and the candidate's lox
  <= its hix: (si, sj) order.  ``aabb_flat`` and ``dyn`` by body id.
* K6: over 1024-row chunks, source chunk s against target chunks t = s,
  s+1, ... while t's first row is below nact and starts at or before the
  largest hix of chunk s; row k tests chunk t where k < nact and t's first
  lox <= xhi[k]; (s, t, k, j descending) order.  ``aabb_flat`` and ``dyn``
  sorted; the capacity a multiple of 1024.

Layout: ``aabb_flat`` (4 N,) f32 [lox, loy, hix, hiy] a row, ``order`` (N,)
int32 sorted row -> body id, ``dyn`` (N,) int32 1 = dynamic, ``nact`` ()
int32 on the device.  Returns (pi, pj) (max_pairs,) int32 and ``num``,
``ovf`` () int32 on the device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from phyx_tpu_torch.kernels import count_launch, nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import _check
from phyx_tpu_torch.types import EMPTY

SOURCE = nvcc.CSRC / "sweep_emit.cu"
CHUNK = 1024   # K6's chunk rows
TILE_ROWS = 128  # K6's tile: source rows against one target chunk
LANES = 32     # K7: the candidates a warp tests at once
# K7's per-row counts in shared memory up to 200 KB (n <= 51,200)
WARP_COUNTS_SMEM = 200 * 1_024


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernels (once per source hash) and load them.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.phyx_sweep_warp.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.phyx_sweep_chunked.argtypes = [ptr] * 13 + [i32] * 3 + [ptr]
    lib.phyx_sweep_chunked_tiles.argtypes = [i32]
    for fn in (lib.phyx_sweep_warp, lib.phyx_sweep_chunked,
               lib.phyx_sweep_chunked_tiles):
        fn.restype = ctypes.c_int
    return lib, report


def check_inputs(aabb_flat, order, dyn, nact, max_pairs) -> int:
    """Checks the sweep's inputs (metadata only: nothing is read back).
    Returns N."""
    device = aabb_flat.device
    n = order.shape[0] if torch.is_tensor(order) and order.dim() == 1 else -1
    if n < 1:
        raise ValueError("order must be (N,) with N >= 1")
    _check("aabb_flat", aabb_flat, torch.float32, (4 * n,), device)
    _check("order", order, torch.int32, (n,), device)
    _check("dyn", dyn, torch.int32, (n,), device)
    _check("nact", nact, torch.int32, (), device)
    if max_pairs < 0:
        raise ValueError("max_pairs must be >= 0")
    if device.type == "cuda" and aabb_flat.data_ptr() % 16:
        raise ValueError("aabb_flat must be 16-byte aligned (rows are read "
                         "as float4)")
    return n


def _scan_scratch(kind: str, device, ntiles: int, extra: tuple) -> tuple:
    """The single-pass scan's scratch for K4 or K6 (``csrc/onepass.cuh``)
    on ``device``'s current stream: ticket (1,) int64, flag (ntiles,)
    int32, agg and incl (ntiles,) int64, then ``extra`` as (dtype, size)
    pairs.  Zeroed once and kept.  The launch counts its calls in the
    ticket and tags what it publishes with the call's number, so no call
    clears it and the host passes nothing of the call: a launch captured
    in a CUDA graph (``step.rollout``) replays.  Calls on one stream run
    in turn; a capture runs on its own stream (``step._capture``), whose
    scratch the uncaptured warm-up frame makes before the capture, so the
    captured launches of every graph use that one, outside the graphs'
    pools.  A graph replays on its caller's stream, so two graphs of one
    shape replayed at once on two streams would share one scratch: graph
    replays on a device must run one at a time."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (kind, device.index, stream, ntiles, extra)
    if key not in _SCRATCH:
        _SCRATCH[key] = tuple(
            torch.zeros((size,), dtype=dtype, device=device)
            for dtype, size in ((torch.int64, 1), (torch.int32, ntiles),
                                (torch.int64, ntiles), (torch.int64, ntiles))
            + extra)
    return _SCRATCH[key]


_SCRATCH: dict = {}


def _launch(fn, *args) -> None:
    """Calls the C entry ``fn`` with tensors as device pointers (None as a
    null pointer), on the current stream; raises if the launch was
    refused.  Shared with ``kernels/sweep_tiled.py``."""
    device = next(a.device for a in args if torch.is_tensor(a))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _empty_buffer(max_pairs: int, device):
    return tuple(torch.full((max_pairs,), EMPTY, dtype=torch.int32,
                            device=device) for _ in range(2))


def _require_cuda(device) -> None:
    if device.type != "cuda":
        raise NotImplementedError(f"no sweep kernel for {device.type}")


def chunked_pass(aabb_flat, order, dyn, nact, pi, pj, counters,
                 max_pairs: int) -> None:
    """K6's one launch, on the current stream, into the buffers given:
    ``pi``, ``pj`` (max_pairs,) int32 whole (EMPTY from num on) and
    ``counters`` (2,) int32 [num, ovf].  Raises if the launch was
    refused."""
    n = order.shape[0]
    for name, t in (("order", order), ("dyn", dyn)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (K6 copies "
                             "chunks of it in bulk)")
    nb = n // CHUNK
    lib, _ = build()
    scratch = _scan_scratch(
        "K6", aabb_flat.device, lib.phyx_sweep_chunked_tiles(nb),
        ((torch.int32, nb), (torch.int32, nb)))
    _launch(lib.phyx_sweep_chunked, aabb_flat, order, dyn, nact, *scratch,
            pi, pj, counters, nb, max_pairs, EMPTY)


def warp_pass(aabb_flat, order, dyn, nact, pi, pj, num, ovf,
              max_pairs: int, counts=None) -> None:
    """K7's one launch, on the current stream, into the buffers given:
    ``pi``, ``pj`` (max_pairs,) int32 whole (EMPTY from num on), ``num``
    and ``ovf`` () int32.  The per-row counts go to ``counts``, (N,) int32
    device scratch, when it is given (the wrapper gives it where 4 N bytes
    pass ``WARP_COUNTS_SMEM``; a check on the card gives it at any N),
    else to shared memory.  Raises if the launch was refused."""
    n = order.shape[0]
    if counts is None and 4 * n > WARP_COUNTS_SMEM:
        raise ValueError(f"{n} rows' counts do not fit shared memory: give "
                         "counts scratch")
    lib, _ = build()
    _launch(lib.phyx_sweep_warp, aabb_flat, order, dyn, nact, counts, pi, pj,
            num, ovf, n, max_pairs, EMPTY, int(counts is None))


def sweep_emit(aabb_flat: torch.Tensor,   # (4 N,) f32 by body id
               order: torch.Tensor,       # (N,) int32 sorted by lox
               dyn: torch.Tensor,         # (N,) int32 by body id
               nact: torch.Tensor,        # () int32 active body count
               max_pairs: int):
    """K7.  Returns (pi, pj, num, ovf) — see the module docstring.  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    ``sweep_emit.launches`` counts kernel launches (one a call)."""
    n = check_inputs(aabb_flat, order, dyn, nact, max_pairs)
    dev = aabb_flat.device
    if dev.type == "cpu":
        return sweep_emit_plain(aabb_flat, order, dyn, nact, max_pairs)
    _require_cuda(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pi, pj = (torch.empty((max_pairs,), **i32) for _ in range(2))
    num, ovf = (torch.empty((), **i32) for _ in range(2))
    counts = (None if 4 * n <= WARP_COUNTS_SMEM
              else torch.empty((n,), **i32))
    warp_pass(aabb_flat, order, dyn, nact, pi, pj, num, ovf, max_pairs,
              counts)
    count_launch(sweep_emit)
    return pi, pj, num, ovf


sweep_emit.launches = 0


def sweep_emit_v2(aabb_flat: torch.Tensor,   # (4 N,) f32 sorted
                  order: torch.Tensor,       # (N,) int32 sorted -> body id
                  dyn: torch.Tensor,         # (N,) int32 sorted
                  nact: torch.Tensor,        # () int32 active body count
                  max_pairs: int):
    """K6.  Returns (pi, pj, num, ovf) — see the module docstring.  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    ``sweep_emit_v2.launches`` counts kernel launches (one a call)."""
    n = check_inputs(aabb_flat, order, dyn, nact, max_pairs)
    if n % CHUNK:
        raise ValueError(f"K6 needs whole chunks of {CHUNK} rows, got {n}")
    dev = aabb_flat.device
    if dev.type == "cpu":
        return sweep_emit_v2_plain(aabb_flat, order, dyn, nact, max_pairs)
    _require_cuda(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pi, pj = (torch.empty((max_pairs,), **i32) for _ in range(2))
    counters = torch.empty((2,), **i32)
    chunked_pass(aabb_flat, order, dyn, nact, pi, pj, counters, max_pairs)
    count_launch(sweep_emit_v2)
    return pi, pj, counters[0], counters[1]


sweep_emit_v2.launches = 0


def _emitted(order, src, dst, max_pairs: int):
    """The buffer of the emissions (sorted rows ``src``, ``dst``, in
    emission order) cut at ``max_pairs``, and the counters."""
    total = src.numel()
    pi, pj = _empty_buffer(max_pairs, order.device)
    m = min(total, max_pairs)
    oi, oj = order[src[:m]], order[dst[:m]]
    pi[:m] = torch.minimum(oi, oj)
    pj[:m] = torch.maximum(oi, oj)

    def count(x):
        return torch.full((), x, dtype=torch.int32, device=order.device)

    return pi, pj, count(m), count(total - m)


def sweep_emit_plain(aabb_flat, order, dyn, nact, max_pairs: int):
    """K7's plain version: every walking row takes its next candidate at
    once, a row leaving the set at its first x-closed candidate; the hits,
    keyed (si, sj), are ordered by one sort and cut at ``max_pairs``.  It
    reads ``nact`` and the walking set back to the host: for tests and
    comparison with the kernel."""
    n = order.shape[0]
    na = min(max(int(nact), 0), n)
    ids = order[:na].to(torch.int64)
    lox, loy, hix, hiy = aabb_flat.view(n, 4)[ids].unbind(1)
    d_sorted = dyn[ids]
    walking = torch.arange(na, device=order.device)
    hits = [walking[:0]]
    for d in range(1, na):
        walking = walking[walking + d < na]
        q = walking + d
        still = lox[q] <= hix[walking]
        walking, q = walking[still], q[still]
        if walking.numel() == 0:
            break
        ok = ((loy[q] <= hiy[walking]) & (loy[walking] <= hiy[q])
              & (d_sorted[walking] + d_sorted[q] > 0))
        hits.append(walking[ok] * n + q[ok])
    key = torch.sort(torch.cat(hits)).values
    return _emitted(order, torch.div(key, n, rounding_mode="floor"),
                    key % n, max_pairs)


def sweep_emit_warp_plain(aabb_flat, order, dyn, nact, max_pairs: int,
                          lanes: int = LANES):
    """K7's schedule in torch: every walking row tests its next ``lanes``
    candidates sj = si+1+lanes m+lane at once; the x-open mask (lox <= the
    row's hix, False on NaN or past nact) and the hit mask keep only the
    hits before the first closed lane, and the rows with a closed lane stop.
    A row's count is the sum of its masks' hits; an exclusive prefix sum
    saturated at ``max_pairs`` gives each row its first slot, and a hit's
    slot is that plus the row's hits in earlier batches and the hits below
    its lane in its batch.  Slots below ``max_pairs`` get the pair, the
    rest of the buffer EMPTY.  Equal to ``sweep_emit_plain``; it reads
    ``nact`` and the walking set back to the host: for tests and
    comparison with the kernel."""
    n = order.shape[0]
    device = order.device
    na = min(max(int(nact), 0), n)
    ids = order.to(torch.int64)
    lox, loy, hix, hiy = aabb_flat.view(n, 4)[ids].unbind(1)
    d = dyn[ids]
    lane = torch.arange(lanes, device=device)
    rows = torch.arange(na, device=device)
    batch = 0
    found = []        # (row, batch, lane) of each counted hit
    while rows.numel():
        sj = rows[:, None] + 1 + batch * lanes + lane[None, :]
        live = sj < na
        q = torch.where(live, sj, 0)
        src = rows[:, None]
        is_open = live & (lox[q] <= hix[src])
        hit = (is_open & (loy[q] <= hiy[src]) & (loy[src] <= hiy[q])
               & (d[src] + d[q] > 0))
        closed = ~is_open
        first = torch.where(closed.any(1), closed.int().argmax(1), lanes)
        counted = hit & (lane[None, :] < first[:, None])
        r, ln = torch.nonzero(counted, as_tuple=True)
        found.append(torch.stack([rows[r], torch.full_like(r, batch), ln]))
        rows = rows[first == lanes]
        batch += 1
    found = (torch.cat(found, 1) if found
             else torch.zeros((3, 0), dtype=torch.int64, device=device))
    row, bat, ln = found
    counts = torch.bincount(row, minlength=na)
    total = int(counts.sum())
    first_slot = torch.clamp(torch.cumsum(counts, 0) - counts, max=max_pairs)
    # the row's hits in earlier batches and below the lane in this one:
    # its rank among the row's hits in (batch, lane) order
    key = (row * (batch + 1) + bat) * lanes + ln
    srt = torch.argsort(key)
    rank = torch.empty_like(srt)
    rank[srt] = torch.arange(srt.numel(), device=device)
    rank = rank - (torch.cumsum(counts, 0) - counts)[row]
    slot = first_slot[row] + rank
    keep = slot < max_pairs
    pi, pj = _empty_buffer(max_pairs, device)
    oi = order[row[keep]]
    oj = order[(row + 1 + bat * lanes + ln)[keep]]
    pi[slot[keep]] = torch.minimum(oi, oj)
    pj[slot[keep]] = torch.maximum(oi, oj)
    m = min(total, max_pairs)

    def count(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    return pi, pj, count(m), count(total - m)


def sweep_emit_v2_plain(aabb_flat, order, dyn, nact, max_pairs: int):
    """K6's plain version: each visited (source chunk, target chunk) pair
    tests its 1024 x 1024 candidates at once, hits taken row by row with j
    descending, chunk pairs in (s, t) order.  It reads ``nact`` and the
    chunk bounds back to the host: for tests and comparison with the
    kernel."""
    n = order.shape[0]
    na = min(max(int(nact), 0), n)
    xlo, ylo, xhi, yhi = aabb_flat.view(n, 4).unbind(1)
    nb = n // CHUNK
    hix_max = xhi.view(nb, CHUNK).amax(1).tolist()
    first_x = xlo[::CHUNK].tolist()
    lane = torch.arange(CHUNK, device=order.device)
    src, dst = [lane[:0]], [lane[:0]]
    for s in range(-(-na // CHUNK)):
        k = s * CHUNK + lane
        t = s
        while t * CHUNK < na and first_x[t] <= hix_max[s]:
            j = t * CHUNK + lane
            rows = (k < na) & (xlo[t * CHUNK] <= xhi[k])
            ok = ((xlo[j][None] <= xhi[k][:, None])
                  & (ylo[j][None] <= yhi[k][:, None])
                  & (ylo[k][:, None] <= yhi[j][None])
                  & (j[None] > k[:, None]) & (j[None] < na)
                  & (dyn[j][None] + dyn[k][:, None] > 0) & rows[:, None])
            # row-major over the column-flipped tests: k, then j descending
            kk, jj = torch.nonzero(ok.flip(1), as_tuple=True)
            src.append(k[kk])
            dst.append(j[CHUNK - 1 - jj])
            t += 1
    return _emitted(order, torch.cat(src), torch.cat(dst), max_pairs)


def sorted_chunks(aabb_flat, nact) -> list:
    """K6's proof, chunk by chunk: whether chunk t's rows below ``nact``
    have nondecreasing lox and none is NaN, so that no hit of a row lies
    past its first candidate in t that is not x-open."""
    n = aabb_flat.numel() // 4
    na = min(max(int(nact), 0), n)
    xlo = aabb_flat.view(n, 4)[:, 0]
    out = []
    for t in range(n // CHUNK):
        x = xlo[t * CHUNK:min((t + 1) * CHUNK, na)]
        out.append(bool(not torch.isnan(x).any()
                        and (x[:-1] <= x[1:]).all()))
    return out


def sweep_emit_v2_onepass_plain(aabb_flat, order, dyn, nact,
                                max_pairs: int, lanes: int = LANES):
    """K6's one-pass schedule in torch (``csrc/sweep_emit.cu``): tiles of
    ``TILE_ROWS`` source rows against one target chunk, numbered in
    (s, t, q) order over the reached ones only: where the reference's
    chunk loop of s reaches t (every chunk u in [s, t] starts below nact
    and at or before the NaN-propagating max of chunk s's hix) and the
    part q of s has an active row.  Each cell (k, t) of a tile, where k <
    nact and t's first lox <= hix[k], tests its
    candidates j = lo + lanes b + lane a batch (lo = max(t's first row,
    k + 1), j below nact and t's end), two batches a step; where
    ``sorted_chunks`` proves t, the cell stops after the step holding its
    first candidate that is not x-open.  A cell's first slot is its tile's (an exclusive scan over the
    tiles' counts) plus the exclusive scan of the rows' counts inside the
    tile; a hit's slot adds the cell's hits at a larger j.  Slots below
    ``max_pairs`` get the pair, the rest of the buffer EMPTY.  Returns
    (pi, pj, num, ovf, the proof a chunk).  Equal to
    ``sweep_emit_v2_plain``; it reads ``nact`` back to the host: for tests
    and comparison with the kernel."""
    n = order.shape[0]
    device = order.device
    na = min(max(int(nact), 0), n)
    nb, parts = n // CHUNK, CHUNK // TILE_ROWS
    box = aabb_flat.view(n, 4)
    xlo, xhi = box[:, 0], box[:, 2]
    smax = xhi.view(nb, CHUNK).amax(1).tolist()    # NaN if any is
    first_x = xlo[::CHUNK].tolist()
    proof = sorted_chunks(aabb_flat, nact)
    lane = torch.arange(lanes, device=device)
    # the cells of the reached tiles, in (s, t, q) order: tile, row, t
    tile_of, rows_of, t_of = [], [], []
    ntiles = 0
    for s in range(nb):
        for t in range(s, nb):
            if not (t * CHUNK < na and all(
                    first_x[u] <= smax[s] for u in range(s, t + 1))):
                break
            for q in range(parts):
                first = s * CHUNK + q * TILE_ROWS
                if first < na:
                    k = torch.arange(first, first + TILE_ROWS, device=device)
                    k = k[(k < na) & (first_x[t] <= xhi[k])]
                    tile_of.append(torch.full_like(k, ntiles))
                    rows_of.append(k)
                    t_of.append(torch.full_like(k, t))
                    ntiles += 1
    empty = torch.zeros((0,), dtype=torch.int64, device=device)
    tile = torch.cat(tile_of) if tile_of else empty
    k = torch.cat(rows_of) if rows_of else empty
    t = torch.cat(t_of) if t_of else empty
    lo = torch.maximum(t * CHUNK, k + 1)
    hi = torch.clamp((t + 1) * CHUNK, max=na)
    short = torch.tensor(proof, dtype=torch.bool, device=device)[t] \
        if nb else empty.bool()
    d = dyn.to(torch.int64)
    cell = torch.arange(k.numel(), device=device)
    live = lo < hi
    closing = torch.zeros_like(live)   # a closed candidate in this step
    found = []        # (cell, batch, lane) of each hit
    for b in range(CHUNK // lanes):
        c = cell[live]
        if c.numel() == 0:
            break
        j = lo[c, None] + b * lanes + lane[None, :]
        inside = j < hi[c, None]
        jj = torch.where(inside, j, 0)
        a = box[k[c]]
        cand = box[jj]
        is_open = inside & (cand[..., 0] <= a[:, None, 2])
        hit = (is_open & (cand[..., 1] <= a[:, None, 3])
               & (a[:, None, 1] <= cand[..., 3])
               & (d[k[c]][:, None] + d[jj] > 0))
        r, ln = torch.nonzero(hit, as_tuple=True)
        found.append(torch.stack([c[r], torch.full_like(r, b), ln]))
        closing[c] |= short[c] & (inside & ~is_open).any(1)
        live[c] = (lo[c] + (b + 1) * lanes < hi[c]) & ~(
            closing[c] & (b % 2 == 1))
        if b % 2 == 1:
            closing[c] = False
    found = (torch.cat(found, 1) if found
             else torch.zeros((3, 0), dtype=torch.int64, device=device))
    hc, hb, hl = found
    counts = torch.bincount(hc, minlength=k.numel())
    total = int(counts.sum())
    # tiles' first slots: an exclusive scan of the tiles' counts
    agg = torch.zeros((ntiles,), dtype=torch.int64, device=device)
    agg.index_add_(0, tile, counts)
    tile_first = torch.cumsum(agg, 0) - agg
    # rows' offsets in their tile: an exclusive scan in row order
    ends = torch.cumsum(counts, 0)
    row_off = ends - counts - (ends - counts)[
        torch.searchsorted(tile, tile)]
    cell_first = tile_first[tile] + row_off
    # the cell's hits at a larger j: its rank in (cell, j descending) order
    jdx = hb * lanes + hl
    srt = torch.argsort(hc * CHUNK + (CHUNK - 1 - jdx))
    rank = torch.empty_like(srt)
    rank[srt] = torch.arange(srt.numel(), device=device)
    slot = cell_first[hc] + rank - (ends - counts)[hc]
    keep = slot < max_pairs
    pi, pj = _empty_buffer(max_pairs, device)
    oi = order[k[hc[keep]]]
    oj = order[(lo[hc] + jdx)[keep]]
    pi[slot[keep]] = torch.minimum(oi, oj)
    pj[slot[keep]] = torch.maximum(oi, oj)
    m = min(total, max_pairs)

    def count(x):
        return torch.full((), x, dtype=torch.int32, device=device)

    return pi, pj, count(m), count(total - m), proof
