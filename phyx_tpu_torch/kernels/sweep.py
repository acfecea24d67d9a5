"""K6 and K7, the sweep-and-prune pair emission: counterparts of
``phyx_tpu/kernels/sweep.py`` (``sweep_emit_v2`` and ``sweep_emit``), the
kernels of ``broadphase.broadphase_sap_kernel``.  K4, the slab-windowed
sweep of the same reference module, is in ``kernels/sweep_tiled.py``.

The kernels are in ``csrc/sweep_emit.cu`` (built with ``nvcc`` at first
use, ``kernels/nvcc.py``, and called through ``ctypes``); each counts the
hits of its cells, takes their prefix sum on the device and writes them in
order.

* ``sweep_emit_v2`` (K6) and ``sweep_emit`` (K7) are the wrappers: on CUDA
  tensors they launch the kernel (or raise); on CPU tensors they run the
  plain version.  ``count_pass`` and ``emit_pass`` are their two
  launches, on buffers the caller gives.
* ``sweep_emit_v2_plain`` and ``sweep_emit_plain`` compute the same buffer
  and counters as vectorized torch operations.

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

from phyx_tpu_torch.kernels import nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import _check
from phyx_tpu_torch.types import EMPTY

SOURCE = nvcc.CSRC / "sweep_emit.cu"
CHUNK = 1024   # K6's chunk rows


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernels (once per source hash) and load them.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.phyx_sweep_serial_count.argtypes = [ptr] * 5 + [i32, ptr]
    lib.phyx_sweep_serial_emit.argtypes = [ptr] * 8 + [i32, i32, ptr]
    lib.phyx_sweep_chunked_count.argtypes = [ptr] * 6 + [i32, ptr]
    lib.phyx_sweep_chunked_emit.argtypes = [ptr] * 8 + [i32, i32, ptr]
    for fn in (lib.phyx_sweep_serial_count, lib.phyx_sweep_serial_emit,
               lib.phyx_sweep_chunked_count, lib.phyx_sweep_chunked_emit):
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


def _counters(total: torch.Tensor, max_pairs: int):
    num = torch.clamp(total, max=max_pairs)
    return num.to(torch.int32), (total - num).to(torch.int32)


def _require_cuda(device) -> None:
    if device.type != "cuda":
        raise NotImplementedError(f"no sweep kernel for {device.type}")


def cells(n: int, chunked: bool) -> int:
    """Cells the count pass fills: K6's (source row, target chunk) cells
    with t >= s, laid out (s, t, k), when ``chunked``, else K7's rows."""
    nb = n // CHUNK
    return nb * (nb + 1) // 2 * CHUNK if chunked else n


def chunk_hix(aabb_flat: torch.Tensor) -> torch.Tensor:
    """K6's walk bound: the largest hix of each 1024-row chunk, (nb,) f32."""
    return aabb_flat.view(-1, CHUNK, 4)[:, :, 2].amax(1)


def count_pass(chunked: bool, aabb_flat, order, dyn, nact, counts,
               hix=None) -> None:
    """The first launch, on the current stream: each cell's hits into
    ``counts`` ((cells(N, chunked),) int32), K6's cells with its chunk
    bounds ``hix`` when ``chunked``, else K7's rows.  Raises if the launch
    was refused.  (The wrapper's part; called alone only to time it.)"""
    lib, _ = build()
    n = order.shape[0]
    if chunked:
        _launch(lib.phyx_sweep_chunked_count, aabb_flat, order, dyn, nact,
                hix, counts, n // CHUNK)
    else:
        _launch(lib.phyx_sweep_serial_count, aabb_flat, order, dyn, nact,
                counts, n)


def emit_pass(chunked: bool, aabb_flat, order, dyn, nact, counts, ends, pi,
              pj, max_pairs: int) -> None:
    """The second launch, on the current stream: each cell walks again and
    writes its hits from the slot ``ends - counts`` (``ends`` the (cells,)
    int64 inclusive prefix sum of ``counts``) while below ``max_pairs``.
    Raises if the launch was refused."""
    lib, _ = build()
    n = order.shape[0]
    fn, size = ((lib.phyx_sweep_chunked_emit, n // CHUNK) if chunked
                else (lib.phyx_sweep_serial_emit, n))
    _launch(fn, aabb_flat, order, dyn, nact, counts, ends, pi, pj, size,
            max_pairs)


def _sweep(chunked: bool, aabb_flat, order, dyn, nact, max_pairs: int):
    """Both launches and the prefix sum between them, with no host sync."""
    dev = aabb_flat.device
    _require_cuda(dev)
    counts = torch.empty((cells(order.shape[0], chunked),),
                         dtype=torch.int32, device=dev)
    pi, pj = _empty_buffer(max_pairs, dev)
    count_pass(chunked, aabb_flat, order, dyn, nact, counts,
               chunk_hix(aabb_flat) if chunked else None)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    emit_pass(chunked, aabb_flat, order, dyn, nact, counts, ends, pi, pj,
              max_pairs)
    return (pi, pj) + _counters(ends[-1], max_pairs)


def sweep_emit(aabb_flat: torch.Tensor,   # (4 N,) f32 by body id
               order: torch.Tensor,       # (N,) int32 sorted by lox
               dyn: torch.Tensor,         # (N,) int32 by body id
               nact: torch.Tensor,        # () int32 active body count
               max_pairs: int):
    """K7.  Returns (pi, pj, num, ovf) — see the module docstring.  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    ``sweep_emit.launches`` counts kernel launches (one a call: the count
    and the emit pass)."""
    check_inputs(aabb_flat, order, dyn, nact, max_pairs)
    if aabb_flat.device.type == "cpu":
        return sweep_emit_plain(aabb_flat, order, dyn, nact, max_pairs)
    out = _sweep(False, aabb_flat, order, dyn, nact, max_pairs)
    sweep_emit.launches += 1
    return out


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
    if aabb_flat.device.type == "cpu":
        return sweep_emit_v2_plain(aabb_flat, order, dyn, nact, max_pairs)
    out = _sweep(True, aabb_flat, order, dyn, nact, max_pairs)
    sweep_emit_v2.launches += 1
    return out


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
