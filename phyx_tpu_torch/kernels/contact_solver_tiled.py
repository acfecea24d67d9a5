"""The two tiled solves, each visiting its rows with their slab's window
of the x-rank embedded body table, run level by level over the visits'
dependency graph on that table:

* K3, slab-major: contact slots in (slab, pi, pj) order, counterpart of
  ``phyx_tpu/kernels/contact_solver_tiled2.py`` (``_tiled2_kernel``,
  ``solve_contacts_tiled2``);
* K5, routed: contact and joint rows routed to per-slab slot budgets, each
  slab's contacts then its joint rows, counterpart of
  ``phyx_tpu/kernels/contact_solver_tiled.py`` (``_tiled_kernel``,
  ``solve_contacts_tiled``).

Both kernels are in ``csrc/contact_solver_tiled.cu``: a slab visit map over
K1's level schedule (``csrc/levels.cuh``: a pre-pass levels the walk's
visits, keyed on the table rows after the window clamp, then one block
runs each pass level by level); their visits are ``solve_rows.cuh``'s,
those of K1 and K2.  Built with ``nvcc`` at first use
(``kernels/nvcc.py``) and called through ``ctypes``.

* ``solve_contacts_tiled2`` (K3) and ``solve_contacts_tiled`` (K5) are the
  wrappers: on CUDA tensors they launch the kernel (or raise), placing its
  per-row arrays by the table's rows as K1 places its bodies'
  (``placement``); on CPU tensors they run the serial plain version.
* ``solve_contacts_tiled2_plain`` and ``solve_contacts_tiled_plain`` walk
  the same visits in the serial order as scalar float32 torch operations
  (``plain_walk``): the spec.  Each agrees with its kernel to the bit.
* ``solve_contacts_tiled2_levels_plain`` and
  ``solve_contacts_tiled_levels_plain`` run the same visits level by level
  (``slab_levels``, the pre-pass as torch operations, with the table's
  free rows, then ``freed_walk``), one vectorised torch operation per
  scalar operation; each equals its serial plain version to the bit, and
  is fast enough to check the kernels on all passes at full-size frames.

The zero blocks, the halo and the padding of the table, and any static at
rest, are free rows (``kernels/contact_solver_streamed.py``): while every
write to them is +0.0 they are no nodes of the level graph.  Each call's
counters stay on the device (K1's ``COUNTERS``), the latest call's at
``<wrapper>.stats``.

Layout (flat): the embedded body table ``(npad*8,)`` f32 (``tiling.embed``),
slab s's window the rows ``[s*slab_stride, s*slab_stride + window_rows)``;
per slot, ``b12`` ``(S*2,)`` int32 [b1, b2] rows local to the slot's slab
window (clamped into ``[0, window_rows)``) and ``cw`` ``(S*14,)`` f32 [12
row columns, 2 warm impulses].  Both return the table, the accumulators
``(S*4,)`` in slot order (zero in slots not visited) and the residual
``(1,)``; gates as in ``kernels/contact_solver_streamed.py``.

* K3 (the caller is ``solver.solve_pallas_tiled2``): ``cum``
  ``(n_slabs+1,)`` int32, the slots of slabs below s, ``cum[0] == 0``.
  Every pass visits slots ``[0, cum[n_slabs])`` in order, slot k with the
  window of the slab s with ``cum[s] <= k < cum[s+1]``.  The bounds are
  clamped into ``[0, S]`` and run through a running max, so a slab never
  starts before the one before it ends: on a non-decreasing ``cum`` (a
  cumsum, as every caller makes) that is the plain reading.
* K5 (the caller is ``solver.solve_pallas_tiled``): slab s owns the slots
  ``[s*(c_slots + j_slots), +c_slots)`` for contact rows and the
  ``j_slots`` after them for joint rows (encodings in ``joints.py``);
  ``slab_counts`` ``(2*n_slabs,)`` int32 holds each slab's live contact
  rows, then each slab's live joint rows, filling a prefix of its budget
  (each clamped into ``[0, budget]``).  Every pass visits, slab by slab,
  the live contact slots and then the live joint slots.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import count_launch, nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    COUNTERS, _check, _scratch, free_rows, freed_walk, levels_of,
    placement, plain_walk, scratch_levels)

SOURCE = nvcc.CSRC / "contact_solver_tiled.cu"
# the slab visit map's table (4 n_slabs + 1 int32) sits in the pre-pass's
# shared memory beside the last-level array
MAX_SLABS = 1024


def tiled_placements(npad: int) -> list:
    """Every placement of the kernels' per-row arrays a table of ``npad``
    rows allows, the wrapper's first (K1's ``placement``, by the table's
    rows: the last-level array in shared memory up to 51,200 rows, the
    working columns up to 19,285): each array in shared memory where it
    fits and in device memory."""
    first = placement(npad)
    lasts = [first["smem_last"]] + [False] * first["smem_last"]
    cols = [first["smem_cols"]] + [False] * first["smem_cols"]
    return [dict(smem_last=a, smem_cols=c) for a in lasts for c in cols]


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile both kernels (once per source hash) and load them.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    for fn, n_ints in ((lib.phyx_contact_solve_tiled2, 7),
                       (lib.phyx_contact_solve_tiled, 8)):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, report


def check_slab_inputs(body_flat, b12, cw, counts, n_counts, vel_iters,
                      pos_iters, n_slabs, slab_stride, window_rows,
                      tols) -> tuple:
    """Checks the tiled solves' inputs (metadata only: nothing is read
    back).  Returns (npad, slots, tols), ``tols`` made a (2,) tensor on the
    device (zeros, which never fire, when ungated)."""
    device = body_flat.device
    npad = body_flat.numel() // 8
    s = b12.numel() // 2
    _check("body_flat", body_flat, torch.float32, (npad * 8,), device)
    _check("b12", b12, torch.int32, (s * 2,), device)
    _check("cw", cw, torch.float32, (s * 14,), device)
    _check("counts", counts, torch.int32, (n_counts,), device)
    if not 1 <= n_slabs <= MAX_SLABS or vel_iters < 0 or pos_iters < 0:
        raise ValueError(f"need 1 to {MAX_SLABS} slabs and non-negative "
                         "passes")
    if window_rows <= 0 or (n_slabs - 1) * slab_stride + window_rows > npad:
        raise ValueError(f"{n_slabs} windows of {window_rows} rows at "
                         f"stride {slab_stride} overrun {npad} rows")
    if tols is None:
        tols = torch.zeros((2,), dtype=torch.float32, device=device)
    _check("tols", tols, torch.float32, (2,), device)
    return npad, s, tols


def _k3_call(body_flat, b12, cw, cum, vel_iters, pos_iters, n_slabs,
             slab_stride, window_rows, tols=None) -> tuple:
    """K3's checked inputs as (C entry, counts, tols, int arguments)."""
    _, s, tols = check_slab_inputs(
        body_flat, b12, cw, cum, n_slabs + 1, vel_iters, pos_iters, n_slabs,
        slab_stride, window_rows, tols)
    return ("phyx_contact_solve_tiled2", cum, tols,
            (slab_stride, window_rows, n_slabs, s, vel_iters, pos_iters))


def _k5_call(body_flat, b12, cw, slab_counts, vel_iters, pos_iters,
             n_slabs, slab_stride, window_rows, j_slots=0,
             tols=None) -> tuple:
    """K5's checked inputs as (C entry, counts, tols, int arguments)."""
    _, s, tols = check_slab_inputs(
        body_flat, b12, cw, slab_counts, 2 * n_slabs, vel_iters, pos_iters,
        n_slabs, slab_stride, window_rows, tols)
    if s % n_slabs or not 0 <= j_slots < s // n_slabs:
        raise ValueError(f"{s} slots do not split into {n_slabs} slabs "
                         f"with {j_slots} joint slots each and contact slots")
    return ("phyx_contact_solve_tiled", slab_counts, tols,
            (slab_stride, window_rows, n_slabs, s // n_slabs - j_slots,
             j_slots, vel_iters, pos_iters))


def _call(args: dict) -> tuple:
    """``_k3_call`` or ``_k5_call`` on a wrapper's arguments (K3's hold
    ``cum``)."""
    return (_k3_call if "cum" in args else _k5_call)(**args)


def _launch(args: dict, smem_last: bool, smem_cols: bool,
            solve: bool = True, lib=None) -> tuple:
    """Launches K3 or K5 on the checked CUDA arguments ``args`` with its
    per-row arrays placed as given, on fresh outputs and scratch
    (``torch.empty``; the kernel allocates nothing).  ``solve`` False runs
    the pre-pass alone; ``lib`` is another build of the source (default:
    ``build()``'s).  Returns (table', acc, residual, int scratch, the
    call's counters)."""
    entry, counts, tols, ints = _call(args)
    body_flat, b12 = args["body_flat"], args["b12"]
    device = body_flat.device
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")
    if lib is None:
        lib = build()[0]
    npad, s = body_flat.numel() // 8, b12.numel() // 2
    body_out = body_flat.clone() if solve else body_flat
    acc = torch.zeros((s * 4,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    iscratch, fscratch, stats = _scratch(npad, s, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(
            body_out.data_ptr(), body_flat.data_ptr(), b12.data_ptr(),
            args["cw"].data_ptr(), acc.data_ptr(), res.data_ptr(),
            counts.data_ptr(), tols.data_ptr(), stats.data_ptr(),
            *(int(x) for x in ints), npad, iscratch.data_ptr(),
            fscratch.data_ptr(), int(smem_last), int(smem_cols), int(solve),
            stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return body_out, acc, res, iscratch, stats


def solve_contacts_tiled2(
    body_flat: torch.Tensor,   # (npad*8,) f32 embedded table
    b12: torch.Tensor,         # (S*2,) int32 window-local rows
    cw: torch.Tensor,          # (S*14,) f32 row columns | warm impulses
    cum: torch.Tensor,         # (n_slabs+1,) int32, on the device
    vel_iters: int,
    pos_iters: int,
    n_slabs: int,
    slab_stride: int,
    window_rows: int,
    tols: Optional[torch.Tensor] = None,   # (2,) f32 [vel, pos] thresholds
):
    """K3.  Returns (body_flat', acc (S*4,), residual (1,)) — see the
    module docstring.  CUDA tensors launch the kernel; CPU tensors take the
    serial plain version.  ``solve_contacts_tiled2.launches`` counts kernel
    launches, ``solve_contacts_tiled2.stats`` holds the latest launch's
    counters."""
    args = dict(body_flat=body_flat, b12=b12, cw=cw, cum=cum,
                vel_iters=vel_iters, pos_iters=pos_iters, n_slabs=n_slabs,
                slab_stride=slab_stride, window_rows=window_rows)
    tols = _k3_call(**args, tols=tols)[2]
    if body_flat.device.type == "cpu":
        return solve_contacts_tiled2_plain(**args, tols=tols)
    out = _launch(dict(args, tols=tols),
                  **placement(body_flat.numel() // 8))
    solve_contacts_tiled2.stats = out[4]
    count_launch(solve_contacts_tiled2)
    return out[:3]


solve_contacts_tiled2.launches = 0
solve_contacts_tiled2.stats = None
solve_contacts_tiled2.counter_names = COUNTERS


def solve_contacts_tiled(
    body_flat: torch.Tensor,     # (npad*8,) f32 embedded table
    b12: torch.Tensor,           # (S*2,) int32 window-local rows
    cw: torch.Tensor,            # (S*14,) f32 row columns | warm impulses
    slab_counts: torch.Tensor,   # (2*n_slabs,) int32, on the device
    vel_iters: int,
    pos_iters: int,
    n_slabs: int,
    slab_stride: int,
    window_rows: int,
    j_slots: int = 0,            # joint slots per slab, after the contacts
    tols: Optional[torch.Tensor] = None,   # (2,) f32 [vel, pos] thresholds
):
    """K5.  Returns (body_flat', acc (S*4,), residual (1,)) — see the
    module docstring.  CUDA tensors launch the kernel; CPU tensors take the
    serial plain version.  ``solve_contacts_tiled.launches`` counts kernel
    launches, ``solve_contacts_tiled.stats`` holds the latest launch's
    counters."""
    args = dict(body_flat=body_flat, b12=b12, cw=cw, slab_counts=slab_counts,
                vel_iters=vel_iters, pos_iters=pos_iters, n_slabs=n_slabs,
                slab_stride=slab_stride, window_rows=window_rows,
                j_slots=j_slots)
    tols = _k5_call(**args, tols=tols)[2]
    if body_flat.device.type == "cpu":
        return solve_contacts_tiled_plain(**args, tols=tols)
    out = _launch(dict(args, tols=tols),
                  **placement(body_flat.numel() // 8))
    solve_contacts_tiled.stats = out[4]
    count_launch(solve_contacts_tiled)
    return out[:3]


solve_contacts_tiled.launches = 0
solve_contacts_tiled.stats = None
solve_contacts_tiled.counter_names = COUNTERS


def solve_tiled_placed(args: dict, smem_last: bool, smem_cols: bool):
    """K3 (``args`` holding ``cum``) or K5 on a wrapper's arguments with its
    per-row arrays placed as given, whatever the table's size: for
    checking every placement against the wrapper's on the card.  CUDA
    tensors only; not counted in the launches."""
    if args["body_flat"].device.type != "cuda":
        raise ValueError("solve_tiled_placed launches the kernel: CUDA "
                         "tensors only")
    return _launch(args, smem_last, smem_cols)[:3]


def tiled_prepass(args: dict, smem_last: Optional[bool] = None) -> dict:
    """The pre-pass of K3 (``args`` holding ``cum``) or K5 alone (free rows
    no nodes), on a wrapper's CUDA arguments: for timing it apart from the
    solve and checking its levels against ``slab_levels`` with
    ``free_rows`` of the table.  Not counted in the launches.  Returns
    device tensors as K1's ``prepass`` does: ``level`` (S,) int32, each
    visit's level in walk order (the first ``offsets[-1]`` entries),
    ``offsets`` (S + 1,) int32 (the first ``n_levels + 1``), ``n_levels``
    (1,) int32, ``slots`` (S,) int32 the slot of each record in level
    order, ``stats`` the counters.  ``smem_last`` overrides where the
    last-level array sits (default: ``placement``)."""
    if args["body_flat"].device.type != "cuda":
        raise ValueError("tiled_prepass launches the kernel: CUDA tensors "
                         "only")
    s = args["b12"].numel() // 2
    if smem_last is None:
        smem_last = placement(args["body_flat"].numel() // 8)["smem_last"]
    iscratch, stats = _launch(args, smem_last, False, solve=False)[3:]
    return scratch_levels(iscratch, s, stats)


def slab_segments(args: dict) -> tuple:
    """The walk's segments on a wrapper's arguments, as the kernels read
    them: (first slot, slots) (2*n_slabs,) int64 each, segment 2s slab s's
    contact slots and 2s + 1 its joint slots.  K3: slab s holds
    ``[m[s], m[s+1])``, m the running max of ``cum`` clamped into [0, S];
    K5: each count clamped into its budget."""
    n_slabs = args["n_slabs"]
    s = args["b12"].numel() // 2
    if "cum" in args:
        m = torch.cummax(torch.clamp(args["cum"].long(), 0, s), 0).values
        first = torch.stack([m[:-1], m[1:]], 1)
        count = torch.stack([m[1:] - m[:-1], torch.zeros_like(m[1:])], 1)
        return first.reshape(-1), count.reshape(-1)
    j_slots = args.get("j_slots", 0)
    per = s // n_slabs
    c_slots = per - j_slots
    counts = args["slab_counts"].long()
    device = counts.device
    c0 = torch.arange(n_slabs, device=device) * per
    first = torch.stack([c0, c0 + c_slots], 1)
    count = torch.stack([torch.clamp(counts[:n_slabs], 0, c_slots),
                         torch.clamp(counts[n_slabs:], 0, j_slots)], 1)
    return first.reshape(-1), count.reshape(-1)


def slab_visits(args: dict) -> dict:
    """The walk's visits in serial order on a wrapper's arguments:
    ``slots``, body-table rows ``i``, ``j`` (slab s's rows at
    s*slab_stride + the local row clamped into [0, window_rows)), and
    ``joint``, each (visits,).  Reads the segment sizes back to the
    host."""
    first, count = slab_segments(args)
    device = first.device
    g = torch.repeat_interleave(torch.arange(first.numel(), device=device),
                                count)
    start = torch.cumsum(count, 0) - count
    slots = first[g] + torch.arange(g.numel(), device=device) - start[g]
    ids = torch.clamp(args["b12"].reshape(-1, 2)[slots].long(), 0,
                      args["window_rows"] - 1)
    base = torch.div(g, 2, rounding_mode="floor") * args["slab_stride"]
    return dict(slots=slots, i=base + ids[:, 0], j=base + ids[:, 1],
                joint=g % 2 == 1)


def slab_levels(args: dict, free=None) -> dict:
    """The kernels' pre-pass as torch operations: ``slab_visits`` and
    their levels (``levels_of``), keyed on the table rows after the window
    clamp, so a halo row reached from two slabs is one node; ``free``: the
    free rows, as the kernels' pre-pass takes them from its table
    (``free_rows(args["body_flat"])``), or None for the full graph."""
    vis = slab_visits(args)
    return dict(vis, free=free, **levels_of(vis["i"], vis["j"], free))


def _levels_plain(args: dict):
    lv = slab_levels(args, free_rows(args["body_flat"]))
    rows = args["cw"].reshape(-1, 14)
    return freed_walk(args["body_flat"].reshape(-1, 8), rows[:, :12],
                      rows[:, 12:], lv, lv["joint"], args["vel_iters"],
                      args["pos_iters"], args.get("tols"))[:3]


def solve_contacts_tiled2_levels_plain(body_flat, b12, cw, cum,
                                       vel_iters: int, pos_iters: int,
                                       n_slabs: int, slab_stride: int,
                                       window_rows: int, tols=None):
    """K3's levels plain version (see the module docstring): equal to
    ``solve_contacts_tiled2_plain`` to the bit.  It reads the levels back
    to the host: for tests and comparison with the kernel."""
    return _levels_plain(dict(
        body_flat=body_flat, b12=b12, cw=cw, cum=cum, vel_iters=vel_iters,
        pos_iters=pos_iters, n_slabs=n_slabs, slab_stride=slab_stride,
        window_rows=window_rows, tols=tols))


def solve_contacts_tiled_levels_plain(body_flat, b12, cw, slab_counts,
                                      vel_iters: int, pos_iters: int,
                                      n_slabs: int, slab_stride: int,
                                      window_rows: int, j_slots: int = 0,
                                      tols=None):
    """K5's levels plain version (see the module docstring): equal to
    ``solve_contacts_tiled_plain`` to the bit.  It reads the levels back
    to the host: for tests and comparison with the kernel."""
    return _levels_plain(dict(
        body_flat=body_flat, b12=b12, cw=cw, slab_counts=slab_counts,
        vel_iters=vel_iters, pos_iters=pos_iters, n_slabs=n_slabs,
        slab_stride=slab_stride, window_rows=window_rows, j_slots=j_slots,
        tols=tols))


def _walk_segments(args: dict):
    """``plain_walk`` over the walk's visits (``slab_visits``), in serial
    order."""
    vis = slab_visits(args)
    visits = list(zip(*(vis[k].tolist() for k in ("slots", "i", "j",
                                                   "joint"))))
    rows = args["cw"].reshape(-1, 14)
    return plain_walk(args["body_flat"].reshape(-1, 8), rows[:, :12],
                      rows[:, 12:], visits, args["vel_iters"],
                      args["pos_iters"], args.get("tols"))


def solve_contacts_tiled2_plain(body_flat, b12, cw, cum, vel_iters: int,
                                pos_iters: int, n_slabs: int,
                                slab_stride: int, window_rows: int,
                                tols=None):
    """K3's serial plain version (see the module docstring).  It reads
    ``cum`` and the rows back to the host: for tests and comparison with
    the kernel."""
    return _walk_segments(dict(
        body_flat=body_flat, b12=b12, cw=cw, cum=cum, vel_iters=vel_iters,
        pos_iters=pos_iters, n_slabs=n_slabs, slab_stride=slab_stride,
        window_rows=window_rows, tols=tols))


def solve_contacts_tiled_plain(body_flat, b12, cw, slab_counts,
                               vel_iters: int, pos_iters: int, n_slabs: int,
                               slab_stride: int, window_rows: int,
                               j_slots: int = 0, tols=None):
    """K5's serial plain version (see the module docstring).  It reads the
    counts and the rows back to the host: for tests and comparison with the
    kernel."""
    return _walk_segments(dict(
        body_flat=body_flat, b12=b12, cw=cw, slab_counts=slab_counts,
        vel_iters=vel_iters, pos_iters=pos_iters, n_slabs=n_slabs,
        slab_stride=slab_stride, window_rows=window_rows, j_slots=j_slots,
        tols=tols))
