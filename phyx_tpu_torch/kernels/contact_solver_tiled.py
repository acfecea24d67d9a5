"""The two tiled serial solves, each visiting its rows with their slab's
window of the x-rank embedded body table:

* K3, slab-major: contact slots in (slab, pi, pj) order, counterpart of
  ``phyx_tpu/kernels/contact_solver_tiled2.py`` (``_tiled2_kernel``,
  ``solve_contacts_tiled2``);
* K5, routed: contact and joint rows routed to per-slab slot budgets, each
  slab's contacts then its joint rows, counterpart of
  ``phyx_tpu/kernels/contact_solver_tiled.py`` (``_tiled_kernel``,
  ``solve_contacts_tiled``).

Both kernels are in ``csrc/contact_solver_tiled.cu``; their walk is
``solve_slabs`` in ``csrc/solve_slabs.cuh`` and their visits are
``solve_rows.cuh``'s, those of K1 and K2.  Built with ``nvcc`` at first use
(``kernels/nvcc.py``) and called through ``ctypes``.

* ``solve_contacts_tiled2`` (K3) and ``solve_contacts_tiled`` (K5) are the
  wrappers: on CUDA tensors they launch the kernel (or raise); on CPU
  tensors they run the plain version.
* ``solve_contacts_tiled2_plain`` and ``solve_contacts_tiled_plain`` walk
  the same visits in the same order as scalar float32 torch operations
  (``plain_walk``); each agrees with its kernel to the bit.

Layout (flat): the embedded body table ``(npad*8,)`` f32 (``tiling.embed``),
slab s's window the rows ``[s*slab_stride, s*slab_stride + window_rows)``;
per slot, ``b12`` ``(S*2,)`` int32 [b1, b2] rows local to the slot's slab
window (the kernel clamps them into ``[0, window_rows)``) and ``cw``
``(S*14,)`` f32 [12 row columns, 2 warm impulses].  Both return the table,
the accumulators ``(S*4,)`` in slot order (zero in slots not visited) and
the residual ``(1,)``; gates as in ``kernels/contact_solver_streamed.py``.

* K3 (the caller is ``solver.solve_pallas_tiled2``): ``cum``
  ``(n_slabs+1,)`` int32, the slots of slabs below s, ``cum[0] == 0``.
  Every pass visits slots ``[0, cum[n_slabs])`` in order, slot k with the
  window of the slab s with ``cum[s] <= k < cum[s+1]``.
* K5 (the caller is ``solver.solve_pallas_tiled``): slab s owns the slots
  ``[s*(c_slots + j_slots), +c_slots)`` for contact rows and the
  ``j_slots`` after them for joint rows (encodings in ``joints.py``);
  ``slab_counts`` ``(2*n_slabs,)`` int32 holds each slab's live contact
  rows, then each slab's live joint rows, filling a prefix of its budget.
  Every pass visits, slab by slab, the live contact slots and then the live
  joint slots.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import (_check,
                                                            plain_walk)

SOURCE = nvcc.CSRC / "contact_solver_tiled.cu"


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile both kernels (once per source hash) and load them.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    for fn, n_ints in ((lib.phyx_contact_solve_tiled2, 6),
                       (lib.phyx_contact_solve_tiled, 7)):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
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
    if n_slabs < 1 or vel_iters < 0 or pos_iters < 0:
        raise ValueError("need a slab and non-negative passes")
    if window_rows <= 0 or (n_slabs - 1) * slab_stride + window_rows > npad:
        raise ValueError(f"{n_slabs} windows of {window_rows} rows at "
                         f"stride {slab_stride} overrun {npad} rows")
    if tols is None:
        tols = torch.zeros((2,), dtype=torch.float32, device=device)
    _check("tols", tols, torch.float32, (2,), device)
    return npad, s, tols


def _launch(entry: str, body_flat, b12, cw, counts, tols, ints) -> tuple:
    """Launches the C entry ``entry`` on fresh outputs: (table', acc,
    residual).  ``ints`` are its int arguments after the pointers."""
    device = body_flat.device
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")
    lib, _ = build()
    body_out = body_flat.clone()
    acc = torch.zeros((b12.numel() * 2,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(
            body_out.data_ptr(), b12.data_ptr(), cw.data_ptr(),
            acc.data_ptr(), res.data_ptr(), counts.data_ptr(),
            tols.data_ptr(), *(int(x) for x in ints), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return body_out, acc, res


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
    plain version.  ``solve_contacts_tiled2.launches`` counts kernel
    launches."""
    npad, s, tols = check_slab_inputs(
        body_flat, b12, cw, cum, n_slabs + 1, vel_iters, pos_iters, n_slabs,
        slab_stride, window_rows, tols)
    if body_flat.device.type == "cpu":
        return solve_contacts_tiled2_plain(
            body_flat, b12, cw, cum, vel_iters, pos_iters, n_slabs,
            slab_stride, window_rows, tols=tols)
    out = _launch("phyx_contact_solve_tiled2", body_flat, b12, cw, cum, tols,
                  (slab_stride, window_rows, n_slabs, s, vel_iters,
                   pos_iters))
    solve_contacts_tiled2.launches += 1
    return out


solve_contacts_tiled2.launches = 0


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
    plain version.  ``solve_contacts_tiled.launches`` counts kernel
    launches."""
    npad, s, tols = check_slab_inputs(
        body_flat, b12, cw, slab_counts, 2 * n_slabs, vel_iters, pos_iters,
        n_slabs, slab_stride, window_rows, tols)
    if s % n_slabs or not 0 <= j_slots < s // n_slabs:
        raise ValueError(f"{s} slots do not split into {n_slabs} slabs "
                         f"with {j_slots} joint slots each and contact slots")
    if body_flat.device.type == "cpu":
        return solve_contacts_tiled_plain(
            body_flat, b12, cw, slab_counts, vel_iters, pos_iters, n_slabs,
            slab_stride, window_rows, j_slots, tols=tols)
    out = _launch("phyx_contact_solve_tiled", body_flat, b12, cw,
                  slab_counts, tols,
                  (slab_stride, window_rows, n_slabs,
                   s // n_slabs - j_slots, j_slots, vel_iters, pos_iters))
    solve_contacts_tiled.launches += 1
    return out


solve_contacts_tiled.launches = 0


def _walk_segments(body_flat, b12, cw, segments, vel_iters, pos_iters,
                   slab_stride, window_rows, tols):
    """``plain_walk`` over ``solve_slabs``'s order: for each slab s, its
    contact slots then its joint slots (``segments[s]`` = (contact slots,
    joint slots)), with table rows s*stride + the local row clamped into
    [0, window_rows)."""
    ids = b12.reshape(-1, 2).tolist()
    visits = []
    for s, (contact, joint) in enumerate(segments):
        base = s * slab_stride
        for slots, is_joint in ((contact, False), (joint, True)):
            for k in slots:
                i, j = (base + min(max(x, 0), window_rows - 1)
                        for x in ids[k])
                visits.append((k, i, j, is_joint))
    rows = cw.reshape(-1, 14)
    return plain_walk(body_flat.reshape(-1, 8), rows[:, :12], rows[:, 12:],
                      visits, vel_iters, pos_iters, tols)


def solve_contacts_tiled2_plain(body_flat, b12, cw, cum, vel_iters: int,
                                pos_iters: int, n_slabs: int,
                                slab_stride: int, window_rows: int,
                                tols=None):
    """K3's plain version (see the module docstring).  It reads ``cum`` and
    the rows back to the host: for tests and comparison with the kernel."""
    s = b12.numel() // 2
    cuts = cum.tolist()
    segments = []
    for k in range(n_slabs):
        c0 = min(max(cuts[k], 0), s)
        c1 = min(max(cuts[k + 1], c0), s)
        segments.append((range(c0, c1), ()))
    return _walk_segments(body_flat, b12, cw, segments, vel_iters, pos_iters,
                          slab_stride, window_rows, tols)


def solve_contacts_tiled_plain(body_flat, b12, cw, slab_counts,
                               vel_iters: int, pos_iters: int, n_slabs: int,
                               slab_stride: int, window_rows: int,
                               j_slots: int = 0, tols=None):
    """K5's plain version (see the module docstring).  It reads the counts
    and the rows back to the host: for tests and comparison with the
    kernel."""
    per = b12.numel() // 2 // n_slabs
    c_slots = per - j_slots
    counts = slab_counts.tolist()

    def live(x, cap):
        return min(max(x, 0), cap)

    segments = []
    for k in range(n_slabs):
        c0 = k * per
        segments.append((
            range(c0, c0 + live(counts[k], c_slots)),
            range(c0 + c_slots, c0 + c_slots
                  + live(counts[n_slabs + k], j_slots))))
    return _walk_segments(body_flat, b12, cw, segments, vel_iters, pos_iters,
                          slab_stride, window_rows, tols)
