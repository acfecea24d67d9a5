"""The solve with the body table in device memory: warm start, velocity
passes, displacement passes, in the exact Gauss-Seidel order of the oracle,
over contact rows and then user-joint rows, run level by level.

Counterpart of ``phyx_tpu/kernels/contact_solver_streamed.py``
(``_streamed_kernel``, ``solve_contacts_streamed``).  The kernel is
``csrc/contact_solver_streamed.cu``: a pre-pass gives every live visit a
level in the visits' dependency graph (``visit_levels`` here computes the
same levels), then one block runs each pass level by level, the visits of
a level (which touch disjoint bodies) side by side.  The pre-pass and the
level solve are ``csrc/levels.cuh``'s, shared with the tiled kernels K3
and K5 (``kernels/contact_solver_tiled.py``), which level their slab walk
with ``levels_of`` and ``levels_walk`` here, and with the fused kernel K2
(``kernels/contact_solver.py``), which runs K1's schedule with its state
in shared memory.  Its visits are those of ``csrc/solve_rows.cuh``.  Built
with ``nvcc`` at first use (``kernels/nvcc.py``) and called through
``ctypes``.

* ``solve_contacts_streamed`` is the wrapper: on CUDA tensors it launches
  the kernel (or raises); on CPU tensors it runs the plain version.
* ``solve_contacts_streamed_plain`` is the plain version of both kernels:
  the same visits in the serial order as scalar float32 torch operations.
  Each visit's arithmetic is written in the kernels' order, and they are
  built with ``-fmad=false``, so all three agree to the bit on the same
  inputs.  Its walk, ``plain_walk``, also serves the plain versions of
  the tiled kernels (``kernels/contact_solver_tiled.py``), which visit in
  another order.
* ``solve_contacts_levels_plain`` is a second plain version: the same solve
  level by level, one vectorised torch operation per scalar operation, with
  the kernels' free rows (``free_rows``, ``freed_walk``).  It equals the
  first to the bit.

Layout (flat, as in the reference): body rows ``(N*8,)`` f32 of
``[vx, vy, w, inv_mass, inv_inertia, dvx, dvy, dw]``; plain body ids
``b1``/``b2`` ``(R,)`` int32 (the kernels clamp them into ``[0, N)`` and
compute row offsets); rows ``con`` ``(R*12,)`` f32 and warm impulses
``(R*2,)`` f32.  Slots ``[0, c_cap)`` are contact rows ``[nx, ny, r1x, r1y,
r2x, r2y, mass_n, mass_t, friction, dst_v, dst_dv, c_nt]``, of which
``[0, num_contacts)`` are visited; slots ``[c_cap, R)`` are joint rows
(encodings in ``joints.py``), of which ``[c_cap, c_cap + num_joints)`` are
visited after the contacts in every pass.  Returns the updated body rows,
the accumulators ``(R*4,)`` (contacts: normal, tangent, displacement,
unused; joints: velocity impulse x, y, displacement impulse x, y; zero in
slots not visited) and the residual ``(1,)``: the max |impulse delta| of
the last executed velocity pass, contacts and joints.

Gates: from the second velocity pass on, a pass is skipped once the
previous executed pass's residual is below ``tols[0]``; displacement
passes likewise with their own residual and ``tols[1]``.  A threshold of
0.0 never fires; ``tols=None`` is ungated.

Free rows (``csrc/levels.cuh``): a body row whose 8 columns are all +0.0
bits (a static at rest, such as the pile's ground) is no node of the level
graph while every write to it is +0.0, which holds while every product
written to it is finite; the level solve computes those writes, checks
them and stores none, and where one is not +0.0 the solve runs again over
the full graph from its input.  Each call's counters stay on the device
(``COUNTERS``), the latest call's at ``solve_contacts_streamed.stats``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import count_launch, nvcc

SOURCE = nvcc.CSRC / "contact_solver_streamed.cu"

# 12 N bytes of working columns, beside 1 KB of the block's own, within
# one block's 227 KB of shared memory: N <= 19,285
SMEM_COLS_MAX = 232_448 - 1_024
# the pre-pass's last-level array, 4 N bytes: N <= 51,200
SMEM_LAST_MAX = 200 * 1_024
# a solve's counters, in the order of its stats tensor (csrc/levels.cuh):
# levels a pass, visits a pass, visits with a free endpoint, and whether
# the rerun over the full graph ran (0 or 1)
COUNTERS = ("levels", "visits", "freed_visits", "fallbacks")


def placement(n: int) -> dict:
    """Where the kernel keeps its per-body arrays for ``n`` bodies: in
    shared memory where they fit one block, else in device memory."""
    return dict(smem_last=4 * n <= SMEM_LAST_MAX,
                smem_cols=12 * n <= SMEM_COLS_MAX)


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    fn = lib.phyx_contact_solve_streamed
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.phyx_visit_levels
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, report


def _scratch(n: int, r: int, device) -> tuple:
    """The kernel's scratch: 4 R + N + 4 int32 (levels, level offsets,
    cursors, row slots, per-body last levels and the walk's zero and sink
    slots), 24 R f32 (the records and accumulators in level order) and the
    call's counters (``COUNTERS``, int32, written by the kernel)."""
    return (torch.empty((4 * r + n + 4,), dtype=torch.int32, device=device),
            torch.empty((24 * r,), dtype=torch.float32, device=device),
            torch.empty((len(COUNTERS),), dtype=torch.int32, device=device))


def _check(name, t, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check_inputs(body_flat, b1, b2, con_flat, warm_flat, num_contacts,
                 vel_iters, pos_iters, num_joints, c_cap, tols) -> tuple:
    """Checks the solve's inputs (metadata only: nothing is read back).
    Returns (n, r, c_cap, tols), with ``tols`` made a (2,) tensor on the
    device (zeros, which never fire, when ungated)."""
    device = body_flat.device
    n = body_flat.numel() // 8
    r = b1.numel()
    _check("body_flat", body_flat, torch.float32, (n * 8,), device)
    _check("b1", b1, torch.int32, (r,), device)
    _check("b2", b2, torch.int32, (r,), device)
    _check("con_flat", con_flat, torch.float32, (r * 12,), device)
    _check("warm_flat", warm_flat, torch.float32, (r * 2,), device)
    _check("num_contacts", num_contacts, torch.int32, (), device)
    if num_joints is not None:
        _check("num_joints", num_joints, torch.int32, (), device)
    c_cap = r if c_cap is None else int(c_cap)
    if not 0 <= c_cap <= r:
        raise ValueError(f"c_cap {c_cap} outside [0, {r}]")
    if num_joints is None and c_cap != r:
        raise ValueError("joint slots given without num_joints")
    if n == 0 or vel_iters < 0 or pos_iters < 0:
        raise ValueError("need at least one body and non-negative passes")
    if tols is None:
        # a fill on the device, not a host-to-device copy per frame
        tols = torch.zeros((2,), dtype=torch.float32, device=device)
    _check("tols", tols, torch.float32, (2,), device)
    return n, r, c_cap, tols


def solve_contacts_streamed(
    body_flat: torch.Tensor,      # (N*8,) f32
    b1: torch.Tensor,             # (R,) int32 body ids
    b2: torch.Tensor,             # (R,) int32
    con_flat: torch.Tensor,       # (R*12,) f32
    warm_flat: torch.Tensor,      # (R*2,) f32
    num_contacts: torch.Tensor,   # () int32, on the device: never read back
    vel_iters: int,
    pos_iters: int,
    num_joints: Optional[torch.Tensor] = None,   # () int32, on the device
    c_cap: Optional[int] = None,  # contact slots; joint slots at [c_cap, R)
    tols: Optional[torch.Tensor] = None,   # (2,) f32 [vel, pos] thresholds
):
    """Returns (body_flat', acc (R*4,), residual (1,)) — see the module
    docstring.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.  ``solve_contacts_streamed.launches`` counts kernel launches,
    ``solve_contacts_streamed.stats`` holds the latest launch's counters
    (``COUNTERS``, on the device)."""
    args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap)
    n, r, c_cap, tols = check_inputs(*args, tols)
    device = body_flat.device
    if device.type == "cpu":
        return solve_contacts_streamed_plain(*args, tols=tols)
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")

    *out, solve_contacts_streamed.stats = _launch(*args[:9], c_cap, tols,
                                                  **placement(n))
    count_launch(solve_contacts_streamed)
    return tuple(out)


solve_contacts_streamed.launches = 0
solve_contacts_streamed.stats = None
solve_contacts_streamed.counter_names = COUNTERS


def _launch(body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap, tols, smem_last: bool,
            smem_cols: bool):
    """Launches the kernel on checked CUDA inputs with its per-body arrays
    placed as given.  The wrapper places them by ``placement``; a check on
    the card also runs the placements in device memory at shapes where
    they would fit shared memory.  Not counted in the launches.  Returns
    (body', acc, residual, the call's counters)."""
    n = body_flat.numel() // 8
    r = b1.numel()
    device = body_flat.device
    lib, _ = build()
    body_out = body_flat.clone()
    acc = torch.zeros((r * 4,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    iscratch, fscratch, stats = _scratch(n, r, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phyx_contact_solve_streamed(
            body_out.data_ptr(), body_flat.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), con_flat.data_ptr(), warm_flat.data_ptr(),
            acc.data_ptr(), res.data_ptr(), num_contacts.data_ptr(),
            None if num_joints is None else num_joints.data_ptr(),
            tols.data_ptr(), stats.data_ptr(), n, c_cap, r - c_cap,
            int(vel_iters), int(pos_iters), iscratch.data_ptr(),
            fscratch.data_ptr(), int(smem_last), int(smem_cols), stream)
    if err != 0:
        raise RuntimeError(f"streamed solve kernel launch failed: CUDA "
                           f"error {err}")
    return body_out, acc, res, stats


def solve_in_device_memory(body_flat, b1, b2, con_flat, warm_flat,
                           num_contacts, vel_iters, pos_iters,
                           num_joints=None, c_cap=None, tols=None):
    """The kernel with both per-body arrays in device memory, whatever
    ``N``: the placement the wrapper takes above N = 51,200 (and its
    columns' above 19,285), for checking it on the card at any frame
    against the wrapper.  CUDA tensors only; not counted in the
    launches."""
    args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap)
    n, r, c_cap, tols = check_inputs(*args, tols)
    if body_flat.device.type != "cuda":
        raise ValueError("solve_in_device_memory launches the kernel: CUDA "
                         "tensors only")
    return _launch(*args[:9], c_cap, tols, smem_last=False,
                   smem_cols=False)[:3]


def prepass(body_flat, b1, b2, con_flat, warm_flat, num_contacts,
            num_joints=None, c_cap=None, smem_last=None, **_) -> dict:
    """The kernel's pre-pass alone (free rows no nodes), on CUDA tensors
    (the solve's own arguments; the passes are ignored): for timing it
    apart from the solve and checking its levels against ``visit_levels``
    with ``free_rows(body_flat)``.  Not counted in
    ``solve_contacts_streamed.launches``.  Returns device tensors:
    ``level`` (R,) int32, each live visit's level in serial order (the
    first ``offsets[-1]`` entries), ``offsets`` (R + 1,) int32 (the first
    ``n_levels + 1`` entries), ``n_levels`` (1,) int32, ``slots`` (R,) int32
    the row slot of each record in level order (the order inside a level
    is the scatter's), ``stats`` the counters (``COUNTERS``; no fallback is
    run).  ``smem_last`` overrides where the last-level array sits
    (default: ``placement``)."""
    n, r, c_cap, _ = check_inputs(body_flat, b1, b2, con_flat, warm_flat,
                                  num_contacts, 0, 0, num_joints, c_cap,
                                  None)
    device = body_flat.device
    if device.type != "cuda":
        raise ValueError("prepass launches the kernel: CUDA tensors only")
    if smem_last is None:
        smem_last = placement(n)["smem_last"]
    lib, _ = build()
    iscratch, fscratch, stats = _scratch(n, r, device)
    with torch.cuda.device(device):
        err = lib.phyx_visit_levels(
            b1.data_ptr(), b2.data_ptr(), con_flat.data_ptr(),
            warm_flat.data_ptr(), body_flat.data_ptr(),
            num_contacts.data_ptr(),
            None if num_joints is None else num_joints.data_ptr(),
            stats.data_ptr(), n, c_cap, r - c_cap, iscratch.data_ptr(),
            fscratch.data_ptr(), int(smem_last),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"level pre-pass launch failed: CUDA error {err}")
    return scratch_levels(iscratch, r, stats)


def scratch_levels(iscratch, r: int, stats) -> dict:
    """The pre-pass's outputs in its int scratch (``_scratch``) for ``r``
    row slots, with the call's counters (see ``prepass``)."""
    return dict(level=iscratch[:r], offsets=iscratch[2 * r:3 * r + 1],
                n_levels=iscratch[3 * r + 1:3 * r + 2],
                slots=iscratch[3 * r + 2:4 * r + 2], stats=stats)


def solve_contacts_streamed_plain(
    body_flat, b1, b2, con_flat, warm_flat, num_contacts,
    vel_iters: int, pos_iters: int, num_joints=None, c_cap=None, tols=None,
):
    """The plain version: the kernels' visits, in their order, as scalar
    float32 torch operations on the tensors' own device.  It reads the
    counts, ids and joint kinds back to the host, so it is for tests and
    for comparison with the kernels, never for the main path on the
    card."""
    n = body_flat.numel() // 8
    r = b1.numel()
    c_cap = r if c_cap is None else int(c_cap)
    num = min(max(int(num_contacts), 0), c_cap)
    numj = 0 if num_joints is None else min(max(int(num_joints), 0),
                                            r - c_cap)
    slots = list(range(num)) + list(range(c_cap, c_cap + numj))
    ids1 = [min(max(i, 0), n - 1) for i in b1[slots].tolist()]
    ids2 = [min(max(j, 0), n - 1) for j in b2[slots].tolist()]
    visits = [(k, i, j, q >= num)
              for q, (k, i, j) in enumerate(zip(slots, ids1, ids2))]
    return plain_walk(body_flat.reshape(n, 8), con_flat.reshape(r, 12),
                      warm_flat.reshape(r, 2), visits, vel_iters, pos_iters,
                      tols)


def plain_walk(table, con_rows, warm_rows, visits, vel_iters: int,
               pos_iters: int, tols=None):
    """The serial solve every kernel of this package runs, as scalar
    float32 torch operations: one warm pass, ``vel_iters`` velocity passes
    and ``pos_iters`` displacement passes, each walking ``visits`` in
    order.  A visit is (slot, body row i, body row j, joint row?): it reads
    ``con_rows[slot]`` (12 columns) and ``warm_rows[slot]`` (2) and
    updates rows i and j of ``table`` ((rows, 8)).  Gates as in the
    module docstring.  Returns (table' flat, acc (slots*4,) zero where not
    visited, residual (1,))."""
    device = table.device
    r = con_rows.shape[0]
    if tols is None:
        tols = torch.zeros((2,), dtype=torch.float32, device=device)
    vtol, ptol = tols.unbind()
    slots = [v[0] for v in visits]
    rows12 = con_rows[slots]
    con = [rows12[k].unbind() for k in range(len(slots))]
    warm = [w.unbind() for w in warm_rows[slots]]
    # joint kind per visit: True revolute, False distance, None a contact
    kinds = rows12[:, 11].tolist()
    rev = [(kinds[k] == 1.0) if v[3] else None
           for k, v in enumerate(visits)]
    ids1 = [v[1] for v in visits]
    ids2 = [v[2] for v in visits]
    rows = {}       # table row -> list of 8 scalar tensors (its live row)

    def row(i):
        if i not in rows:
            rows[i] = list(table[i].unbind())
        return rows[i]

    zero = torch.zeros((), dtype=torch.float32, device=device)
    acc = [[zero] * 4 for _ in slots]
    order = range(len(slots))

    def arms(k):
        """(r1x, r1y, r2x, r2y) of joint visit k."""
        c = con[k]
        return c[0:4] if rev[k] else c[2:6]

    def joint_apply(bi, bj, g, px, py, off):
        # every body value read afresh, as the kernels read it
        r1x, r1y, r2x, r2y = g
        im1, ii1, im2, ii2 = bi[3], bi[4], bj[3], bj[4]
        bi[off] = bi[off] - px * im1
        bi[off + 1] = bi[off + 1] - py * im1
        bi[off + 2] = bi[off + 2] - ii1 * (r1x * py - r1y * px)
        bj[off] = bj[off] + px * im2
        bj[off + 1] = bj[off + 1] + py * im2
        bj[off + 2] = bj[off + 2] + ii2 * (r2x * py - r2y * px)

    def contact_warm(k):
        nx, ny, r1x, r1y, r2x, r2y = con[k][:6]
        wn, wt = warm[k]
        px = nx * wn - ny * wt
        py = ny * wn + nx * wt
        bi, bj = row(ids1[k]), row(ids2[k])
        im1, ii1, im2, ii2 = bi[3], bi[4], bj[3], bj[4]
        bi[0] = bi[0] - px * im1
        bi[1] = bi[1] - py * im1
        bi[2] = bi[2] - ii1 * (r1x * py - r1y * px)
        bj[0] = bj[0] + px * im2
        bj[1] = bj[1] + py * im2
        bj[2] = bj[2] + ii2 * (r2x * py - r2y * px)
        acc[k] = [wn, wt, zero, zero]

    def joint_warm(k):
        c = con[k]
        wx, wy = warm[k]
        if rev[k]:
            px, py = wx, wy
        else:
            px, py = c[0] * wx, c[1] * wx
        joint_apply(row(ids1[k]), row(ids2[k]), arms(k), px, py, 0)
        acc[k] = [wx, wy if rev[k] else zero, zero, zero]

    def contact_vel(k):
        """Returns max(|dn|, |dt|)."""
        nx, ny, r1x, r1y, r2x, r2y, mn, mt, fr, dstv, _, ctn = con[k]
        bi, bj = row(ids1[k]), row(ids2[k])
        im1, ii1, im2, ii2 = bi[3], bi[4], bj[3], bj[4]
        vx1, vy1, w1 = bi[0], bi[1], bi[2]
        vx2, vy2, w2 = bj[0], bj[1], bj[2]
        dvx = vx2 - w2 * r2y - vx1 + w1 * r1y
        dvy = vy2 + w2 * r2x - vy1 - w1 * r1x
        vn = nx * dvx + ny * dvy
        vt = -ny * dvx + nx * dvy
        d = (dstv - vn) * mn
        a = acc[k][0]
        na = torch.maximum(a + d, zero)
        dn = na - a
        acc[k][0] = na
        d = -(vt + ctn * dn) * mt
        a = acc[k][1]
        mf = fr * na
        ta = torch.minimum(torch.maximum(a + d, -mf), mf)
        dt = ta - a
        acc[k][1] = ta
        px = nx * dn - ny * dt
        py = ny * dn + nx * dt
        bi[0] = vx1 - px * im1
        bi[1] = vy1 - py * im1
        bi[2] = w1 - ii1 * (r1x * py - r1y * px)
        bj[0] = vx2 + px * im2
        bj[1] = vy2 + py * im2
        bj[2] = w2 + ii2 * (r2x * py - r2y * px)
        return torch.maximum(torch.abs(dn), torch.abs(dt))

    def joint_vel(k):
        """Returns max(|px|, |py|)."""
        c = con[k]
        g = arms(k)
        r1x, r1y, r2x, r2y = g
        bi, bj = row(ids1[k]), row(ids2[k])
        vx1, vy1, w1 = bi[0], bi[1], bi[2]
        vx2, vy2, w2 = bj[0], bj[1], bj[2]
        dvx = vx2 - w2 * r2y - vx1 + w1 * r1y
        dvy = vy2 + w2 * r2x - vy1 - w1 * r1x
        a = acc[k]
        if rev[k]:          # impulse -(M dv)
            px = -(c[4] * dvx + c[5] * dvy)
            py = -(c[5] * dvx + c[6] * dvy)
            a[0] = a[0] + px
            a[1] = a[1] + py
        else:               # impulse -m (n.dv) n
            nx, ny = c[0], c[1]
            dd = -c[6] * (nx * dvx + ny * dvy)
            px = nx * dd
            py = ny * dd
            a[0] = a[0] + dd
            a[1] = a[1] + 0.0
        joint_apply(bi, bj, g, px, py, 0)
        return torch.maximum(torch.abs(px), torch.abs(py))

    def contact_pos(k):
        """Returns |d|."""
        nx, ny, r1x, r1y, r2x, r2y, mn = con[k][:7]
        ddv = con[k][10]
        bi, bj = row(ids1[k]), row(ids2[k])
        im1, ii1, im2, ii2 = bi[3], bi[4], bj[3], bj[4]
        px1, py1, q1 = bi[5], bi[6], bi[7]
        px2, py2, q2 = bj[5], bj[6], bj[7]
        dvx = px2 - q2 * r2y - px1 + q1 * r1y
        dvy = py2 + q2 * r2x - py1 - q1 * r1x
        vn = nx * dvx + ny * dvy
        d = (ddv - vn) * mn
        a = acc[k][2]
        na = torch.maximum(a + d, zero)
        d = na - a
        acc[k][2] = na
        ix = nx * d
        iy = ny * d
        bi[5] = px1 - ix * im1
        bi[6] = py1 - iy * im1
        bi[7] = q1 - ii1 * (r1x * iy - r1y * ix)
        bj[5] = px2 + ix * im2
        bj[6] = py2 + iy * im2
        bj[7] = q2 + ii2 * (r2x * iy - r2y * ix)
        return torch.abs(d)

    def joint_pos(k):
        """Returns max(|px|, |py|)."""
        c = con[k]
        g = arms(k)
        r1x, r1y, r2x, r2y = g
        bi, bj = row(ids1[k]), row(ids2[k])
        px1, py1, q1 = bi[5], bi[6], bi[7]
        px2, py2, q2 = bj[5], bj[6], bj[7]
        dvx = px2 - q2 * r2y - px1 + q1 * r1y
        dvy = py2 + q2 * r2x - py1 - q1 * r1x
        a = acc[k]
        if rev[k]:          # toward the target (dstx, dsty)
            ex = c[7] - dvx
            ey = c[8] - dvy
            px = c[4] * ex + c[5] * ey
            py = c[5] * ex + c[6] * ey
            a[2] = a[2] + px
            a[3] = a[3] + py
        else:               # toward the scalar target along n
            nx, ny = c[0], c[1]
            dd = c[6] * (c[7] - (nx * dvx + ny * dvy))
            px = nx * dd
            py = ny * dd
            a[2] = a[2] + dd
            a[3] = a[3] + 0.0
        joint_apply(bi, bj, g, px, py, 5)
        return torch.maximum(torch.abs(px), torch.abs(py))

    for k in order:
        (contact_warm if rev[k] is None else joint_warm)(k)

    res = zero
    converged = False
    for _ in range(vel_iters):
        if converged:
            continue
        res = zero
        for k in order:
            res = torch.maximum(
                res, (contact_vel if rev[k] is None else joint_vel)(k))
        converged = bool(res < vtol)

    converged = False
    for _ in range(pos_iters):
        if converged:
            continue
        pres = zero
        for k in order:
            pres = torch.maximum(
                pres, (contact_pos if rev[k] is None else joint_pos)(k))
        converged = bool(pres < ptol)

    table_out = table.clone()
    for i, vals in rows.items():
        table_out[i] = torch.stack(vals)
    acc_out = torch.zeros((r, 4), dtype=torch.float32, device=device)
    if slots:
        acc_out[slots] = torch.stack([torch.stack(a) for a in acc])
    return table_out.reshape(-1), acc_out.reshape(-1), res.reshape(1)


def free_rows(table) -> torch.Tensor:
    """The free rows of a body table ((rows * 8,) or (rows, 8) f32): those
    whose 8 columns are all +0.0 bits (-0.0 is not), (rows,) bool."""
    return (table.reshape(-1, 8).view(torch.int32) == 0).all(dim=1)


def visit_levels(b1, b2, num_contacts, num_joints, c_cap: int, n: int,
                 free=None):
    """The kernel's pre-pass as torch operations on the ids' device: the
    live visits in serial order (contact slots [0, num), then joint slots
    [c_cap, c_cap + numj)), ids clamped into [0, n) as the kernel clamps
    them, and each visit's level (``levels_of``; ``free``: the free rows,
    as the kernel's pre-pass takes them from its table, or None for the
    full graph).  Returns a dict: ``slots``, ``i``, ``j`` (visits,) int64,
    ``free`` as given and ``levels_of``'s ``level``, ``n_levels``,
    ``order``, ``offsets``."""
    device = b1.device
    r = b1.numel()
    num = min(max(int(num_contacts), 0), c_cap)
    numj = 0 if num_joints is None else min(max(int(num_joints), 0),
                                            r - c_cap)
    slots = torch.cat([torch.arange(num, device=device),
                       torch.arange(c_cap, c_cap + numj, device=device)])
    i = torch.clamp(b1[slots].long(), 0, n - 1)
    j = torch.clamp(b2[slots].long(), 0, n - 1)
    return dict(slots=slots, i=i, j=j, free=free, **levels_of(i, j, free))


def levels_of(i, j, free=None) -> dict:
    """The levels of visits in serial order whose body rows are ``i`` and
    ``j`` ((visits,) int64): ``level(k) = 1 + max(last[i], last[j])`` over
    the visits before it (``last[b]``: the level of the latest visit of
    row b, 0 before any).  Visits of one level touch disjoint rows, and two
    visits that share a row keep their serial order, so running the levels
    one after another, each level's visits in any order, repeats the serial
    solve operation for operation.  ``free`` ((rows,) bool, or None): rows
    that are no nodes, as the kernels' pre-pass walks its free rows: a
    free row adds 0 to a visit's level and its ``last`` never moves, so
    visits of one level may share a free row (``freed_walk`` says when
    that repeats the serial solve).

    Computed without the serial walk: each visit's predecessors are the
    previous visits of its two rows (a sort of the (row, visit)
    endpoints), and the levels are relaxed to their fixed point, one
    iteration per level.  Returns a dict: ``level`` (visits,) int64,
    1-based; ``n_levels``; ``order`` (visits,) int64, the visits by level,
    serial order inside a level (a stable sort); ``offsets``
    (n_levels + 1,) int64, level l's visits at
    ``order[offsets[l]:offsets[l + 1]]``."""
    device = i.device
    v = i.numel()
    visit = torch.arange(v, device=device)
    # endpoints sorted by (row, visit, side): an endpoint's predecessor is
    # the endpoint before it on the same row, unless that is the other
    # end of its own visit (a self pair), which adds no constraint
    body = torch.cat([i, j])
    if free is not None:
        # each endpoint on a free row a row of its own: no predecessor, and
        # no successor
        fresh = free.numel() + torch.arange(2 * v, device=device)
        body = torch.where(free[body], fresh, body)
    owner = torch.cat([visit, visit])
    key = (body * v + owner) * 2 + torch.cat([torch.zeros_like(visit),
                                              torch.ones_like(visit)])
    srt = torch.argsort(key)
    sb, sv = body[srt], owner[srt]
    pred = torch.full_like(sv, v)                 # v: "no predecessor"
    prev_ok = (sb[1:] == sb[:-1]) & (sv[1:] != sv[:-1])
    pred[1:] = torch.where(prev_ok, sv[:-1], v)
    pred_end = torch.empty_like(pred)
    pred_end[srt] = pred
    p1, p2 = pred_end[:v], pred_end[v:]
    level = torch.ones(v + 1, dtype=torch.int64, device=device)
    level[v] = 0
    while v:
        new = 1 + torch.maximum(level[p1], level[p2])
        if torch.equal(new, level[:v]):
            break
        level[:v] = new
    level = level[:v]
    n_levels = int(level.max()) if v else 0
    order = torch.sort(level, stable=True).indices
    counts = torch.bincount(level - 1, minlength=n_levels)
    offsets = torch.zeros(n_levels + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    return dict(level=level, n_levels=n_levels, order=order,
                offsets=offsets)


def solve_contacts_levels_plain(
    body_flat, b1, b2, con_flat, warm_flat, num_contacts,
    vel_iters: int, pos_iters: int, num_joints=None, c_cap=None, tols=None,
):
    """The second plain version: the solve of ``solve_contacts_streamed``
    run level by level over ``visit_levels`` with the table's free rows
    (``freed_walk``).  It equals ``solve_contacts_streamed_plain`` to the
    bit (a NaN residual may carry another payload).  It reads the counts
    and levels back to the host: for tests and for comparison with the
    kernel."""
    n = body_flat.numel() // 8
    r = b1.numel()
    c_cap = r if c_cap is None else int(c_cap)
    lv = visit_levels(b1, b2, num_contacts, num_joints, c_cap, n,
                      free_rows(body_flat))
    return freed_walk(body_flat.reshape(n, 8), con_flat.reshape(r, 12),
                      warm_flat.reshape(r, 2), lv, lv["slots"] >= c_cap,
                      vel_iters, pos_iters, tols)[:3]


def freed_walk(table, con_rows, warm_rows, lv, joint, vel_iters: int,
               pos_iters: int, tols=None) -> tuple:
    """The kernels' solve: ``levels_walk`` over ``lv``'s levels with its
    free rows (``lv["free"]``, as ``levels_of`` took them), and where a
    write to a free row is not +0.0, the fallback: ``levels_walk`` again
    from ``table`` over the full graph (``levels_of`` with no free rows).
    Returns (table' flat, acc, residual, fallback ran)."""
    out = levels_walk(table, con_rows, warm_rows, lv, joint, vel_iters,
                      pos_iters, tols)
    if not bool(out[3]):
        return out[:3] + (False,)
    full = dict(lv, free=None, **levels_of(lv["i"], lv["j"]))
    return levels_walk(table, con_rows, warm_rows, full, joint, vel_iters,
                       pos_iters, tols)[:3] + (True,)


def levels_walk(table, con_rows, warm_rows, lv, joint, vel_iters: int,
                pos_iters: int, tols=None):
    """The serial solve of ``plain_walk`` run level by level: ``lv`` holds
    the visits in serial order (``slots``, body rows ``i``, ``j``) and
    their levels (``levels_of``), ``joint`` (visits,) bool marks joint
    rows.  Each level's visits of one kind (contact, revolute joint,
    distance joint) run as one vectorised torch operation per scalar
    operation of the visit, in the visit's order.  Visits of one level
    touch disjoint rows, so this is the serial solve's arithmetic on the
    serial solve's operands: it equals ``plain_walk`` over the same visits
    to the bit (a NaN residual may carry another payload).

    Where ``lv["free"]`` is given (the free rows ``levels_of`` took), the
    visits of a level may share a free row: its writes are computed as
    before and not stored (the row keeps its +0.0, which every read
    sees), and any whose bits are not +0.0 is flagged.  The result equals
    ``plain_walk``'s where nothing was flagged (``freed_walk``).  Returns
    (table' flat, acc (slots*4,) zero where not visited, residual (1,),
    flagged: a () bool tensor)."""
    device = table.device
    r = con_rows.shape[0]
    if tols is None:
        tols = torch.zeros((2,), dtype=torch.float32, device=device)
    vtol, ptol = tols.unbind()
    free = lv.get("free")
    # kind per visit: 0 contact, 1 revolute joint, 2 distance joint
    kind = torch.where(~joint, 0,
                       torch.where(con_rows[lv["slots"], 11] == 1.0, 1, 2))
    # each level's visits grouped by kind: (kind, slots, i, j, con columns,
    # warm columns), serial order inside a group
    levels = []
    order = lv["order"]
    key = lv["level"][order] * 3 + kind[order]
    order = order[torch.sort(key, stable=True).indices]
    counts = torch.bincount(lv["level"][order] * 3 + kind[order] - 3,
                            minlength=3 * lv["n_levels"]).tolist()
    start = 0
    for lvl in range(lv["n_levels"]):
        groups = []
        for k in range(3):
            m = counts[3 * lvl + k]
            if m:
                sel = order[start:start + m]
                s = lv["slots"][sel]
                i, j = lv["i"][sel], lv["j"][sel]
                groups.append((k, s, (i, None if free is None else free[i]),
                               (j, None if free is None else free[j]),
                               con_rows[s].unbind(1), warm_rows[s].unbind(1)))
                start += m
        levels.append(groups)

    cols = [c.clone() for c in table.unbind(1)]
    acc = torch.zeros((r, 4), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    flagged = torch.zeros((), dtype=torch.bool, device=device)

    # a body is (its rows, which of them are free, or None); the rows are
    # read through col (a free row holds +0.0 throughout) and written
    # through put
    def col(c, b):
        return cols[c][b[0]]

    def put(c, b, x):
        nonlocal flagged
        rows, fr = b
        if fr is None:
            cols[c][rows] = x
            return
        flagged = flagged | (torch.where(fr, x, zero).view(torch.int32)
                             != 0).any()
        cols[c][rows] = torch.where(fr, zero, x)

    def apply(i, j, g, px, py, off, im1, ii1, im2, ii2):
        # every body value read afresh, as the kernels read it: body j's
        # columns after body i's writes (a self pair sees them)
        r1x, r1y, r2x, r2y = g
        put(off, i, col(off, i) - px * im1)
        put(off + 1, i, col(off + 1, i) - py * im1)
        put(off + 2, i, col(off + 2, i) - ii1 * (r1x * py - r1y * px))
        put(off, j, col(off, j) + px * im2)
        put(off + 1, j, col(off + 1, j) + py * im2)
        put(off + 2, j, col(off + 2, j) + ii2 * (r2x * py - r2y * px))

    def masses(i, j):
        return col(3, i), col(4, i), col(3, j), col(4, j)

    # the kernels' max_p / min_p (solve_rows.cuh), ties and NaNs included,
    # whatever path torch takes: a vectorised torch.maximum may return the
    # other of two zeros where the scalar one keeps the first
    def max_p(a, b):
        return torch.where(torch.isnan(a), a, torch.where(
            torch.isnan(b), b, torch.where(a < b, b, a)))

    def min_p(a, b):
        return torch.where(torch.isnan(a), a, torch.where(
            torch.isnan(b), b, torch.where(b < a, b, a)))

    def arms(k, c):
        return c[0:4] if k == 1 else c[2:6]

    def warm_pass(group):
        k, s, i, j, c, w = group
        if k == 0:
            nx, ny = c[0], c[1]
            wn, wt = w
            px = nx * wn - ny * wt
            py = ny * wn + nx * wt
            apply(i, j, c[2:6], px, py, 0, *masses(i, j))
            acc[s, 0] = wn
            acc[s, 1] = wt
            return
        wx, wy = w
        if k == 1:
            px, py = wx, wy
        else:
            px, py = c[0] * wx, c[1] * wx
        apply(i, j, arms(k, c), px, py, 0, *masses(i, j))
        acc[s, 0] = wx
        acc[s, 1] = wy if k == 1 else zero

    def vel_pass(group):
        """Returns the group's max(|dn|, |dt|) or max(|px|, |py|)."""
        k, s, i, j, c, _ = group
        if k == 0:
            nx, ny, r1x, r1y, r2x, r2y, mn, mt, fr, dstv, _, ctn = c
            im1, ii1, im2, ii2 = masses(i, j)
            vx1, vy1, w1 = col(0, i), col(1, i), col(2, i)
            vx2, vy2, w2 = col(0, j), col(1, j), col(2, j)
            dvx = vx2 - w2 * r2y - vx1 + w1 * r1y
            dvy = vy2 + w2 * r2x - vy1 - w1 * r1x
            vn = nx * dvx + ny * dvy
            vt = -ny * dvx + nx * dvy
            d = (dstv - vn) * mn
            a = acc[s, 0]
            na = max_p(a + d, zero)
            dn = na - a
            acc[s, 0] = na
            d = -(vt + ctn * dn) * mt
            a = acc[s, 1]
            mf = fr * na
            ta = min_p(max_p(a + d, -mf), mf)
            dt = ta - a
            acc[s, 1] = ta
            px = nx * dn - ny * dt
            py = ny * dn + nx * dt
            put(0, i, vx1 - px * im1)
            put(1, i, vy1 - py * im1)
            put(2, i, w1 - ii1 * (r1x * py - r1y * px))
            put(0, j, vx2 + px * im2)
            put(1, j, vy2 + py * im2)
            put(2, j, w2 + ii2 * (r2x * py - r2y * px))
            return torch.maximum(torch.abs(dn), torch.abs(dt)).max()
        r1x, r1y, r2x, r2y = arms(k, c)
        vx1, vy1, w1 = col(0, i), col(1, i), col(2, i)
        vx2, vy2, w2 = col(0, j), col(1, j), col(2, j)
        dvx = vx2 - w2 * r2y - vx1 + w1 * r1y
        dvy = vy2 + w2 * r2x - vy1 - w1 * r1x
        if k == 1:          # impulse -(M dv)
            px = -(c[4] * dvx + c[5] * dvy)
            py = -(c[5] * dvx + c[6] * dvy)
            acc[s, 0] = acc[s, 0] + px
            acc[s, 1] = acc[s, 1] + py
        else:               # impulse -m (n.dv) n
            nx, ny = c[0], c[1]
            dd = -c[6] * (nx * dvx + ny * dvy)
            px = nx * dd
            py = ny * dd
            acc[s, 0] = acc[s, 0] + dd
            acc[s, 1] = acc[s, 1] + 0.0
        apply(i, j, (r1x, r1y, r2x, r2y), px, py, 0, *masses(i, j))
        return torch.maximum(torch.abs(px), torch.abs(py)).max()

    def pos_pass(group):
        """Returns the group's max |d| or max(|px|, |py|)."""
        k, s, i, j, c, _ = group
        if k == 0:
            nx, ny, r1x, r1y, r2x, r2y, mn = c[:7]
            ddv = c[10]
            im1, ii1, im2, ii2 = masses(i, j)
            px1, py1, q1 = col(5, i), col(6, i), col(7, i)
            px2, py2, q2 = col(5, j), col(6, j), col(7, j)
            dvx = px2 - q2 * r2y - px1 + q1 * r1y
            dvy = py2 + q2 * r2x - py1 - q1 * r1x
            vn = nx * dvx + ny * dvy
            d = (ddv - vn) * mn
            a = acc[s, 2]
            na = max_p(a + d, zero)
            d = na - a
            acc[s, 2] = na
            ix = nx * d
            iy = ny * d
            put(5, i, px1 - ix * im1)
            put(6, i, py1 - iy * im1)
            put(7, i, q1 - ii1 * (r1x * iy - r1y * ix))
            put(5, j, px2 + ix * im2)
            put(6, j, py2 + iy * im2)
            put(7, j, q2 + ii2 * (r2x * iy - r2y * ix))
            return torch.abs(d).max()
        r1x, r1y, r2x, r2y = arms(k, c)
        px1, py1, q1 = col(5, i), col(6, i), col(7, i)
        px2, py2, q2 = col(5, j), col(6, j), col(7, j)
        dvx = px2 - q2 * r2y - px1 + q1 * r1y
        dvy = py2 + q2 * r2x - py1 - q1 * r1x
        if k == 1:          # toward the target (dstx, dsty)
            ex = c[7] - dvx
            ey = c[8] - dvy
            px = c[4] * ex + c[5] * ey
            py = c[5] * ex + c[6] * ey
            acc[s, 2] = acc[s, 2] + px
            acc[s, 3] = acc[s, 3] + py
        else:               # toward the scalar target along n
            nx, ny = c[0], c[1]
            dd = c[6] * (c[7] - (nx * dvx + ny * dvy))
            px = nx * dd
            py = ny * dd
            acc[s, 2] = acc[s, 2] + dd
            acc[s, 3] = acc[s, 3] + 0.0
        apply(i, j, (r1x, r1y, r2x, r2y), px, py, 5, *masses(i, j))
        return torch.maximum(torch.abs(px), torch.abs(py)).max()

    for groups in levels:
        for group in groups:
            warm_pass(group)

    res = zero
    converged = False
    for _ in range(vel_iters):
        if converged:
            continue
        res = zero
        for groups in levels:
            for group in groups:
                res = torch.maximum(res, vel_pass(group))
        converged = bool(res < vtol)

    converged = False
    for _ in range(pos_iters):
        if converged:
            continue
        pres = zero
        for groups in levels:
            for group in groups:
                pres = torch.maximum(pres, pos_pass(group))
        converged = bool(pres < ptol)

    return (torch.stack(cols, 1).reshape(-1), acc.reshape(-1),
            res.reshape(1), flagged)
