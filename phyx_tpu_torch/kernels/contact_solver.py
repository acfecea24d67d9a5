"""K2, the fused solve: the streamed kernel's function in one block, run
level by level with every operand of a visit on chip.

Counterpart of ``phyx_tpu/kernels/contact_solver.py`` (``_solver_kernel``,
``solve_contacts_fused``).  The kernel is ``csrc/contact_solver.cu``: in
one launch of one block, the pre-pass of ``csrc/levels.cuh`` over K1's
visit map levels the live visits and buckets them into records in level
order (K1's schedule, so K1 and K2 agree to the bit), then each pass runs
level by level with the working columns, the level offsets and (where they
fit) the accumulators in shared memory, while a producer warp streams the
records into a ring of shared memory with bulk copies.  A level of at most
``NARROW`` visits is one warp's; a wider one takes all ``SOLVERS`` solving
threads, ``SOLVERS`` records a step.  Inputs, outputs and gates are those
of ``kernels/contact_solver_streamed.py`` (see its docstring), and so is
the plain version of the function.

* ``solve_contacts_fused`` is the wrapper: CUDA tensors launch the kernel
  (or raise); CPU tensors take ``solve_contacts_fused_plain``.
* ``fused_steps``, ``ring_schedule`` and
  ``solve_contacts_fused_levels_plain`` are the plain version of the
  kernel's schedule: the narrow/wide split of a level list into steps, the
  ring's order of records (which stage each slot holds when a step reads
  it), and the solve run step by step; it equals the serial plain version
  to the bit.
* ``fused_smem_bytes`` and ``fits`` are the tier rule: whether a body and
  row capacity take this kernel (the step picks it or the streamed one by
  ``fits`` alone).  ``fused_layout`` places the kernel's arrays in one
  block's shared memory from the capacities.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import count_launch, nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    check_inputs, levels_walk, solve_contacts_streamed_plain, visit_levels)

SOURCE = nvcc.CSRC / "contact_solver.cu"
# the most dynamic shared memory one block of an H100 can use
SMEM_LIMIT = 232_448
# the kernel's constants (csrc/contact_solver.cu)
SOLVERS = 128          # solving threads
NARROW = 32            # the widest level one warp solves
STAGE = 32             # records a ring stage (80 bytes a record)
STAGES = 16            # the ring's stages
_SMEM_DYNAMIC = SMEM_LIMIT - 1_024

# the two kernels compute one function: one plain version serves both
solve_contacts_fused_plain = solve_contacts_streamed_plain


def fused_smem_bytes(n_cap: int, r_cap: int) -> int:
    """The tier rule's measure: a body table (N x 8 f32) and accumulators
    (R x 4 f32), R = contact slots + joint slots."""
    return 4 * (8 * n_cap + 4 * r_cap)


def fits(n_cap: int, r_cap: int) -> bool:
    return fused_smem_bytes(n_cap, r_cap) <= SMEM_LIMIT


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def _smem_total(n: int, r: int, acc_smem: bool) -> int:
    """``layout`` of csrc/contact_solver.cu: the stages' barriers, the
    ring (the pre-pass's last-level array while it runs), the columns, the
    accumulators (``acc_smem``), the level offsets."""
    ring = max(STAGES * STAGE * 80, 4 * n)
    return (_up16(16 * STAGES) + _up16(ring) + _up16(12 * n)
            + (16 * r if acc_smem else 0) + _up16(4 * (r + 1)))


def fused_layout(n_cap: int, r_cap: int) -> dict:
    """Where the kernel keeps its arrays for ``n_cap`` bodies and ``r_cap``
    row slots, from the capacities alone: the accumulators in shared memory
    where they fit beside the ring, else in device memory.  Returns
    ``acc_smem``, ``stages``, ``ring_bytes`` and ``smem_bytes``.  Every
    capacity that ``fits`` fits (at most 87 KB without the
    accumulators)."""
    acc_smem = _smem_total(n_cap, r_cap, True) <= _SMEM_DYNAMIC
    return dict(acc_smem=acc_smem, stages=STAGES,
                ring_bytes=STAGES * STAGE * 80,
                smem_bytes=_smem_total(n_cap, r_cap, acc_smem))


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    fn = lib.phyx_contact_solve_fused
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, report


def solve_contacts_fused(
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
    """Returns (body_flat', acc (R*4,), residual (1,)), as
    ``solve_contacts_streamed`` does.  CUDA tensors launch the kernel, and
    raise when the capacities do not fit one block (``fits``); CPU tensors
    take the plain version.  ``solve_contacts_fused.launches`` counts
    launches."""
    args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap)
    n, r, c_cap, tols = check_inputs(*args, tols)
    device = body_flat.device
    if device.type == "cpu":
        return solve_contacts_fused_plain(*args, tols=tols)
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")
    out = _launch(*args[:9], c_cap, tols, solve=True)
    count_launch(solve_contacts_fused)
    return out


solve_contacts_fused.launches = 0


def fused_prepass(body_flat, b1, b2, con_flat, warm_flat, num_contacts,
                  num_joints=None, c_cap=None, **_) -> None:
    """The kernel's pre-pass alone (its launch with the solve switched
    off), on CUDA tensors, for timing it apart from the solve; the solve's
    own arguments, the passes ignored.  Not counted in the launches."""
    args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts, 0, 0,
            num_joints, c_cap)
    _, _, c_cap, tols = check_inputs(*args, None)
    if body_flat.device.type != "cuda":
        raise ValueError("fused_prepass launches the kernel: CUDA tensors "
                         "only")
    _launch(*args[:9], c_cap, tols, solve=False)


def _launch(body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap, tols, solve: bool):
    """One launch of the kernel on checked CUDA inputs, its arrays placed
    by ``fused_layout``; scratch from ``torch.empty``."""
    n = body_flat.numel() // 8
    r = b1.numel()
    device = body_flat.device
    if not fits(n, r):
        raise ValueError(
            f"{n} bodies and {r} rows need {fused_smem_bytes(n, r)} bytes "
            f"of shared memory, over the {SMEM_LIMIT} of one block: use "
            "the streamed kernel")
    place = fused_layout(n, r)
    lib, _ = build()
    # the kernel writes every element of its outputs
    body_out = torch.empty_like(body_flat)
    acc = torch.empty((r * 4,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    iscratch = torch.empty((3 * r,), dtype=torch.int32, device=device)
    fscratch = torch.empty(((20 if place["acc_smem"] else 24) * r,),
                           dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phyx_contact_solve_fused(
            body_flat.data_ptr(), body_out.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), con_flat.data_ptr(), warm_flat.data_ptr(),
            acc.data_ptr(), res.data_ptr(), num_contacts.data_ptr(),
            None if num_joints is None else num_joints.data_ptr(),
            tols.data_ptr(), n, c_cap, r - c_cap, int(vel_iters),
            int(pos_iters), iscratch.data_ptr(), fscratch.data_ptr(),
            int(place["acc_smem"]), int(solve), stream)
    if err != 0:
        raise RuntimeError(f"fused solve kernel launch failed: CUDA error "
                           f"{err}")
    return body_out, acc, res


# ---- the plain version of the kernel's schedule ----

def fused_steps(offsets, solvers: int = SOLVERS,
                narrow: int = NARROW) -> list:
    """The kernel's steps over a level list (``offsets``: level l's records
    at positions [offsets[l], offsets[l + 1])): a level of at most
    ``narrow`` records is one narrow step (warp 0's); a wider one is cut
    into wide steps of at most ``solvers`` records (one a solving thread).
    Returns [(start, end, narrow), ...] in order."""
    steps = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        if hi - lo <= narrow:
            steps.append((lo, hi, True))
        else:
            steps += [(a, min(a + solvers, hi), False)
                      for a in range(lo, hi, solvers)]
    return steps


def ring_schedule(steps, v: int, passes: int, stages: int,
                  stage: int = STAGE) -> list:
    """The ring's order of records over ``passes`` passes of ``steps``
    (``fused_steps``) over ``v`` records: the producer copies stage g of
    the stream (pass g // nsp, records [s stage, (s + 1) stage), s = g mod
    nsp) into slot g mod ``stages`` once stage g - ``stages`` is released;
    a step waits for its own records and, when it and its successor in the
    same pass are both narrow, the successor's too (loaded one level
    ahead), and releases the stages wholly below its end (all of its pass
    at the pass's end).  Returns, per pass, the (record,
    slot) reads in step order; raises if a step would wait on a stage the
    producer cannot copy before the step itself releases one (a deadlock),
    or would read a slot that holds another stage."""
    nsp = -(-v // stage)
    held = [-1] * stages
    issued = released = 0
    reads = []
    for p in range(passes):
        order = []
        for k, (a, b, narrow) in enumerate(steps):
            ahead = (steps[k + 1][1] if k + 1 < len(steps) and narrow
                     and steps[k + 1][2] else b)
            if ahead > a:
                last = p * nsp + (ahead - 1) // stage
                if last >= released + stages:
                    raise RuntimeError(
                        f"ring of {stages} stages: records [{a}, {ahead}) "
                        f"of pass {p} need stage {last}, {released} "
                        "released")
                while issued <= last:
                    held[issued % stages] = issued
                    issued += 1
            for pos in range(a, b):
                g = p * nsp + pos // stage
                if held[g % stages] != g:
                    raise RuntimeError(f"slot {g % stages} holds stage "
                                       f"{held[g % stages]}, not {g}")
                order.append((pos, g % stages))
            released = max(released,
                           p * nsp + (nsp if b == v else b // stage))
        reads.append(order)
    return reads


def solve_contacts_fused_levels_plain(
    body_flat, b1, b2, con_flat, warm_flat, num_contacts,
    vel_iters: int, pos_iters: int, num_joints=None, c_cap=None, tols=None,
):
    """The kernel's schedule in torch: the levels of ``visit_levels``
    (the kernel's pre-pass), split into ``fused_steps``, the records of
    every pass read through ``ring_schedule`` at the ring depth
    ``fused_layout`` gives these capacities, and the solve run step by
    step (``levels_walk``, a step's visits one vectorised torch operation
    per scalar operation).  Equal to ``solve_contacts_fused_plain`` to the
    bit (a NaN residual may carry another payload).  It reads the counts
    and levels back to the host: for tests and for comparison with the
    kernel."""
    n = body_flat.numel() // 8
    r = b1.numel()
    c_cap = r if c_cap is None else int(c_cap)
    lv = visit_levels(b1, b2, num_contacts, num_joints, c_cap, n)
    v = lv["slots"].numel()
    steps = fused_steps(lv["offsets"].tolist())
    reads = ring_schedule(steps, v, 1 + vel_iters + pos_iters,
                          fused_layout(n, r)["stages"])
    for order in reads:
        if [pos for pos, _ in order] != list(range(v)):
            raise AssertionError("a pass does not read each record once, "
                                 "in level order")
    # each record's step, as the level of a sub-level walk: the visits of
    # a step are a part of one level's
    step_of = torch.empty(v, dtype=torch.int64, device=b1.device)
    for k, (a, b, _) in enumerate(steps):
        step_of[lv["order"][a:b]] = k + 1
    return levels_walk(body_flat.reshape(n, 8), con_flat.reshape(r, 12),
                       warm_flat.reshape(r, 2),
                       dict(lv, level=step_of, n_levels=len(steps)),
                       lv["slots"] >= c_cap, vel_iters, pos_iters, tols)[:3]
