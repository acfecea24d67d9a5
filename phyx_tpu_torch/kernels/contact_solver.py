"""The fused serial solve: the streamed kernel's function with the body
table and the accumulators in one block's shared memory.

Counterpart of ``phyx_tpu/kernels/contact_solver.py`` (``_solver_kernel``,
``solve_contacts_fused``).  The kernel is ``csrc/contact_solver.cu``; it
walks the visits of ``csrc/solve_rows.cuh`` serially (``solve_rows``), the
streamed kernel runs the same visits level by level, so the two agree to
the bit.  Inputs, outputs and
gates are those of ``kernels/contact_solver_streamed.py`` (see its
docstring), and so is the plain version.

``fused_smem_bytes`` is the shared memory the kernel's state takes;
``fits`` says whether a body and row capacity fit one block.  The step
picks this kernel or the streamed one by ``fits`` alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from phyx_tpu_torch.kernels import nvcc
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    check_inputs, solve_contacts_streamed_plain)

SOURCE = nvcc.CSRC / "contact_solver.cu"
# the most dynamic shared memory one block of an H100 can use
SMEM_LIMIT = 232_448

# the two kernels compute one function: one plain version serves both
solve_contacts_fused_plain = solve_contacts_streamed_plain


def fused_smem_bytes(n_cap: int, r_cap: int) -> int:
    """Body table (N x 8 f32) and accumulators (R x 4 f32), R = contact
    slots + joint slots."""
    return 4 * (8 * n_cap + 4 * r_cap)


def fits(n_cap: int, r_cap: int) -> bool:
    return fused_smem_bytes(n_cap, r_cap) <= SMEM_LIMIT


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    lib, report = nvcc.load(SOURCE)
    fn = lib.phyx_contact_solve_fused
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
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
    raise when its state does not fit one block; CPU tensors take the
    plain version.  ``solve_contacts_fused.launches`` counts launches."""
    args = (body_flat, b1, b2, con_flat, warm_flat, num_contacts, vel_iters,
            pos_iters, num_joints, c_cap)
    n, r, c_cap, tols = check_inputs(*args, tols)
    device = body_flat.device
    if device.type == "cpu":
        return solve_contacts_fused_plain(*args, tols=tols)
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")
    if not fits(n, r):
        raise ValueError(
            f"{n} bodies and {r} rows need {fused_smem_bytes(n, r)} bytes "
            f"of shared memory, over the {SMEM_LIMIT} of one block: use "
            "the streamed kernel")

    lib, _ = build()
    # the kernel writes every element of its outputs
    body_out = torch.empty_like(body_flat)
    acc = torch.empty((r * 4,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phyx_contact_solve_fused(
            body_flat.data_ptr(), body_out.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), con_flat.data_ptr(), warm_flat.data_ptr(),
            acc.data_ptr(), res.data_ptr(), num_contacts.data_ptr(),
            None if num_joints is None else num_joints.data_ptr(),
            tols.data_ptr(), n, c_cap, r - c_cap, int(vel_iters),
            int(pos_iters), stream)
    if err != 0:
        raise RuntimeError(f"fused solve kernel launch failed: CUDA error "
                           f"{err}")
    solve_contacts_fused.launches += 1
    return body_out, acc, res


solve_contacts_fused.launches = 0
