"""The serial contact solve: warm start, velocity passes, displacement
passes, in the exact Gauss-Seidel order of the oracle.

Counterpart of ``phyx_tpu/kernels/contact_solver_streamed.py``
(``_streamed_kernel``, ``solve_contacts_streamed``) for contact rows.  The
kernel is ``csrc/contact_solver_streamed.cu``, built with ``nvcc`` at first
use into ``phyx_tpu_torch/_build/`` and called through ``ctypes``.

* ``solve_contacts_streamed`` is the wrapper: on CUDA tensors it launches
  the kernel (or raises); on CPU tensors it runs the plain version.
* ``solve_contacts_streamed_plain`` is the plain version: the same visits
  in the same order as scalar float32 torch operations.  Each visit's
  arithmetic is written in the kernel's order, and the kernel is built
  with ``-fmad=false``, so the two agree to the bit on the same inputs.

Layout (flat, as in the reference): body rows ``(N*8,)`` f32 of
``[vx, vy, w, inv_mass, inv_inertia, dvx, dvy, dw]``; plain body ids
``b1``/``b2`` ``(R,)`` int32 (the kernel computes row offsets); contact
rows ``con`` ``(R*12,)`` f32 of ``[nx, ny, r1x, r1y, r2x, r2y, mass_n,
mass_t, friction, dst_v, dst_dv, c_nt]``; warm impulses ``(R*2,)`` f32.
Rows ``[0, num)`` are visited; the rest are never touched.  Returns the
updated body rows, the accumulators ``(R*4,)`` (normal, tangent,
displacement, unused; zero past ``num``) and the residual ``(1,)``: the
max |impulse delta| of the last executed velocity pass.

Gates: from the second velocity pass on, a pass is skipped once the
previous executed pass's residual is below ``tols[0]``; displacement
passes likewise with their own residual and ``tols[1]``.  A threshold of
0.0 never fires; ``tols=None`` is ungated.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "contact_solver_streamed.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA solve kernel cannot be built")


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile the kernel (once per source hash) and load it.  Returns
    (ctypes library, nvcc's report or "" when the build was cached)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"contact_solver_streamed_{tag}.so"
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            report = proc.stdout + proc.stderr
            os.replace(tmp, so)   # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    fn = lib.phyx_contact_solve_streamed
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, report


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


def _no_joint_rows(num_joints):
    if num_joints is not None and (torch.is_tensor(num_joints)
                                   or num_joints > 0):
        raise NotImplementedError("joint rows in the solve kernel are not "
                                  "ported yet: ROADMAP M9")


def _tolerances(tols, device):
    """(2,) f32 thresholds; ``None`` (ungated) is zeros, which never fire.
    Built on the device: no host-to-device copy per frame."""
    if tols is None:
        return torch.zeros((2,), dtype=torch.float32, device=device)
    return tols


def solve_contacts_streamed(
    body_flat: torch.Tensor,      # (N*8,) f32
    b1: torch.Tensor,             # (R,) int32 body ids
    b2: torch.Tensor,             # (R,) int32
    con_flat: torch.Tensor,       # (R*12,) f32
    warm_flat: torch.Tensor,      # (R*2,) f32
    num_contacts: torch.Tensor,   # () int32, on the device: never read back
    vel_iters: int,
    pos_iters: int,
    num_joints=None,
    tols: Optional[torch.Tensor] = None,   # (2,) f32 [vel, pos] thresholds
):
    """Returns (body_flat', acc (R*4,), residual (1,)) — see the module
    docstring.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.  ``solve_contacts_streamed.launches`` counts kernel launches."""
    _no_joint_rows(num_joints)
    device = body_flat.device
    n = body_flat.numel() // 8
    r = b1.numel()
    _check("body_flat", body_flat, torch.float32, (n * 8,), device)
    _check("b1", b1, torch.int32, (r,), device)
    _check("b2", b2, torch.int32, (r,), device)
    _check("con_flat", con_flat, torch.float32, (r * 12,), device)
    _check("warm_flat", warm_flat, torch.float32, (r * 2,), device)
    _check("num_contacts", num_contacts, torch.int32, (), device)
    if tols is not None:
        _check("tols", tols, torch.float32, (2,), device)
    tols = _tolerances(tols, device)
    if device.type == "cpu":
        return solve_contacts_streamed_plain(
            body_flat, b1, b2, con_flat, warm_flat, num_contacts,
            vel_iters, pos_iters, tols=tols)
    if device.type != "cuda":
        raise NotImplementedError(f"no solve kernel for {device.type}")
    if n == 0 or vel_iters < 0 or pos_iters < 0:
        raise ValueError("need at least one body and non-negative passes")

    lib, _ = build()
    body_out = body_flat.clone()
    acc = torch.zeros((r * 4,), dtype=torch.float32, device=device)
    res = torch.empty((1,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phyx_contact_solve_streamed(
            body_out.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            con_flat.data_ptr(), warm_flat.data_ptr(), acc.data_ptr(),
            res.data_ptr(), num_contacts.data_ptr(), tols.data_ptr(),
            n, r, int(vel_iters), int(pos_iters), stream)
    if err != 0:
        raise RuntimeError(f"contact solve kernel launch failed: CUDA "
                           f"error {err}")
    solve_contacts_streamed.launches += 1
    return body_out, acc, res


solve_contacts_streamed.launches = 0


def solve_contacts_streamed_plain(
    body_flat, b1, b2, con_flat, warm_flat, num_contacts,
    vel_iters: int, pos_iters: int, num_joints=None, tols=None,
):
    """The plain version: the kernel's visits, in its order, as scalar
    float32 torch operations on the tensors' own device.  It reads ``num``
    and the ids back to the host, so it is for tests and for comparison
    with the kernel, never for the main path."""
    _no_joint_rows(num_joints)
    device = body_flat.device
    n = body_flat.numel() // 8
    r = b1.numel()
    vtol, ptol = _tolerances(tols, device).unbind()
    num = min(max(int(num_contacts), 0), r)
    ids1 = [min(max(i, 0), n - 1) for i in b1[:num].tolist()]
    ids2 = [min(max(j, 0), n - 1) for j in b2[:num].tolist()]
    table = body_flat.reshape(n, 8)
    rows = {}       # body id -> list of 8 scalar tensors (its live row)

    def row(i):
        if i not in rows:
            rows[i] = list(table[i].unbind())
        return rows[i]

    con = [con_flat[k * 12:(k + 1) * 12].unbind() for k in range(num)]
    warm = [warm_flat[k * 2:(k + 1) * 2].unbind() for k in range(num)]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    acc = [[zero] * 4 for _ in range(num)]

    # warm pass
    for k in range(num):
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

    res = zero
    converged = False
    for _ in range(vel_iters):
        if converged:
            continue
        res = zero
        for k in range(num):
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
            res = torch.maximum(res, torch.maximum(torch.abs(dn),
                                                   torch.abs(dt)))
        converged = bool(res < vtol)

    converged = False
    for _ in range(pos_iters):
        if converged:
            continue
        pres = zero
        for k in range(num):
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
            pres = torch.maximum(pres, torch.abs(d))
        converged = bool(pres < ptol)

    body_out = body_flat.clone()
    out = body_out.view(n, 8)
    for i, vals in rows.items():
        out[i] = torch.stack(vals)
    acc_out = torch.zeros((r * 4,), dtype=torch.float32, device=device)
    if num:
        acc_out[:num * 4] = torch.stack([torch.stack(a) for a in acc]
                                        ).reshape(-1)
    return body_out, acc_out, res.reshape(1)
