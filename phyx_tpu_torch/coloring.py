"""On-device contact-graph coloring (``phyx_tpu/coloring.py``).

Every constraint row gets a color such that within a color no *dynamic*
body repeats; the colored solve sweeps the colors one after another
(Gauss-Seidel across colors) and each color's rows as one batch.  Static
bodies (both inverse masses 0) never receive impulses, so they impose no
conflicts.  Each round is a Luby step: every still-uncolored row whose
priority is the least on both of its dynamic bodies wins the round's color
(two scatter-mins).  After ``num_colors - 1`` rounds the leftovers fall into
the final class, which the solve treats as a Jacobi batch.

Colors are integers and equal the JAX package's exactly: the priority hash
is the reference's uint32 arithmetic, emulated in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.narrowphase import Contacts

BIG = 2**31 - 1
_U32 = 0xFFFFFFFF


def priorities(c_cap: int, num_colors: int, device) -> torch.Tensor:
    """(num_colors - 1, c_cap) int32: round c's priority of each row, the
    reference's hash ``h = idx * 2654435761 + (c + 1) * 0x9E3779B9``
    (uint32), ``h ^= h >> 15``, ``((h << 20) & 0x7FF00000) | idx``."""
    idx = torch.arange(c_cap, dtype=torch.int64, device=device)
    rnd = torch.arange(1, num_colors, dtype=torch.int64, device=device)
    h = (idx * 2654435761 + (rnd * 0x9E3779B9)[:, None]) & _U32
    h = h ^ (h >> 15)
    return (((h << 20) & 0x7FF00000) | idx).to(torch.int32)


def color_rows(row_b1: torch.Tensor, row_b2: torch.Tensor,
               valid: torch.Tensor, body_static: torch.Tensor,
               num_colors: int) -> torch.Tensor:
    """Color two-body constraint rows (contacts or user joints): within
    colors 0..num_colors-2 no dynamic body repeats; leftovers land in the
    final class.  ``body_static``: (N,) bool.  Returns (R,) int32 colors."""
    C = valid.shape[0]
    # the priority keeps the row index in its low 20 bits; past 2^20 rows
    # it would bleed into the hash bits, priorities would lose uniqueness
    # and two rows sharing a body could win the same color.  The
    # reference's assert and message, raised under -O too.
    if C >= 2 ** 20:
        raise AssertionError(
            f"row capacity {C} >= 2^20 breaks the coloring priority "
            "packing; the XLA backend caps row capacity at 2^20 - 1 (use "
            "the Pallas backends beyond that)")
    n = body_static.shape[0]
    last = num_colors - 1
    b1 = row_b1.to(torch.int64)
    b2 = row_b2.to(torch.int64)
    s1 = body_static[b1]
    s2 = body_static[b2]
    # static endpoints scatter to a spare slot n and always "win"
    t1 = torch.where(s1, n, b1)
    t2 = torch.where(s2, n, b2)
    g1 = torch.clamp(t1, max=n - 1)
    g2 = torch.clamp(t2, max=n - 1)
    pri_all = priorities(C, num_colors, valid.device)
    big = torch.full((), BIG, dtype=torch.int32, device=valid.device)
    color = torch.full((C,), last, dtype=torch.int32, device=valid.device)
    remaining = valid
    for c in range(last):
        pri = torch.where(remaining, pri_all[c], big)
        # one per-body min over both endpoints
        best = torch.full((n + 1,), BIG, dtype=torch.int32,
                          device=valid.device)
        best.scatter_reduce_(0, t1, pri, "amin")
        best.scatter_reduce_(0, t2, pri, "amin")
        win = (remaining & (s1 | (pri == best[g1]))
               & (s2 | (pri == best[g2])))
        color = torch.where(win, c, color)
        remaining = remaining & ~win
    return torch.where(valid, color, last)


def color_contacts(contacts: Contacts, body_static: torch.Tensor,
                   cfg: SimConfig) -> Contacts:
    """Colors 0..num_colors-1; only the last class may hold conflicts."""
    return contacts.replace(color=color_rows(
        contacts.b1, contacts.b2, contacts.valid, body_static,
        cfg.num_colors))


def check_coloring(contacts: Contacts, body_static: torch.Tensor,
                   cfg: SimConfig) -> torch.Tensor:
    """Dynamic-body conflicts in the non-final color classes, () int32: 0
    is conflict-free Gauss-Seidel."""
    n = body_static.shape[0]
    b1 = contacts.b1.to(torch.int64)
    b2 = contacts.b2.to(torch.int64)
    s1 = body_static[b1]
    s2 = body_static[b2]
    conflicts = torch.zeros((), dtype=torch.int32, device=b1.device)
    ones = torch.ones_like(b1, dtype=torch.int32)
    for c in range(cfg.num_colors - 1):
        m = contacts.valid & (contacts.color == c)
        cnt = torch.zeros((n + 1,), dtype=torch.int32, device=b1.device)
        cnt.index_add_(0, torch.where(m & ~s1, b1, n), ones)
        cnt.index_add_(0, torch.where(m & ~s2, b2, n), ones)
        conflicts = conflicts + (cnt[:n] > 1).sum(dtype=torch.int32)
    return conflicts
