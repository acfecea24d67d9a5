"""Slab tiling shared by the slab-major broadphase finalize and the tiled
solves (``phyx_tpu/tiling.py``).

Bodies sorted by x-rank are embedded into ``n_slabs`` windows of
``tile_stride`` rows (a 128-row zero block, then ``rps`` bodies) plus a
``tile_halo`` overlap.  A contact or joint row is visited with the body
window of its slab; statics at rest are remapped to that slab's zero
block, so a scene-wide ground does not force a wide window.

``resolve_tiled`` and ``colored_fallback`` copy the reference's choice of
solve (``phyx_tpu/step.py`` solve_stage, ``phyx_tpu/solver.py``
pallas_smem_bytes / pallas_streamed_smem_bytes).  Their byte counts are
the TPU kernels' SMEM footprints, and here they only say which FUNCTION a
configuration computes (the serial row order, the slab-ordered tiled
walk, or the colored sweeps), never what fits on the card this package
runs on: the fused-or-streamed choice inside the untiled tier is
``kernels/contact_solver.fits``, and both of those compute the same
function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import Bodies

# the reference's solve-kernel block (contact_solver_streamed.BLK): the
# contact capacity must be a multiple of it, at least two, for any Pallas
# solve above the fused budget
BLK = 1024
# the reference's SMEM budget and footprints (solver.py:338-354)
REF_SMEM_BUDGET = 900 * 1024


def ref_fused_bytes(n_bodies: int, n_rows: int) -> int:
    """SMEM of the reference's fused kernel: body in + out, and per row
    12 + 2 + 4 f32 and 2 int32."""
    return 4 * (2 * n_bodies * 8 + n_rows * (12 + 2 + 4 + 2))


def ref_streamed_bytes(n_bodies: int) -> int:
    """SMEM of the reference's streamed kernel: the body table and two
    1024-slot blocks of rows."""
    return 4 * n_bodies * 8 + 2 * BLK * (12 + 2 + 4 + 1 + 1) * 4


def _blocks_ok(c_cap: int) -> bool:
    return c_cap % BLK == 0 and c_cap >= 2 * BLK


def block_pair_budget(max_pairs: int) -> int:
    """The least pair budget at or above ``max_pairs`` whose contact slots
    (2 x max_pairs) come in whole blocks, at least two: below it
    ``resolve_tiled`` is False, and a ``"pallas"`` scene above the
    streamed budget falls back to the colored solve."""
    half = BLK // 2
    return max(BLK, -(-max_pairs // half) * half)


def slab_dims(cfg: SimConfig, n: int) -> Tuple[int, int, int, int, int, int]:
    """(K, H, W, rps, n_slabs, npad): stride K rows per slab (128-row zero
    block + rps bodies), halo H, window W = K + H, and the embedded table's
    rows npad = n_slabs * K + H."""
    K = cfg.tile_stride
    H = cfg.tile_halo
    W = K + H
    rps = K - 128
    n_slabs = -(-n // rps)
    return K, H, W, rps, n_slabs, n_slabs * K + H


def resolve_tiled(cfg: SimConfig, n_bodies: int, c_cap: int) -> bool:
    """True iff this configuration runs the tiled solve: forced by
    ``solver_backend="pallas_tiled"``, or a ``"pallas"`` body capacity
    above the reference's streamed budget (32 N + 163,840 > 921,600 bytes,
    N > 23,680).  Either needs ``c_cap`` contact slots in whole 1024-slot
    blocks, at least two.  Joint capacity does not enter."""
    if not _blocks_ok(c_cap):
        return False
    if cfg.solver_backend == "pallas_tiled":
        return True
    return (cfg.solver_backend == "pallas"
            and ref_streamed_bytes(n_bodies) > REF_SMEM_BUDGET)


def colored_fallback(cfg: SimConfig, n_bodies: int, c_cap: int,
                     j_cap: int) -> bool:
    """True iff the reference falls back to the colored XLA solve for a
    ``"pallas"`` configuration: the fused budget is exceeded and the
    contact capacity is not in whole blocks, at least two."""
    return (cfg.solver_backend == "pallas"
            and ref_fused_bytes(n_bodies, c_cap + j_cap) > REF_SMEM_BUDGET
            and not _blocks_ok(c_cap))


def zero_safe_mask(bodies: Bodies) -> torch.Tensor:
    """Bodies whose embedded row equals the zero row (no velocity, both
    inverse masses zero): only these may be remapped to a zero block.  A
    kinematic static (inverse mass 0, velocity set) keeps its own row."""
    return ((bodies.inv_mass == 0.0) & (bodies.inv_inertia == 0.0)
            & (bodies.vel == 0.0).all(dim=1) & (bodies.angvel == 0.0))


def pz_table(rank: torch.Tensor, zero_safe: torch.Tensor, cfg: SimConfig,
             n: int) -> torch.Tensor:
    """Per-body lookup: embedded row * 2 + zero-remap flag (int64)."""
    K, _, _, rps, _, _ = slab_dims(cfg, n)
    rank = rank.to(torch.int64)
    pos = torch.div(rank, rps, rounding_mode="floor") * K + 128 + rank % rps
    return pos * 2 + zero_safe.to(torch.int64)


def route_pairs(pz_tab: torch.Tensor, eb1: torch.Tensor, eb2: torch.Tensor,
                cfg: SimConfig, n: int):
    """Slab and clamped embedded endpoint rows of body-id pairs (ids in
    [0, n); results on dead rows are don't-cares).  The slab is the one of
    the lower row that is not zero-safe; a zero-safe partner moves to that
    slab's zero block; both rows are clamped into the slab window, and
    ``in_win`` is False where a clamp changed one (the caller counts those
    into ``ovf_slab``).  Returns (lb1, lb2, slab, in_win), lb* absolute
    embedded rows, all int64."""
    K, _, W, _, n_slabs, _ = slab_dims(cfg, n)
    z1 = pz_tab[eb1.to(torch.int64)]
    z2 = pz_tab[eb2.to(torch.int64)]
    b1p, b2p = z1 >> 1, z2 >> 1
    st1, st2 = (z1 & 1) == 1, (z2 & 1) == 1
    dyn_min = torch.where(st1, b2p,
                          torch.where(st2, b1p, torch.minimum(b1p, b2p)))
    slab = torch.clamp(torch.div(dyn_min, K, rounding_mode="floor"),
                       0, n_slabs - 1)
    lo = slab * K
    hi = lo + W
    lb1 = torch.where(st1, lo, b1p)
    lb2 = torch.where(st2, lo, b2p)
    in_win = (lb1 >= lo) & (lb1 < hi) & (lb2 >= lo) & (lb2 < hi)
    lb1 = torch.minimum(torch.maximum(lb1, lo), hi - 1)
    lb2 = torch.minimum(torch.maximum(lb2, lo), hi - 1)
    return lb1, lb2, slab, in_win


def routing_bits_ok(n: int, n_slabs: int) -> bool:
    """Whether the reference can pack (slab, pi) into one int32 sort key;
    where it cannot, it does not emit the slab-major buffer, and neither
    does this package (the packing itself is not ported)."""
    bits = max(1, (n - 1).bit_length())
    sbits = max(1, (n_slabs - 1).bit_length())
    return sbits + bits <= 30


def embed(ranked_cols: torch.Tensor, cfg: SimConfig, n: int) -> torch.Tensor:
    """The (npad, 8) embedded body table from the body columns [vx, vy, w,
    inv_mass, inv_inertia] in x-rank order ((n, 5)): each slab's zero
    block, then its rps bodies, and the halo rows at the end, zero;
    pseudo-velocity columns zero."""
    K, H, _, rps, n_slabs, _ = slab_dims(cfg, n)
    rows = torch.zeros((n_slabs * rps, 8), dtype=torch.float32,
                       device=ranked_cols.device)
    rows[:n, :5] = ranked_cols
    slabs = torch.cat([torch.zeros((n_slabs, 128, 8), dtype=torch.float32,
                                   device=rows.device),
                       rows.reshape(n_slabs, rps, 8)], dim=1)
    return torch.cat([slabs.reshape(n_slabs * K, 8),
                      torch.zeros((H, 8), dtype=torch.float32,
                                  device=rows.device)])


def unembed(table: torch.Tensor, order: torch.Tensor, cfg: SimConfig,
            n: int) -> torch.Tensor:
    """Inverse of ``embed`` for the (npad, 8) table the solve returns: the
    (n, 8) rows in body-id order (``order[r]`` is the body at rank r)."""
    K, _, _, _, n_slabs, _ = slab_dims(cfg, n)
    ranked = table[:n_slabs * K].reshape(n_slabs, K, 8)[:, 128:]
    ranked = ranked.reshape(-1, 8)[:n]
    return torch.empty_like(ranked).index_copy_(0, order.to(torch.int64),
                                                ranked)
