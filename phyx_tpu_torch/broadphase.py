"""Broadphase: candidate pair generation under static shapes
(``phyx_tpu/broadphase.py``).

* ``sap_grid``: sort bodies by AABB min-x, test every body against its
  ``sap_window`` forward neighbours with per-body hit slots, and compact the
  hits into the fixed ``max_pairs`` buffer.  ``sap`` and ``sap_window`` map
  here too: the reference's own dispatch says the grid dominates the
  windowed sweep with the same window semantics.
* ``n2``: masked all-pairs upper triangle — exact, the test ground truth.

Both emit pairs sorted lexicographically by ``(pi, pj)`` with EMPTY slots
last, and count what a budget truncated (``ovf_*``) instead of dropping it
silently.  Where the configuration runs the tiled solve (``tiling``), the
grid instead finalizes slab-major: pairs ordered (slab, pi, pj), with the
routing the tiled solve reads attached (``TiledRouting``).  Nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from phyx_tpu_torch import tiling
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import EMPTY, Bodies, _record

_EMPTY_KEY = (EMPTY << 32) | EMPTY   # int64 pair key of an EMPTY row


@_record
class TiledRouting:
    """What the slab-major solve (``solver.solve_pallas_tiled2``) reads
    beside the pair buffer: the body x-rank order and the body columns in
    that order (for the embedded table), each pair's endpoint rows local to
    its slab's window (clamped into it; not pre-scaled, unlike the
    reference's x8 rows), and ``pair_cum[s]``, the live pairs of slabs
    below s (``pair_cum[n_slabs]`` = all live pairs)."""

    order: torch.Tensor        # (N,) int32 body id at rank r
    ranked_cols: torch.Tensor  # (N, 5) f32 [vx, vy, w, inv_mass, inv_inertia]
    lb1: torch.Tensor          # (P,) int32 window-local row of pi
    lb2: torch.Tensor          # (P,) int32 window-local row of pj
    pair_cum: torch.Tensor     # (n_slabs + 1,) int32


@_record
class Pairs:
    """Fixed-capacity candidate pair buffer: ``pi < pj`` body ids, free
    slots at EMPTY and last.  Live pairs are lex-sorted by (pi, pj), except
    on the slab-major path, where they are ordered (slab, pi, pj) and
    ``routing`` is set.  ``overflow`` is the sum of the per-cause
    counters."""

    pi: torch.Tensor          # (P,) int32
    pj: torch.Tensor          # (P,) int32
    valid: torch.Tensor       # (P,) bool
    num: torch.Tensor         # () int32
    overflow: torch.Tensor    # () int32
    ovf_window: torch.Tensor  # () int32 sweeps still x-open at the window end
    ovf_slots: torch.Tensor   # () int32 per-body hit-slot spills
    ovf_drop: torch.Tensor    # () int32 candidates past max_pairs
    ovf_band: torch.Tensor    # () int32 banded-sweep crossers (0 here)
    # tiled-solve slab clamps: counted here on the slab-major path, added
    # by step.solve_stage on the routed tiled path, else 0
    ovf_slab: torch.Tensor    # () int32
    routing: Optional[TiledRouting] = None   # slab-major path only


def compute_aabbs(bodies: Bodies):
    """Per-body world AABB of the rotated box: extent = |R| @ half_extent."""
    c = torch.abs(bodies.rot[:, 0])
    s = torch.abs(bodies.rot[:, 1])
    hx, hy = bodies.half_extent[:, 0], bodies.half_extent[:, 1]
    e = torch.stack([c * hx + s * hy, s * hx + c * hy], dim=-1)
    return bodies.pos - e, bodies.pos + e


def pair_keys(pi: torch.Tensor, pj: torch.Tensor) -> torch.Tensor:
    """One int64 lex key per (pi, pj) row; EMPTY rows sort last."""
    return (pi.to(torch.int64) << 32) | pj.to(torch.int64)


def unpack_keys(key: torch.Tensor):
    return ((key >> 32).to(torch.int32),
            (key & 0xFFFFFFFF).to(torch.int32))


def lex_sort_pairs(pi: torch.Tensor, pj: torch.Tensor):
    """Lex-sort id columns ``(pi, pj)`` with EMPTY rows last.  One int64
    key at every capacity (the reference packs int32 and falls back to a
    two-key sort above 2^15 bodies)."""
    return unpack_keys(torch.sort(pair_keys(pi, pj)).values)


def _i32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.int32)
    # a fill, not a host-to-device copy (which would wait for the stream)
    return torch.full((), x, dtype=torch.int32, device=device)


def _finish(pi, pj, valid, max_pairs: int, ovf_window=0, ovf_slots=0,
            ovf_drop=0, ovf_band=0) -> Pairs:
    """Compact candidates of any shape into a lex-sorted buffer of
    ``max_pairs`` rows.  On overflow the lowest pairs in lex order
    survive; the rest are added to ``ovf_drop``."""
    valid = valid.reshape(-1)
    dev = valid.device
    key = torch.where(valid, pair_keys(pi.reshape(-1), pj.reshape(-1)),
                      torch.full_like(valid, _EMPTY_KEY, dtype=torch.int64))
    num = valid.sum(dtype=torch.int32)
    key_s = torch.sort(key).values
    if key_s.shape[0] >= max_pairs:
        key_s = key_s[:max_pairs]
    else:
        key_s = torch.cat([key_s, torch.full(
            (max_pairs - key_s.shape[0],), _EMPTY_KEY, dtype=torch.int64,
            device=dev)])
    pi_out, pj_out = unpack_keys(key_s)
    ovf_window = _i32(ovf_window, dev)
    ovf_slots = _i32(ovf_slots, dev)
    ovf_band = _i32(ovf_band, dev)
    ovf_drop = _i32(ovf_drop, dev) + torch.clamp(num - max_pairs, min=0)
    return Pairs(
        pi=pi_out, pj=pj_out, valid=pi_out != EMPTY,
        num=torch.clamp(num, max=max_pairs),
        overflow=ovf_window + ovf_slots + ovf_drop + ovf_band,
        ovf_window=ovf_window, ovf_slots=ovf_slots, ovf_drop=ovf_drop,
        ovf_band=ovf_band,
        ovf_slab=torch.zeros((), dtype=torch.int32, device=dev))


def broadphase_n2(bodies: Bodies, cfg: SimConfig) -> Pairs:
    """Masked O(N^2) all-pairs broadphase (exact; small scenes / tests)."""
    n = bodies.capacity
    dev = bodies.pos.device
    lo, hi = compute_aabbs(bodies)
    dynamic = bodies.inv_mass > 0.0
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ii = ids[:, None].expand(n, n)
    jj = ids[None, :].expand(n, n)
    overlap_x = ((lo[:, None, 0] <= hi[None, :, 0])
                 & (lo[None, :, 0] <= hi[:, None, 0]))
    overlap_y = ((lo[:, None, 1] <= hi[None, :, 1])
                 & (lo[None, :, 1] <= hi[:, None, 1]))
    act = bodies.active[:, None] & bodies.active[None, :]
    dyn = dynamic[:, None] | dynamic[None, :]
    valid = (jj > ii) & overlap_x & overlap_y & act & dyn
    return _finish(ii, jj, valid, cfg.max_pairs)


def _long_object_lane(bodies: Bodies, lo, hi, dynamic, k_long: int):
    """The ``sap_long_k`` widest bodies (ground planes) are pulled out of
    the sweep and tested densely against every body.  Returns (d_pi, d_pj,
    d_valid, is_long) with (K, N) candidate grids.  Ties in width keep the
    lower index first, as ``lax.top_k`` does."""
    n = bodies.capacity
    dev = lo.device
    extent_x = torch.where(bodies.active, hi[:, 0] - lo[:, 0],
                           torch.full_like(lo[:, 0], float("-inf")))
    long_idx = torch.sort(extent_x, descending=True,
                          stable=True).indices[:k_long]
    k_ids = torch.arange(k_long, dtype=torch.int32, device=dev)
    is_long = torch.zeros((n,), dtype=torch.bool, device=dev).index_fill_(
        0, long_idx, True) & bodies.active
    long_rank = torch.full((n,), -1, dtype=torch.int32,
                           device=dev).index_copy_(0, long_idx, k_ids)
    long_id32 = long_idx.to(torch.int32)

    jdx = torch.arange(n, dtype=torch.int32, device=dev)
    l_lo, l_hi = lo[long_idx], hi[long_idx]
    l_act = bodies.active[long_idx] & is_long[long_idx]
    l_dyn = dynamic[long_idx]
    dox = (l_lo[:, None, 0] <= hi[None, :, 0]) & (lo[None, :, 0] <= l_hi[:, None, 0])
    doy = (l_lo[:, None, 1] <= hi[None, :, 1]) & (lo[None, :, 1] <= l_hi[:, None, 1])
    dact = l_act[:, None] & bodies.active[None, :]
    ddyn = l_dyn[:, None] | dynamic[None, :]
    notself = long_id32[:, None] != jdx[None, :]
    # long-long pairs counted once: keep only when j's rank exceeds ours
    dedupe = (~is_long[None, :]) | (long_rank[None, :] > k_ids[:, None])
    d_valid = dox & doy & dact & ddyn & notself & dedupe
    d_pi = torch.minimum(long_id32[:, None], jdx[None, :])
    d_pj = torch.maximum(long_id32[:, None], jdx[None, :])
    return d_pi, d_pj, d_valid, is_long


def broadphase_sap_grid(bodies: Bodies, cfg: SimConfig,
                        emit_routing: Optional[bool] = None) -> Pairs:
    """Windowed sweep & prune with per-body hit slots.

    Offset d (0 <= d < w) tests every body against its (d+1)-th forward
    neighbour in min-x order.  The reference scans the offsets with
    ``lax.scan`` and fills ``sap_hits`` slots per body in increasing d;
    here all (w, n) tests are one broadcast over strided windows of the
    sorted columns, a cumulative count along d gives each hit its slot,
    and the hits below ``sap_hits`` scatter into place — the same buffer.
    Hits beyond the slots count into ``ovf_slots``; windows still x-open
    at offset w count into ``ovf_window``.

    ``emit_routing``: finalize slab-major (``_slab_major``); None emits
    whenever ``cfg.tiled_routing`` is set and the configuration resolves
    to the tiled solve."""
    n = bodies.capacity
    n_slabs = tiling.slab_dims(cfg, n)[4]
    if emit_routing is None:
        emit_routing = (cfg.tiled_routing and tiling.resolve_tiled(
            cfg, n, 2 * cfg.max_pairs))
    emit_routing = emit_routing and tiling.routing_bits_ok(n, n_slabs)
    dev = bodies.pos.device
    w = min(cfg.sap_window, n - 1)
    H = min(cfg.sap_hits, w)
    k_long = min(cfg.sap_long_k, n)
    lo, hi = compute_aabbs(bodies)
    dynamic = bodies.inv_mass > 0.0
    d_pi, d_pj, d_valid, is_long = _long_object_lane(
        bodies, lo, hi, dynamic, k_long)

    sweep_act = bodies.active & ~is_long
    keys = torch.where(sweep_act, lo[:, 0],
                       torch.full_like(lo[:, 0], float("inf")))
    # stable, as lax.sort: equal keys (and the +inf parked bodies) keep
    # index order
    order = torch.sort(keys, stable=True).indices
    sxlo, sylo = lo[order, 0], lo[order, 1]
    sxhi, syhi = hi[order, 0], hi[order, 1]
    sact, sdyn = sweep_act[order], dynamic[order]
    order = order.to(torch.int32)

    def padded(x, fill):
        pad = torch.full((w + 1,), fill, dtype=x.dtype, device=dev)
        return torch.cat([x, pad])

    def windows(x_p):
        # (w, n) view: row d holds x_p[d + 1 : d + 1 + n]
        return x_p.unfold(0, n, 1)[1:w + 1]

    inf = float("inf")
    xlo_p = padded(sxlo, inf)
    act_p = padded(sact, False)
    ok = ((windows(xlo_p) <= sxhi) & (windows(padded(sylo, inf)) <= syhi)
          & (sylo <= windows(padded(syhi, -inf))) & sact
          & windows(act_p) & (sdyn | windows(padded(sdyn, False))))
    # target body ids of offset d: a contiguous slice of the permutation
    jid = windows(padded(order, -1))

    okl = ok.to(torch.int32)
    slot = torch.cumsum(okl, dim=0, dtype=torch.int32) - okl
    keep = ok & (slot < H)
    tgt = torch.full((H + 1, n), -1, dtype=torch.int32, device=dev)
    # hits past the slots go to the spare row H, which is discarded
    tgt.scatter_(0, torch.where(keep, slot, H).to(torch.int64), jid)
    tgt = tgt[:H]

    count = okl.sum(dim=0, dtype=torch.int32)
    dropped = torch.clamp(count - H, min=0).sum(dtype=torch.int32)
    open_last = ((xlo_p[w + 1:w + 1 + n] <= sxhi) & sact
                 & act_p[w + 1:w + 1 + n])
    missed = open_last.sum(dtype=torch.int32)

    src_id = order[None, :].expand(H, n)
    pi = torch.cat([torch.minimum(src_id, tgt).reshape(-1), d_pi.reshape(-1)])
    pj = torch.cat([torch.maximum(src_id, tgt).reshape(-1), d_pj.reshape(-1)])
    vv = torch.cat([(tgt >= 0).reshape(-1), d_valid.reshape(-1)])
    pairs = _finish(pi, pj, vv, cfg.max_pairs, ovf_window=missed,
                    ovf_slots=dropped)
    return _slab_major(pairs, bodies, lo, cfg) if emit_routing else pairs


def _routing_rank_sort(bodies: Bodies, lo: torch.Tensor):
    """The tiled solve's body ranking: a stable sort of
    where(active, min x, inf).  It ranks every active body, the ``k_long``
    widest included (the sweep parks those at +inf, the embedding keeps
    their true x-rank).  Returns (order (N,) int32, ranked_cols (N, 5):
    [vx, vy, w, inv_mass, inv_inertia] in rank order)."""
    keys = torch.where(bodies.active, lo[:, 0],
                       torch.full_like(lo[:, 0], float("inf")))
    order = torch.sort(keys, stable=True).indices
    cols = torch.stack([bodies.vel[:, 0], bodies.vel[:, 1], bodies.angvel,
                        bodies.inv_mass, bodies.inv_inertia], dim=1)
    return order.to(torch.int32), cols[order]


def _slab_major(pairs: Pairs, bodies: Bodies, lo: torch.Tensor,
                cfg: SimConfig) -> Pairs:
    """The reference's slab-major finalize (``_finish_slab_major``) on the
    lex-compacted buffer ``_finish`` made (stage 1: on overflow the highest
    (pi, pj) pairs dropped).  Stage 2 routes the survivors
    (``tiling.route_pairs``, clamps counted into ``ovf_slab``) and orders
    them (slab, pi, pj): the buffer is lex-sorted already, so a stable sort
    on the slab key, EMPTY last, gives that order."""
    n = bodies.capacity
    K, _, _, _, n_slabs, _ = tiling.slab_dims(cfg, n)
    order, ranked_cols = _routing_rank_sort(bodies, lo)
    rank = torch.empty_like(order).index_copy_(
        0, order.to(torch.int64),
        torch.arange(n, dtype=torch.int32, device=order.device))
    pz = tiling.pz_table(rank, tiling.zero_safe_mask(bodies), cfg, n)
    live = pairs.valid
    lb1, lb2, slab, in_win = tiling.route_pairs(
        pz, torch.clamp(pairs.pi, max=n - 1), torch.clamp(pairs.pj, max=n - 1),
        cfg, n)
    ovf_slab = (live & ~in_win).sum(dtype=torch.int32)
    # window-local rows; dead slots carry zeros
    lb1 = torch.where(live, lb1 - slab * K, 0).to(torch.int32)
    lb2 = torch.where(live, lb2 - slab * K, 0).to(torch.int32)
    skey = torch.where(live, slab, n_slabs)
    skey, perm = torch.sort(skey, stable=True)
    pair_cum = torch.searchsorted(
        skey, torch.arange(n_slabs + 1, dtype=skey.dtype,
                           device=skey.device)).to(torch.int32)
    pi = pairs.pi[perm]
    return pairs.replace(
        pi=pi, pj=pairs.pj[perm], valid=pi != EMPTY,
        overflow=pairs.overflow + ovf_slab, ovf_slab=ovf_slab,
        routing=TiledRouting(order=order, ranked_cols=ranked_cols,
                             lb1=lb1[perm], lb2=lb2[perm],
                             pair_cum=pair_cum))


def broadphase(bodies: Bodies, cfg: SimConfig,
               tiled_routing: Optional[bool] = None) -> Pairs:
    """Dispatch on ``cfg.broadphase``.  ``tiled_routing``: the grid's
    slab-major finalize, None = whenever the configuration runs the tiled
    solve, False = never (jointed scenes: the jointed-pair exclusion
    re-sorts the buffer).  The sweep kernels of the reference are not
    ported yet (ROADMAP K4, K6, K7), nor banded sweep keys (M12)."""
    if cfg.sweep_band_h > 0.0:
        raise NotImplementedError(
            "banded sweep keys (sweep_band_h > 0) are not ported yet: "
            "ROADMAP M12")
    if cfg.broadphase == "n2":
        return broadphase_n2(bodies, cfg)
    if cfg.broadphase in ("sap", "sap_window", "sap_grid"):
        return broadphase_sap_grid(bodies, cfg, emit_routing=tiled_routing)
    raise NotImplementedError(
        f"broadphase={cfg.broadphase!r} runs a sweep kernel that is not "
        "ported yet: ROADMAP K4 (sap_tiled), K6/K7 (sap_kernel)")
