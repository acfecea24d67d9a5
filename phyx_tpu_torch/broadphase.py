"""Broadphase: candidate pair generation under static shapes
(``phyx_tpu/broadphase.py``).

* ``sap_grid``: sort bodies by AABB min-x, test every body against its
  ``sap_window`` forward neighbours with per-body hit slots, and compact the
  hits into the fixed ``max_pairs`` buffer.
* ``sap_window``: the windowed sweep (``broadphase_sap``): the same
  ``sap_window`` forward neighbours, every hit kept (no hit slots), never
  slab-major.
* ``sap_tiled``: the slab-windowed sweep of kernel K4
  (``kernels/sweep_tiled.py``) over the x-sorted bodies, each sweep walking
  until its x-interval closes.
* ``sap_kernel``: the sweep of kernel K6 (``kernels/sweep.py``), or K7
  where the capacity is not in whole 1024-row chunks, over all the
  x-sorted bodies, each row walking until its x-interval closes.
* ``sap``: the reference's auto choice (``broadphase``).
* ``n2``: masked all-pairs upper triangle — exact, the test ground truth.

The sweeps take banded x-keys where ``cfg.sweep_band_h`` is set
(``banded_x``: each y-band of a mega-scene sweeps in its own x region),
sorted per band where the band layout is static (``segmented_order``).
All emit pairs sorted lexicographically by ``(pi, pj)`` with EMPTY slots
last, and count what a budget truncated (``ovf_*``) instead of dropping it
silently.  Where the configuration runs the tiled solve (``tiling``), the
sweeps instead finalize slab-major: pairs ordered (slab, pi, pj), with the
routing the tiled solve reads attached (``TiledRouting``).  Nothing a
step runs reads a value back to the host; the two budget policies at the
end (``suggest_sap_window``, ``suggest_sap_hits``: host NumPy on one copy
of the bodies' AABBs, for ``tune``) are not part of a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from phyx_tpu_torch import tiling
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.sweep import CHUNK, sweep_emit, sweep_emit_v2
from phyx_tpu_torch.kernels.sweep_tiled import sweep_emit_tiled
from phyx_tpu_torch.types import EMPTY, Bodies, _record

_EMPTY_KEY = (EMPTY << 32) | EMPTY   # int64 pair key of an EMPTY row
_INF = float("inf")


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


def banded_x(lo: torch.Tensor, hi: torch.Tensor, active: torch.Tensor,
             cfg: SimConfig):
    """Banded sweep x-keys (``cfg.sweep_band_h``): ``(swx_lo, swx_hi,
    n_cross, bucket)``.  Each body's x-interval is offset by its y-band
    (the band of its AABB's low y) times ``sweep_band_span``; the high end
    is padded by span * 2^-18, which bounds the float32 rounding of the
    offset add; ``n_cross`` counts the ``active`` bodies whose AABB
    crosses a band boundary (pairs of such a body can be missed, so the
    caller counts them into ``ovf_band``); ``bucket`` is the f32 band.
    The same float32 operations in the same order as the reference, so the
    keys are equal to the bit.  Without bands: the true x-interval, 0."""
    if cfg.sweep_band_h <= 0.0:
        return (lo[:, 0], hi[:, 0],
                torch.zeros((), dtype=torch.int32, device=lo.device),
                torch.zeros_like(lo[:, 0]))
    # Python floats holding float32 values: each op rounds as float32
    inv_h = float(np.float32(1.0 / cfg.sweep_band_h))
    y0 = float(np.float32(cfg.sweep_band_y0))
    span = np.float32(cfg.sweep_band_span)
    b_lo = torch.floor((lo[:, 1] - y0) * inv_h)
    b_hi = torch.floor((hi[:, 1] - y0) * inv_h)
    n_cross = (active & (b_lo != b_hi)).sum(dtype=torch.int32)
    off = b_lo * float(span)
    pad = float(span * np.float32(2.0 ** -18))
    return lo[:, 0] + off, hi[:, 0] + off + pad, n_cross, b_lo


def segmented_order(keys: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The per-band sort of banded keys on the static band layout
    (``cfg.sweep_band_rows``/``_n``/``_cols``, as ``concat_envs`` lays
    out envs: env e holds rows [e·R, (e+1)·R), its y-band is e % B).  The
    (X, B, R) head rows are transposed to (B, X·R), each band row sorted
    stably, and the tail rows follow in index order.  While every body sits
    in its home band this is the flat stable argsort of the keys (band key
    ranges are disjoint); a body that left its band stays in its home
    segment, and the callers count it into ``ovf_band``.  Returns the
    (N,) int32 order (body id at rank r)."""
    R, B, X = cfg.sweep_band_rows, cfg.sweep_band_n, cfg.sweep_band_cols
    n = keys.shape[0]
    head = X * B * R
    if head > n:
        raise ValueError(f"band layout of {head} rows exceeds {n} bodies")
    ids = torch.arange(n, dtype=torch.int64, device=keys.device)
    kt = keys[:head].reshape(X, B, R).transpose(0, 1).reshape(B, X * R)
    it = ids[:head].reshape(X, B, R).transpose(0, 1).reshape(B, X * R)
    perm = torch.sort(kt, dim=1, stable=True).indices
    return torch.cat([torch.gather(it, 1, perm).reshape(-1),
                      ids[head:]]).to(torch.int32)


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


def broadphase_sap(bodies: Bodies, cfg: SimConfig) -> Pairs:
    """The windowed sweep & prune (the reference's ``broadphase_sap``):
    the ``sap_long_k`` widest bodies go to the long lane, the rest are
    sorted by min x (stable; parked bodies at +inf), and the body at rank k
    is tested against ranks k+1 .. k+w, w = min(sap_window, N - 1), as one
    (w + 1, N) gather.  Every hit is kept.  A sweep whose (w+1)-th
    neighbour is still x-open counts into ``ovf_window``.  The buffer is
    lex-sorted, never slab-major (under ``pallas_tiled`` the step then
    routes to K5, as the reference's does)."""
    n = bodies.capacity
    dev = bodies.pos.device
    w = min(cfg.sap_window, n - 1)
    lo, hi = compute_aabbs(bodies)
    dynamic = bodies.inv_mass > 0.0
    d_pi, d_pj, d_valid, is_long = _long_object_lane(
        bodies, lo, hi, dynamic, min(cfg.sap_long_k, n))

    sweep_act = bodies.active & ~is_long
    keys = torch.where(sweep_act, lo[:, 0], torch.full_like(lo[:, 0], _INF))
    order = torch.sort(keys, stable=True).indices
    slo, shi = lo[order], hi[order]
    sact, sdyn = sweep_act[order], dynamic[order]
    order = order.to(torch.int32)

    # neighbour d + 1 of rank k sits at rank k + d + 1 (clamped to N - 1,
    # masked by in_range)
    jpos = (torch.arange(n, device=dev)[None, :]
            + torch.arange(1, w + 2, device=dev)[:, None])
    in_range = jpos < n
    jc = torch.clamp(jpos, max=n - 1)
    j_lo, j_hi = slo[jc], shi[jc]                 # (w + 1, N, 2)
    j_act, j_dyn = sact[jc], sdyn[jc]
    x_open = j_lo[..., 0] <= shi[None, :, 0]
    y_overlap = ((j_lo[..., 1] <= shi[None, :, 1])
                 & (slo[None, :, 1] <= j_hi[..., 1]))
    ok = (in_range & x_open & y_overlap & sact[None, :] & j_act
          & (sdyn[None, :] | j_dyn))
    j_ord = order[jc]
    pi = torch.minimum(order[None, :], j_ord)[:w]
    pj = torch.maximum(order[None, :], j_ord)[:w]
    open_last = in_range[w] & x_open[w] & sact & j_act[w]
    missed = open_last.sum(dtype=torch.int32)
    return _finish(torch.cat([pi.reshape(-1), d_pi.reshape(-1)]),
                   torch.cat([pj.reshape(-1), d_pj.reshape(-1)]),
                   torch.cat([ok[:w].reshape(-1), d_valid.reshape(-1)]),
                   cfg.max_pairs, ovf_window=missed)


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
    at offset w count into ``ovf_window``.  With banded keys the x-columns
    are the banded intervals, a hit also needs the true x-intervals to
    overlap, and band-boundary crossers count into ``ovf_band``.

    ``emit_routing``: finalize slab-major (``_slab_major``); None emits
    whenever ``cfg.tiled_routing`` is set and the configuration resolves
    to the tiled solve."""
    n = bodies.capacity
    emit_routing = _resolve_routing(cfg, n, emit_routing)
    dev = bodies.pos.device
    w = min(cfg.sap_window, n - 1)
    H = min(cfg.sap_hits, w)
    k_long = min(cfg.sap_long_k, n)
    lo, hi = compute_aabbs(bodies)
    dynamic = bodies.inv_mass > 0.0
    d_pi, d_pj, d_valid, is_long = _long_object_lane(
        bodies, lo, hi, dynamic, k_long)

    sweep_act = bodies.active & ~is_long
    swx_lo, swx_hi, n_cross, _ = banded_x(lo, hi, sweep_act, cfg)
    keys = torch.where(sweep_act, swx_lo, torch.full_like(swx_lo, _INF))
    # stable, as lax.sort: equal keys (and the +inf parked bodies) keep
    # index order
    order = torch.sort(keys, stable=True).indices
    sxlo, sylo = swx_lo[order], lo[order, 1]
    sxhi, syhi = swx_hi[order], hi[order, 1]
    sact, sdyn = sweep_act[order], dynamic[order]
    order = order.to(torch.int32)

    def padded(x, fill):
        pad = torch.full((w + 1,), fill, dtype=x.dtype, device=dev)
        return torch.cat([x, pad])

    def windows(x_p):
        # (w, n) view: row d holds x_p[d + 1 : d + 1 + n]
        return x_p.unfold(0, n, 1)[1:w + 1]

    xlo_p = padded(sxlo, _INF)
    act_p = padded(sact, False)
    ok = ((windows(xlo_p) <= sxhi) & (windows(padded(sylo, _INF)) <= syhi)
          & (sylo <= windows(padded(syhi, -_INF))) & sact
          & windows(act_p) & (sdyn | windows(padded(sdyn, False))))
    if cfg.sweep_band_h > 0.0:
        # the true-x accept: the pad of the banded keys walks, never emits
        ok &= windows(padded(lo[order, 0], _INF)) <= hi[order, 0]
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
                    ovf_slots=dropped, ovf_band=n_cross)
    return _slab_major(pairs, bodies, rank_order(bodies, lo, hi, cfg),
                       cfg) if emit_routing else pairs


def _resolve_routing(cfg: SimConfig, n: int,
                     emit_routing: Optional[bool]) -> bool:
    """Whether a sweep finalizes slab-major: ``emit_routing``, where None
    means whenever ``cfg.tiled_routing`` is set and the configuration
    resolves to the tiled solve; never where (slab, pi) would not pack."""
    if emit_routing is None:
        emit_routing = (cfg.tiled_routing and tiling.resolve_tiled(
            cfg, n, 2 * cfg.max_pairs))
    return emit_routing and tiling.routing_bits_ok(
        n, tiling.slab_dims(cfg, n)[4])


def rank_order(bodies: Bodies, lo: torch.Tensor, hi: torch.Tensor,
               cfg: SimConfig) -> torch.Tensor:
    """The tiled solves' body ranking (the reference's
    ``_routing_rank_sort`` and K5's ``xorder``): a stable sort of
    where(active, banded min x, inf), per band on a static band layout
    (``segmented_order``).  It ranks every active body, the ``k_long``
    widest included (the sweeps park those at +inf, the embedding keeps
    their true x-rank).  Returns the (N,) int32 order."""
    swx_lo, _, _, _ = banded_x(lo, hi, bodies.active, cfg)
    keys = torch.where(bodies.active, swx_lo, torch.full_like(swx_lo, _INF))
    if cfg.sweep_band_rows > 0:
        return segmented_order(keys, cfg)
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def _slab_major(pairs: Pairs, bodies: Bodies, order: torch.Tensor,
                cfg: SimConfig) -> Pairs:
    """The reference's slab-major finalize (``_finish_slab_major``) on the
    lex-compacted buffer ``_finish`` made (stage 1: on overflow the highest
    (pi, pj) pairs dropped), with the bodies ranked by ``order``
    (``rank_order``).  Stage 2 routes the survivors
    (``tiling.route_pairs``, clamps counted into ``ovf_slab``) and orders
    them (slab, pi, pj): the buffer is lex-sorted already, so a stable sort
    on the slab key, EMPTY last, gives that order."""
    n = bodies.capacity
    K, _, _, _, n_slabs, _ = tiling.slab_dims(cfg, n)
    cols = torch.stack([bodies.vel[:, 0], bodies.vel[:, 1], bodies.angvel,
                        bodies.inv_mass, bodies.inv_inertia], dim=1)
    ranked_cols = cols[order.to(torch.int64)]
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


def _column(values, m: int, dtype, device) -> torch.Tensor:
    """(len(values), m): row r filled with values[r], by fills (a tensor
    made from host values would be a copy that waits for the stream)."""
    return torch.stack([torch.full((m,), v, dtype=dtype, device=device)
                        for v in values])


def _sap_tiled_sort_stage(bodies: Bodies, cfg: SimConfig, lo: torch.Tensor,
                          hi: torch.Tensor):
    """The reference's ``_sap_tiled_sort_stage``: keys, the carried body
    sort and the padding to the sweep's own slab geometry (K = tile_stride
    and W = K + max(1024, tile_halo) rounded up to 1024 rows, not
    ``tiling.slab_dims``).  Returns (K4's arguments, n_cross, the long
    lane's (d_pi, d_pj, d_valid)).  K4's arguments: ``rows`` (4, npad) f32
    [xlo, ylo, xhi, yhi] (x banded), ``dyn`` (npad,) int32, ``order``
    (npad,) int32 body id per row (EMPTY padding), ``nact`` () int32 rows
    that start sweeps, ``truex`` (2, npad) f32 true [xlo, xhi] with banded
    keys (else None), ``max_pairs`` rounded up to 1024, ``n_slabs``,
    ``slab_stride`` K and ``window_rows`` W.

    With a static band layout the sort is per band (``segmented_order``):
    bodies that are not swept stay inside their segment as empty intervals
    (lo = +inf, hi = -inf), which end a walk where the next band's keys
    would, so every padded row may start a sweep (``nact`` = npad); bodies
    outside their home band and active tail rows, which the segments cannot
    place, count into ``n_cross``."""
    n = bodies.capacity
    dev = bodies.pos.device
    dynamic = bodies.inv_mass > 0.0
    d_pi, d_pj, d_valid, is_long = _long_object_lane(
        bodies, lo, hi, dynamic, min(cfg.sap_long_k, n))
    sweep_act = bodies.active & ~is_long
    swx_lo, swx_hi, n_cross, bucket = banded_x(lo, hi, sweep_act, cfg)
    keys = torch.where(sweep_act, swx_lo, torch.full_like(swx_lo, _INF))
    # x columns banded, y true, then the true x-interval (exact-x accept)
    cols = torch.stack([swx_lo, lo[:, 1], swx_hi, hi[:, 1], lo[:, 0],
                        hi[:, 0]])
    segmented = cfg.sweep_band_rows > 0
    if segmented:
        cols = torch.where(sweep_act, cols, _column(
            (_INF, _INF, -_INF, -_INF, _INF, -_INF), 1, cols.dtype, dev))
        order = segmented_order(keys, cfg).to(torch.int64)
        R, B = cfg.sweep_band_rows, cfg.sweep_band_n
        head = R * B * cfg.sweep_band_cols
        ids = torch.arange(n, device=dev)
        home = torch.div(ids, R, rounding_mode="floor") % B
        in_head = ids < head
        n_cross = (n_cross
                   + (sweep_act & in_head & (bucket != home.float())).sum(
                       dtype=torch.int32)
                   + (sweep_act & ~in_head).sum(dtype=torch.int32))
    else:
        order = torch.sort(keys, stable=True).indices
    cols = cols[:, order]

    K = -(-cfg.tile_stride // 1024) * 1024
    W = K + max(1024, -(-cfg.tile_halo // 1024) * 1024)
    n_slabs = max(1, -(-n // K))
    npad = (n_slabs - 1) * K + W        # > n: W >= K + 1024

    def padded(x, fill):
        return torch.cat([x, _column(fill, npad - n, x.dtype, dev)], 1)

    if segmented:
        nact = torch.full((), npad, dtype=torch.int32, device=dev)
        rows = padded(cols[:4], [_INF, _INF, -_INF, -_INF])
    else:
        nact = sweep_act.sum(dtype=torch.int32)
        rows = padded(cols[:4], [_INF] * 4)
    sweep = dict(
        rows=rows,
        dyn=padded(dynamic[order].to(torch.int32)[None], [0])[0],
        order=padded(order.to(torch.int32)[None], [EMPTY])[0],
        nact=nact,
        truex=(padded(cols[4:], [_INF, -_INF]) if cfg.sweep_band_h > 0.0
               else None),
        max_pairs=-(-cfg.max_pairs // 1024) * 1024, n_slabs=n_slabs,
        slab_stride=K, window_rows=W)
    return sweep, n_cross, (d_pi, d_pj, d_valid)


def broadphase_sap_tiled(bodies: Bodies, cfg: SimConfig,
                         emit_routing: Optional[bool] = None) -> Pairs:
    """Sweep & prune through K4 (the reference's ``broadphase_sap_tiled``):
    every sweep walks the x-sorted rows of its slab's window until its
    x-interval closes, emitting pairs in sweep order up to the rounded
    budget (``ovf_drop`` past it, ``ovf_window`` where a window ended
    first); the long lane is concatenated, and ``_finish`` compacts the
    buffer, slab-major (``_slab_major``, with ``rank_order``) where
    ``emit_routing`` resolves true (None: as the grid)."""
    n = bodies.capacity
    emit_routing = _resolve_routing(cfg, n, emit_routing)
    lo, hi = compute_aabbs(bodies)
    sweep, n_cross, (d_pi, d_pj, d_valid) = _sap_tiled_sort_stage(
        bodies, cfg, lo, hi)
    ppi, ppj, num_k, ovf_d, ovf_w = sweep_emit_tiled(**sweep)
    # K4 writes only the slots below num
    live = torch.arange(sweep["max_pairs"], dtype=torch.int32,
                        device=ppi.device) < num_k
    a = torch.where(live, ppi, EMPTY)
    b = torch.where(live, ppj, EMPTY)
    pi = torch.cat([torch.minimum(a, b), d_pi.reshape(-1)])
    pj = torch.cat([torch.maximum(a, b), d_pj.reshape(-1)])
    valid = torch.cat([live, d_valid.reshape(-1)])
    pairs = _finish(pi, pj, valid, cfg.max_pairs, ovf_window=ovf_w,
                    ovf_drop=ovf_d, ovf_band=n_cross)
    if not emit_routing:
        return pairs
    return _slab_major(pairs, bodies, rank_order(bodies, lo, hi, cfg), cfg)


def sap_kernel_inputs(bodies: Bodies, max_pairs: int, chunked: bool) -> dict:
    """The emission kernel's arguments (the reference's
    ``broadphase_sap_kernel``): keys where(active, min x, inf), sorted
    stably (equal keys keep index order, as ``lax.sort``), the inactive
    bodies last with their real AABBs.  ``chunked``: K6's, the AABB and dyn
    columns in sorted order; else K7's, by body id."""
    lo, hi = compute_aabbs(bodies)
    keys = torch.where(bodies.active, lo[:, 0], _INF)
    order = torch.sort(keys, stable=True).indices
    aabb = torch.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]], dim=1)
    dyn = (bodies.inv_mass > 0.0).to(torch.int32)
    if chunked:
        aabb, dyn = aabb[order], dyn[order]
    return dict(aabb_flat=aabb.reshape(-1), order=order.to(torch.int32),
                dyn=dyn, nact=bodies.active.sum(dtype=torch.int32),
                max_pairs=max_pairs)


def broadphase_sap_kernel(bodies: Bodies, cfg: SimConfig) -> Pairs:
    """Sweep & prune through the emission kernels (the reference's
    ``broadphase_sap_kernel``): K6 when the capacity is in whole 1024-row
    chunks, else K7.  No window, no hit slots, no long lane: every active
    body walks the x-sorted rows until its interval closes.  The emitted
    buffer is lex-sorted; the kernel's one counter, buffer-full drops, is
    ``ovf_drop`` and ``overflow``.  Never slab-major."""
    chunked = bodies.capacity % CHUNK == 0
    kernel = sweep_emit_v2 if chunked else sweep_emit
    pi, pj, num, ovf = kernel(**sap_kernel_inputs(bodies, cfg.max_pairs,
                                                  chunked))
    pi, pj = lex_sort_pairs(pi, pj)
    z = torch.zeros((), dtype=torch.int32, device=pi.device)
    return Pairs(pi=pi, pj=pj, valid=pi != EMPTY, num=num, overflow=ovf,
                 ovf_window=z, ovf_slots=z, ovf_drop=ovf, ovf_band=z,
                 ovf_slab=z)


# the reference's SMEM budget for its sweep kernels (broadphase.py:975-1003)
SWEEP_SMEM_BUDGET = 900 * 1024


def sweep_kernel_smem_bytes(n: int, max_pairs: int) -> int:
    """SMEM of the reference's ``sweep_emit``: the AABBs, order and dyn of
    ``n`` bodies, the pair buffer and counters.  It decides which function
    ``broadphase="sap"`` computes, not what fits on the card."""
    return 4 * (6 * n + 2 * max_pairs + 8)


def broadphase(bodies: Bodies, cfg: SimConfig,
               tiled_routing: Optional[bool] = None) -> Pairs:
    """Dispatch on ``cfg.broadphase``, branch for branch as the reference
    (``phyx_tpu/broadphase.py`` ``broadphase``).  ``"sap"`` is its auto
    choice: K4 under ``pallas_tiled``, and under ``pallas`` above the sweep
    budget (``sweep_kernel_smem_bytes``); the emission kernels K6/K7 under
    ``pallas`` within it; the grid under ``xla``.
    ``tiled_routing``: the sweeps' slab-major finalize, None = whenever the
    configuration runs the tiled solve, False = never (jointed scenes: the
    jointed-pair exclusion re-sorts the buffer)."""
    name = cfg.broadphase
    if name == "n2":
        return broadphase_n2(bodies, cfg)
    if name == "sap_kernel":
        return broadphase_sap_kernel(bodies, cfg)
    if name == "sap_grid":
        return broadphase_sap_grid(bodies, cfg, emit_routing=tiled_routing)
    if name == "sap_tiled":
        return broadphase_sap_tiled(bodies, cfg, emit_routing=tiled_routing)
    if name == "sap_window":
        return broadphase_sap(bodies, cfg)
    if cfg.solver_backend == "pallas_tiled":
        return broadphase_sap_tiled(bodies, cfg, emit_routing=tiled_routing)
    if cfg.solver_backend == "pallas":
        if sweep_kernel_smem_bytes(bodies.capacity,
                                   cfg.max_pairs) <= SWEEP_SMEM_BUDGET:
            return broadphase_sap_kernel(bodies, cfg)
        return broadphase_sap_tiled(bodies, cfg, emit_routing=tiled_routing)
    return broadphase_sap_grid(bodies, cfg, emit_routing=tiled_routing)


def _host_aabbs(bodies: Bodies):
    """The AABBs' lo, hi (N, 2) f32 and the active mask as NumPy arrays:
    one device-to-host copy."""
    lo, hi = compute_aabbs(bodies)
    host = torch.cat([lo, hi, bodies.active[:, None].to(lo.dtype)],
                     dim=1).cpu().numpy()
    return host[:, 0:2], host[:, 2:4], host[:, 4] != 0.0


def suggest_sap_window(bodies: Bodies, percentile: float = 99.9,
                       margin: float = 1.5, exclude_long_k: int = 8,
                       cfg: Optional[SimConfig] = None) -> int:
    """Host-side window-sizing policy for the windowed and grid sweeps
    (``phyx_tpu/broadphase.py`` ``suggest_sap_window``, the same
    statistic in the same NumPy operations): every active body's forward
    x-neighbour span on the current state (the x-sorted bodies after it
    whose interval opens before its own closes), the ``exclude_long_k``
    widest bodies left out (they take the dense lane), and ``percentile``
    of the spans times ``margin``.  With ``cfg`` sweeping banded keys
    (``sweep_band_h`` > 0) the spans are measured on those keys, in f64."""
    lo, hi, act = _host_aabbs(bodies)
    if not act.any():
        return 16
    ext = np.where(act, hi[:, 0] - lo[:, 0], -np.inf)
    act[np.argsort(-ext)[:exclude_long_k]] = False
    xlo = lo[act, 0].astype(np.float64)
    xhi = hi[act, 0].astype(np.float64)
    if cfg is not None and cfg.sweep_band_h > 0.0:
        b = np.floor((lo[act, 1] - cfg.sweep_band_y0) / cfg.sweep_band_h)
        off = b * float(cfg.sweep_band_span)
        xlo = xlo + off
        xhi = xhi + off
    srt = np.argsort(xlo)
    xlo = xlo[srt]
    xhi = xhi[srt]
    span = np.searchsorted(xlo, xhi, side="right") \
        - np.arange(xlo.shape[0]) - 1
    w = float(np.percentile(span, percentile)) * margin
    return max(8, int(np.ceil(w)))


def suggest_sap_hits(bodies: Bodies, margin: int = 4,
                     exclude_long_k: int = 8,
                     cfg: Optional[SimConfig] = None) -> int:
    """Host-side hit-slot sizing for the grid sweep (``cfg.sap_hits``;
    ``phyx_tpu/broadphase.py`` ``suggest_sap_hits``, the same operations):
    the largest count of true forward hits of an active body on the
    current state (forward x-sorted neighbours whose AABB overlaps in both
    axes, on banded keys where ``cfg`` sweeps them), the
    ``exclude_long_k`` widest bodies left out, plus ``margin``.  Hit-slot
    spill drops real pairs, so it sizes for the maximum.  A loop over the
    sorted rows in Python, as in the reference."""
    lo, hi, act = _host_aabbs(bodies)
    lo = lo.astype(np.float64)
    hi = hi.astype(np.float64)
    if not act.any():
        return 8
    ext = np.where(act, hi[:, 0] - lo[:, 0], -np.inf)
    act[np.argsort(-ext)[:exclude_long_k]] = False
    xlo, xhi = lo[act, 0], hi[act, 0]
    ylo, yhi = lo[act, 1], hi[act, 1]
    if cfg is not None and cfg.sweep_band_h > 0.0:
        b = np.floor((lo[act, 1] - cfg.sweep_band_y0) / cfg.sweep_band_h)
        off = b * float(cfg.sweep_band_span)
        xlo = xlo + off
        xhi = xhi + off
    srt = np.argsort(xlo, kind="stable")
    xlo, xhi, ylo, yhi = xlo[srt], xhi[srt], ylo[srt], yhi[srt]
    m = xlo.shape[0]
    ends = np.searchsorted(xlo, xhi, side="right")
    best = 0
    for i in range(m):
        e = ends[i]
        if e - i - 1 <= best:
            continue
        hits = int(((ylo[i + 1:e] <= yhi[i])
                    & (ylo[i] <= yhi[i + 1:e])).sum())
        if hits > best:
            best = hits
    return best + margin
