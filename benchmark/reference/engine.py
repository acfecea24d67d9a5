"""One frame of the 2D box engine in plain NumPy and Python floats.

The benchmark's reference for ``correct``: it takes the bodies' constants
that the benchmark made (``World``) and a frame's input state, and computes
the frame the engine's configuration states, with none of the program's
code or tables:

1. velocities integrated under gravity (dynamic, active bodies);
2. every pair of active bodies whose AABBs overlap, one of them dynamic,
   lex-sorted ``(i, j)`` with ``i < j`` (a sweep over min-x, the widest
   bodies tested against all);
3. box-box SAT with the reference-face hysteresis, incident-face clipping
   and feature ids (flip * 4 + incident vertex), up to two points a pair;
4. warm impulses from the input cache, matched by (pair, feature id);
5. the effective masses, friction, restitution and displacement targets;
6. the sequential-impulse solve, serial: one warm pass, the velocity passes
   (normal then friction of each contact point), the displacement passes,
   walked in the order the configuration's solver defines: the pair
   order, or, on the tiled tier, the pairs ordered (slab, i, j) by the
   bodies' rank by min-x, banded by the configuration's sweep bands
   (``sweep_band_*``) where it states them;
7. positions and rotations integrated (velocity plus the displacement
   pseudo-velocity);
8. the new cache (every pair, its points' feature ids and accumulated
   impulses) and the frame's counters.

Precision: the configuration states float32.  Steps 1-5 and 7 compute in
float32, each operation rounded as the configuration's arithmetic writes
it, so that a contact exists, a face is chosen or a pair overlaps exactly
where float32 puts it; the solve (6) accumulates in float64 and its
results are rounded to float32.  ``precision="bf16"`` is the control: the
same frame with every stored value (stage outputs, body velocities and
accumulated impulses in the solve) rounded to bfloat16, the precision
below float32, which the comparison must refuse.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

F32 = np.float32
# SAT reference-face preference (the hysteresis of the engine's
# narrowphase)
REL_TOL = F32(0.98)
ABS_TOL = F32(0.001)
# a body this much wider than the median AABB is swept against every body
LONG_FACTOR = 16.0
# the tiled tier's rule (the configuration's solver): bodies above the
# streamed solve's table budget, contact slots in whole 1024-slot blocks
_BLK = 1024
_SMEM_BUDGET = 900 * 1024


def tiled_tier(solver_backend: str, max_bodies: int, max_pairs: int) -> bool:
    c_cap = 2 * max_pairs
    blocks = c_cap % _BLK == 0 and c_cap >= 2 * _BLK
    if not blocks:
        return False
    if solver_backend == "pallas_tiled":
        return True
    streamed = 4 * max_bodies * 8 + 2 * _BLK * 20 * 4
    return solver_backend == "pallas" and streamed > _SMEM_BUDGET


_F = struct.Struct("<f")
_I = struct.Struct("<I")


def bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    try:
        b = _I.unpack(_F.pack(x))[0]
    except OverflowError:
        return x
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return _F.unpack(_I.pack(b))[0]


def bf16_array(x) -> np.ndarray:
    """``x`` rounded to bfloat16, kept as float32."""
    f = np.ascontiguousarray(x, dtype=F32)
    b = f.view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return b.view(F32)


@dataclass
class World:
    """The bodies' constants (float32) and the configuration's
    parameters."""

    inv_mass: np.ndarray       # (N,)
    inv_inertia: np.ndarray    # (N,)
    half: np.ndarray           # (N, 2)
    friction: np.ndarray       # (N,)
    restitution: np.ndarray    # (N,)
    active: np.ndarray         # (N,) bool
    dt: float
    gravity: tuple
    velocity_iterations: int
    position_iterations: int
    slop: float
    contact_beta: float
    max_displacement_velocity: float
    restitution_threshold: float
    tiled: bool
    tile_stride: int
    # the sweep bands (0: none): a body's rank key is its min x plus
    # floor((min y - band_y0) / band_h) * band_span; with band_rows > 0
    # the bodies are ranked per band on the static layout of band_cols x
    # cells, band_n y-bands and band_rows rows an env
    band_h: float = 0.0
    band_y0: float = 0.0
    band_span: float = 0.0
    band_rows: int = 0
    band_n: int = 0
    band_cols: int = 0


# the configuration's band keys and their values where it omits them
BAND_KEYS = {"sweep_band_h": 0.0, "sweep_band_y0": 0.0,
             "sweep_band_span": 0.0, "sweep_band_rows": 0,
             "sweep_band_n": 0, "sweep_band_cols": 0}


def world_from(bodies: dict, cfg: dict) -> World:
    """``bodies``: the scene's arrays (``inv_mass``, ``inv_inertia``,
    ``half``, ``friction``, ``restitution``, ``active``) at the capacity;
    ``cfg``: the configuration file's engine settings."""
    f = {k: np.asarray(bodies[k], F32)
         for k in ("inv_mass", "inv_inertia", "half", "friction",
                   "restitution")}
    band = {k[len("sweep_"):]: type(v)(cfg.get(k, v))
            for k, v in BAND_KEYS.items()}
    return World(
        active=np.asarray(bodies["active"], bool),
        dt=float(cfg["dt"]), gravity=tuple(cfg["gravity"]),
        velocity_iterations=int(cfg["velocity_iterations"]),
        position_iterations=int(cfg["position_iterations"]),
        slop=float(cfg["slop"]), contact_beta=float(cfg["contact_beta"]),
        max_displacement_velocity=float(cfg["max_displacement_velocity"]),
        restitution_threshold=float(cfg["restitution_threshold"]),
        tiled=tiled_tier(cfg["solver_backend"], int(cfg["max_bodies"]),
                         int(cfg["max_pairs"])),
        tile_stride=int(cfg["tile_stride"]), **band, **f)


def aabbs(pos, rot, half):
    c, s = np.abs(rot[:, 0]), np.abs(rot[:, 1])
    e = np.stack([c * half[:, 0] + s * half[:, 1],
                  s * half[:, 0] + c * half[:, 1]], axis=1)
    return pos - e, pos + e


def broadphase(w: World, lo, hi) -> np.ndarray:
    """(M, 2) int64: every overlapping pair of active bodies, one of them
    dynamic, ``i < j``, lex-sorted."""
    ids = np.nonzero(w.active)[0]
    dyn = w.inv_mass > 0.0
    width = (hi[ids, 0] - lo[ids, 0]).astype(np.float64)
    wide = width > LONG_FACTOR * max(float(np.median(width)), 1e-9)
    out = []

    def keep(a, b):
        ok = ((lo[b, 1] <= hi[a, 1]) & (lo[a, 1] <= hi[b, 1])
              & (dyn[a] | dyn[b]))
        out.append(np.stack([np.minimum(a, b)[ok], np.maximum(a, b)[ok]], 1))

    def sweep(order):
        # each body against those after it in min-x order while x-open
        rows = np.arange(order.shape[0])
        d = 1
        while rows.size:
            rows = rows[rows + d < order.shape[0]]
            a, b = order[rows], order[rows + d]
            x_open = lo[b, 0] <= hi[a, 0]
            rows, a, b = rows[x_open], a[x_open], b[x_open]
            keep(a, b)
            d += 1

    long_ids, rest = ids[wide], ids[~wide]
    # the long bodies among themselves, each pair once
    sweep(long_ids[np.argsort(lo[long_ids, 0], kind="stable")])
    order = rest[np.argsort(lo[rest, 0], kind="stable")]
    if long_ids.size and order.size:
        # each long body against the other bodies whose min x lies in its
        # x-interval widened by the widest of them: a range of ``order``
        start_x = lo[order, 0].astype(np.float64)
        reach = 2.0 * float(np.nanmax(width[~wide], initial=0.0)) + 1.0
        start = np.searchsorted(
            start_x, lo[long_ids, 0].astype(np.float64) - reach)
        stop = np.searchsorted(start_x, hi[long_ids, 0].astype(np.float64),
                               side="right")
        count = np.maximum(stop - start, 0)
        a = np.repeat(long_ids, count)
        at = (np.arange(count.sum()) + np.repeat(start - np.cumsum(count)
                                                 + count, count))
        b = order[at]
        x_open = (lo[b, 0] <= hi[a, 0]) & (lo[a, 0] <= hi[b, 0])
        keep(a[x_open], b[x_open])
    sweep(order)
    pairs = np.concatenate(out) if out else np.zeros((0, 2), np.int64)
    pairs = pairs.astype(np.int64)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _rot_inv_apply(r, v):
    return np.stack([r[:, 0] * v[:, 0] + r[:, 1] * v[:, 1],
                     -r[:, 1] * v[:, 0] + r[:, 0] * v[:, 1]], axis=1)


def _rot_apply(r, v):
    return np.stack([r[:, 0] * v[:, 0] - r[:, 1] * v[:, 1],
                     r[:, 1] * v[:, 0] + r[:, 0] * v[:, 1]], axis=1)


def _sel(c, a, b):
    return np.where(c[:, None], a, b)


def _comp(v, k):
    return np.where(k == 1, v[:, 1], v[:, 0])


def _pm(c):
    """+1 where ``c``, else -1 (float32)."""
    return np.where(c, F32(1.0), F32(-1.0))


# incident face -> (v0, v1) vertex ids, counter-clockwise
_FACE_V0 = np.array([1, 2, 3, 0])
_FACE_V1 = np.array([2, 3, 0, 1])
_TINY = F32(1e-30)


def narrowphase(pos, rot, half, pairs):
    """Box-box contacts of ``pairs``: per pair its normal (from i toward
    j) and two point slots, each with world point, penetration, feature
    id and whether it exists.  Returns a dict of arrays, slots (M, 2)."""
    i, j = pairs[:, 0], pairs[:, 1]
    pa, ra, ha = pos[i], rot[i], half[i]
    pb, rb, hb = pos[j], rot[j], half[j]
    d = pb - pa
    da = _rot_inv_apply(ra, d)
    db = _rot_inv_apply(rb, -d)
    cr = ra[:, 0] * rb[:, 0] + ra[:, 1] * rb[:, 1]
    sr = ra[:, 0] * rb[:, 1] - ra[:, 1] * rb[:, 0]
    ac, as_ = np.abs(cr), np.abs(sr)
    sep_ax = np.abs(da[:, 0]) - ha[:, 0] - (ac * hb[:, 0] + as_ * hb[:, 1])
    sep_ay = np.abs(da[:, 1]) - ha[:, 1] - (as_ * hb[:, 0] + ac * hb[:, 1])
    sep_bx = np.abs(db[:, 0]) - hb[:, 0] - (ac * ha[:, 0] + as_ * ha[:, 1])
    sep_by = np.abs(db[:, 1]) - hb[:, 1] - (as_ * ha[:, 0] + ac * ha[:, 1])
    overlapping = ((sep_ax <= 0) & (sep_ay <= 0) & (sep_bx <= 0)
                   & (sep_by <= 0))
    axis_a = (sep_ay > sep_ax).astype(np.int64)
    best_a = np.maximum(sep_ax, sep_ay)
    axis_b = (sep_by > sep_bx).astype(np.int64)
    best_b = np.maximum(sep_bx, sep_by)
    use_b = best_b > REL_TOL * best_a + ABS_TOL

    ref_p, ref_r, ref_h = (_sel(use_b, pb, pa), _sel(use_b, rb, ra),
                           _sel(use_b, hb, ha))
    inc_p, inc_r, inc_h = (_sel(use_b, pa, pb), _sel(use_b, ra, rb),
                           _sel(use_b, ha, hb))
    axis = np.where(use_b, axis_b, axis_a)
    sign = _pm(_comp(_sel(use_b, db, da), axis) >= 0.0)
    col1 = np.stack([-ref_r[:, 1], ref_r[:, 0]], axis=1)
    n_face = sign[:, None] * _sel(axis == 1, col1, ref_r)
    normal = _sel(use_b, -n_face, n_face)

    n_inc = _rot_inv_apply(inc_r, n_face)
    inc_axis = (np.abs(n_inc[:, 1]) > np.abs(n_inc[:, 0])).astype(np.int64)
    inc_pos = _comp(n_inc, inc_axis) < 0.0
    fidx = np.where(inc_axis == 0, np.where(inc_pos, 0, 2),
                    np.where(inc_pos, 1, 3))
    v0, v1 = _FACE_V0[fidx], _FACE_V1[fidx]

    def vert_local(vid):
        sx = _pm((vid == 1) | (vid == 2))
        sy = _pm(vid >= 2)
        return np.stack([sx * inc_h[:, 0], sy * inc_h[:, 1]], axis=1)

    def to_ref_local(v_local):
        w = inc_p + _rot_apply(inc_r, v_local)
        return _rot_inv_apply(ref_r, w - ref_p)

    p0, p1 = to_ref_local(vert_local(v0)), to_ref_local(vert_local(v1))
    other = 1 - axis
    h_other = _comp(ref_h, other)
    fully_out = np.zeros_like(overlapping)
    for plane in (F32(-1.0), F32(1.0)):
        d0 = plane * _comp(p0, other) - h_other
        d1 = plane * _comp(p1, other) - h_other
        fully_out |= (d0 > 0) & (d1 > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = d0 / np.where(np.abs(d0 - d1) > _TINY, d0 - d1, _TINY)
            t1 = d1 / np.where(np.abs(d1 - d0) > _TINY, d1 - d0, _TINY)
        n0 = _sel(d0 > 0, p0 + (p1 - p0) * t0[:, None], p0)
        n1 = _sel(d1 > 0, p1 + (p0 - p1) * t1[:, None], p1)
        p0, p1 = n0, n1
    pair_ok = overlapping & ~fully_out
    flip = np.where(use_b, 4, 0)

    points, pens, fids, oks = [], [], [], []
    for p_local, vid in ((p0, v0), (p1, v1)):
        separation = sign * _comp(p_local, axis) - _comp(ref_h, axis)
        oks.append(pair_ok & (separation <= 0.0))
        points.append(ref_p + _rot_apply(ref_r, p_local))
        pens.append(-separation)
        fids.append(flip + vid)
    return dict(normal=normal, point=np.stack(points, 1),
                pen=np.stack(pens, 1), fid=np.stack(fids, 1),
                ok=np.stack(oks, 1))


def _pair_keys(i, j, n):
    return np.asarray(i, np.int64) * n + np.asarray(j, np.int64)


def warm_impulses(pairs, fid, ok, cache: dict, n: int):
    """(M, 2) normal and friction warm impulses: the input cache's
    impulse of the same pair and feature id."""
    live = cache["pi"] >= 0
    live &= cache["pi"] < n
    ck = _pair_keys(cache["pi"][live], cache["pj"][live], n)
    cfid = cache["fid"][live]
    cn, ct = cache["normal_impulse"][live], cache["friction_impulse"][live]
    srt = np.argsort(ck, kind="stable")
    ck, cfid, cn, ct = ck[srt], cfid[srt], cn[srt], ct[srt]
    q = _pair_keys(pairs[:, 0], pairs[:, 1], n)
    pos = np.clip(np.searchsorted(ck, q), 0, max(ck.shape[0] - 1, 0))
    wn = np.zeros(fid.shape)
    wt = np.zeros(fid.shape)
    if ck.shape[0] == 0:
        return wn, wt
    hit = ck[pos] == q
    for s in range(2):
        live_s = hit & ok[:, s] & (fid[:, s] >= 0)
        for c in (1, 0):
            m = live_s & (fid[:, s] == cfid[pos, c])
            wn[:, s] = np.where(m, cn[pos, c], wn[:, s])
            wt[:, s] = np.where(m, ct[pos, c], wt[:, s])
    return wn, wt


def rank_keys(w: World, lo) -> np.ndarray:
    """(N,) float32: each active body's min x, offset by its y-band where
    the configuration bands the sweep (the band of its min y), in float32
    operations in the configuration's order; +inf for the others."""
    x = lo[:, 0]
    if w.band_h > 0.0:
        band = np.floor((lo[:, 1] - F32(w.band_y0)) * F32(1.0 / w.band_h))
        x = x + band * F32(w.band_span)
    return np.where(w.active, x, F32(np.inf))


def rank_order(w: World, lo) -> np.ndarray:
    """(N,) the body at each rank: a stable sort of ``rank_keys``, or on
    a static band layout (``band_rows`` > 0) each y-band's rows sorted
    stably on their own, the bands in turn, and the rows past the layout
    after them in index order.  Env e holds rows [e R, (e+1) R) and sits
    in y-band e % B of x cell e // B, so the layout's (X, B, R) rows are
    read as (B, X R)."""
    keys = rank_keys(w, lo)
    if w.band_rows <= 0:
        return np.argsort(keys, kind="stable")
    r, b, x = w.band_rows, w.band_n, w.band_cols
    head = x * b * r
    ids = np.arange(keys.shape[0])
    kt = keys[:head].reshape(x, b, r).transpose(1, 0, 2).reshape(b, x * r)
    it = ids[:head].reshape(x, b, r).transpose(1, 0, 2).reshape(b, x * r)
    perm = np.argsort(kt, axis=1, kind="stable")
    return np.concatenate([np.take_along_axis(it, perm, 1).reshape(-1),
                           ids[head:]])


def slab_ranks(w: World, lo):
    """The tiled tier's body ranks (``rank_order``: active bodies first,
    ties by index), the bodies a slab holds and the number of slabs."""
    n = lo.shape[0]
    rank = np.empty(n, np.int64)
    rank[rank_order(w, lo)] = np.arange(n)
    rps = w.tile_stride - 128
    n_slabs = -(-n // rps)
    return rank, rps, n_slabs


def solve(body, con, order, vel_iters, pos_iters, q):
    """The serial solve over the contact points ``order`` (indices into
    the ``con`` columns).  ``body``: lists vx, vy, w, im, ii, updated in
    place; ``q`` rounds each stored value (``float`` keeps float64,
    ``bf16`` is the control's).  Returns the pseudo-velocities, the
    accumulators (normal, friction) and the residual of the last
    velocity pass."""
    vx, vy, w, im, ii = body
    n = len(vx)
    px_, py_, pw_ = [0.0] * n, [0.0] * n, [0.0] * n
    b1, b2, nx_, ny_, r1x_, r1y_, r2x_, r2y_ = con[:8]
    mn_, mt_, fr_, dstv_, dstd_, cnt_, wn_, wt_ = con[8:]
    an, at, ad = list(wn_), list(wt_), [0.0] * len(wn_)
    rows = [(k, b1[k], b2[k], nx_[k], ny_[k], r1x_[k], r1y_[k], r2x_[k],
             r2y_[k], im[b1[k]], ii[b1[k]], im[b2[k]], ii[b2[k]])
            for k in order]
    vrows = [r + (mn_[r[0]], mt_[r[0]], fr_[r[0]], dstv_[r[0]],
                  cnt_[r[0]]) for r in rows]
    prows = [r + (mn_[r[0]], dstd_[r[0]]) for r in rows]
    for k, i, j, nx, ny, r1x, r1y, r2x, r2y, im1, ii1, im2, ii2 in rows:
        px = nx * an[k] - ny * at[k]
        py = ny * an[k] + nx * at[k]
        vx[i] = q(vx[i] - px * im1)
        vy[i] = q(vy[i] - py * im1)
        w[i] = q(w[i] - ii1 * (r1x * py - r1y * px))
        vx[j] = q(vx[j] + px * im2)
        vy[j] = q(vy[j] + py * im2)
        w[j] = q(w[j] + ii2 * (r2x * py - r2y * px))
    res = 0.0
    for _ in range(vel_iters):
        res = 0.0
        for (k, i, j, nx, ny, r1x, r1y, r2x, r2y, im1, ii1, im2, ii2, mn,
             mt, fr, dstv, cnt) in vrows:
            vx1, vy1, w1 = vx[i], vy[i], w[i]
            vx2, vy2, w2 = vx[j], vy[j], w[j]
            dvx = vx2 - w2 * r2y - vx1 + w1 * r1y
            dvy = vy2 + w2 * r2x - vy1 - w1 * r1x
            a = an[k]
            na = q(a + (dstv - (nx * dvx + ny * dvy)) * mn)
            if na < 0.0:
                na = 0.0
            dn = na - a
            an[k] = na
            a = at[k]
            mf = fr * na
            ta = q(a - (-ny * dvx + nx * dvy + cnt * dn) * mt)
            if ta > mf:
                ta = mf
            elif ta < -mf:
                ta = -mf
            dt = ta - a
            at[k] = ta
            px = nx * dn - ny * dt
            py = ny * dn + nx * dt
            vx[i] = q(vx1 - px * im1)
            vy[i] = q(vy1 - py * im1)
            w[i] = q(w1 - ii1 * (r1x * py - r1y * px))
            vx[j] = q(vx2 + px * im2)
            vy[j] = q(vy2 + py * im2)
            w[j] = q(w2 + ii2 * (r2x * py - r2y * px))
            if dn < 0.0:
                dn = -dn
            if dt < 0.0:
                dt = -dt
            if dn > res:
                res = dn
            if dt > res:
                res = dt
    for _ in range(pos_iters):
        for (k, i, j, nx, ny, r1x, r1y, r2x, r2y, im1, ii1, im2, ii2, mn,
             dstd) in prows:
            px1, py1, q1 = px_[i], py_[i], pw_[i]
            px2, py2, q2 = px_[j], py_[j], pw_[j]
            dvx = px2 - q2 * r2y - px1 + q1 * r1y
            dvy = py2 + q2 * r2x - py1 - q1 * r1x
            a = ad[k]
            na = q(a + (dstd - (nx * dvx + ny * dvy)) * mn)
            if na < 0.0:
                na = 0.0
            d = na - a
            ad[k] = na
            ix, iy = nx * d, ny * d
            px_[i] = q(px1 - ix * im1)
            py_[i] = q(py1 - iy * im1)
            pw_[i] = q(q1 - ii1 * (r1x * iy - r1y * ix))
            px_[j] = q(px2 + ix * im2)
            py_[j] = q(py2 + iy * im2)
            pw_[j] = q(q2 + ii2 * (r2x * iy - r2y * ix))
    return (px_, py_, pw_), an, at, res


def frame(w: World, state: dict, precision: str = "f32") -> dict:
    """One frame from ``state`` (``pos``, ``rot``, ``vel``, ``angvel``
    and the cache's ``pi``, ``pj``, ``fid``, ``normal_impulse``,
    ``friction_impulse``).  Returns the next state's bodies and cache
    and the frame's counters; ``precision`` "f32" (the reference) or
    "bf16" (its control)."""
    q = bf16_array if precision == "bf16" else (lambda x: x)
    n = w.active.shape[0]
    pos = q(np.asarray(state["pos"], F32))
    rot = q(np.asarray(state["rot"], F32))
    vel = np.asarray(state["vel"], F32)
    angvel = q(np.asarray(state["angvel"], F32))
    dynamic = (w.inv_mass > 0.0) & w.active
    gdt = np.asarray(w.gravity, F32) * F32(w.dt)
    vel = q(np.where(dynamic[:, None], vel + gdt, vel))

    lo, hi = aabbs(pos, rot, w.half)
    pairs = broadphase(w, lo, hi)
    nar = narrowphase(pos, rot, w.half, pairs)
    ok = nar["ok"]
    i, j = pairs[:, 0], pairs[:, 1]
    wn, wt = warm_impulses(pairs, nar["fid"], ok, state, n)

    # per point slot (M, 2), as the prepare stage writes it
    nx = q(nar["normal"][:, 0])[:, None]
    ny = q(nar["normal"][:, 1])[:, None]
    point = nar["point"]
    r1 = q(point - pos[i][:, None, :])
    r2 = q(point - pos[j][:, None, :])
    im1, im2 = w.inv_mass[i][:, None], w.inv_mass[j][:, None]
    ii1, ii2 = w.inv_inertia[i][:, None], w.inv_inertia[j][:, None]
    rn1 = r1[..., 0] * ny - r1[..., 1] * nx
    rn2 = r2[..., 0] * ny - r2[..., 1] * nx
    tx, ty = -ny, nx
    rt1 = r1[..., 0] * ty - r1[..., 1] * tx
    rt2 = r2[..., 0] * ty - r2[..., 1] * tx
    kn = im1 + im2 + ii1 * rn1 * rn1 + ii2 * rn2 * rn2
    kt = im1 + im2 + ii1 * rt1 * rt1 + ii2 * rt2 * rt2
    with np.errstate(divide="ignore"):
        mass_n = np.where(kn > 0, F32(1.0) / np.maximum(kn, _TINY), F32(0))
        mass_t = np.where(kt > 0, F32(1.0) / np.maximum(kt, _TINY), F32(0))
    c_nt = ii1 * rn1 * rt1 + ii2 * rn2 * rt2
    fr = np.broadcast_to(np.sqrt(w.friction[i] * w.friction[j])[:, None],
                         kn.shape)
    w1, w2 = angvel[i][:, None], angvel[j][:, None]
    pv1x = vel[i, 0][:, None] + -w1 * r1[..., 1]
    pv1y = vel[i, 1][:, None] + w1 * r1[..., 0]
    pv2x = vel[j, 0][:, None] + -w2 * r2[..., 1]
    pv2y = vel[j, 1][:, None] + w2 * r2[..., 0]
    vn0 = nx * (pv2x - pv1x) + ny * (pv2y - pv1y)
    e = np.maximum(w.restitution[i], w.restitution[j])[:, None]
    dst_v = np.where(vn0 < -F32(w.restitution_threshold), -e * vn0, F32(0))
    dst_dv = np.minimum(
        F32(w.contact_beta) * np.maximum(nar["pen"] - F32(w.slop), F32(0)),
        F32(w.max_displacement_velocity))

    # the walk: live points in the solver's pair order, slot 0 then 1
    m = pairs.shape[0]
    pair_order = np.arange(m)
    if w.tiled and m:
        rank, rps, n_slabs = slab_ranks(w, lo)
        zero_safe = ((w.inv_mass == 0) & (w.inv_inertia == 0)
                     & np.all(vel == 0, axis=1) & (angvel == 0))
        r_i = np.where(zero_safe[i], np.iinfo(np.int64).max, rank[i])
        r_j = np.where(zero_safe[j], np.iinfo(np.int64).max, rank[j])
        # a pair's slab is that of its lower-ranked endpoint among those
        # not at rest for good (static and motionless)
        slab = np.clip(np.minimum(r_i, r_j) // rps, 0, n_slabs - 1)
        pair_order = np.argsort(slab, kind="stable")
    slot_ids = (pair_order[:, None] * 2 + np.arange(2)[None, :]).reshape(-1)
    walk = slot_ids[ok.reshape(-1)[slot_ids]].tolist()

    def flat(x):
        return q(np.broadcast_to(x, (m, 2))).reshape(-1).tolist()

    con = (np.repeat(i, 2).tolist(), np.repeat(j, 2).tolist(), flat(nx),
           flat(ny), flat(r1[..., 0]), flat(r1[..., 1]), flat(r2[..., 0]),
           flat(r2[..., 1]), flat(mass_n), flat(mass_t), flat(fr),
           flat(dst_v), flat(dst_dv), flat(c_nt), flat(wn), flat(wt))
    body = [vel[:, 0].tolist(), vel[:, 1].tolist(), angvel.tolist(),
            w.inv_mass.tolist(), w.inv_inertia.tolist()]
    (dpx, dpy, dpw), an, at, res = solve(
        body, con, walk, w.velocity_iterations, w.position_iterations,
        bf16 if precision == "bf16" else float)
    vel = np.stack([np.asarray(body[0], F32), np.asarray(body[1], F32)], 1)
    angvel = np.asarray(body[2], F32)
    dvel = np.stack([np.asarray(dpx, F32), np.asarray(dpy, F32)], 1)
    dang = np.asarray(dpw, F32)

    dt = F32(w.dt)
    new_pos = q(np.where(dynamic[:, None], pos + vel * dt + dvel, pos))
    a = angvel * dt + dang
    c, s = np.cos(a), np.sin(a)
    rc, rs = rot[:, 0], rot[:, 1]
    nr = np.stack([c * rc - s * rs, s * rc + c * rs], 1)
    norm = np.sqrt(nr[:, 0] * nr[:, 0] + nr[:, 1] * nr[:, 1])
    nr = nr / np.maximum(norm, F32(1e-12))[:, None]
    new_rot = q(np.where(dynamic[:, None], nr, rot))

    acc_n = np.zeros(2 * m, F32)
    acc_t = np.zeros(2 * m, F32)
    acc_n[walk] = np.asarray([an[k] for k in walk], F32)
    acc_t[walk] = np.asarray([at[k] for k in walk], F32)
    pen = np.where(ok, nar["pen"], F32(0))
    return dict(
        pos=new_pos, rot=new_rot, vel=vel, angvel=angvel,
        pairs=pairs, fid=np.where(ok, nar["fid"], -1),
        normal_impulse=acc_n.reshape(m, 2),
        friction_impulse=acc_t.reshape(m, 2),
        num_pairs=m, num_contacts=int(ok.sum()),
        max_penetration=float(pen.max()) if m else 0.0,
        residual=float(res))


def frames(w: World, state: dict, count: int, precision: str = "f32"):
    """``count`` frames in turn from ``state``; returns the last."""
    out = None
    for _ in range(count):
        out = frame(w, state, precision)
        state = dict(pos=out["pos"], rot=out["rot"], vel=out["vel"],
                     angvel=out["angvel"], pi=out["pairs"][:, 0],
                     pj=out["pairs"][:, 1], fid=out["fid"],
                     normal_impulse=out["normal_impulse"],
                     friction_impulse=out["friction_impulse"])
    return out
