"""The comparison that decides ``correct``.

The program's frames are judged against the reference
(``benchmark/reference``).  The window's calls kept for the comparison
(``traffic``) each give the program's input and output state; the
reference runs the call's frames from the same input, with the bodies'
constants that the benchmark made itself, and each number below is the
largest over the kept calls.  The program's state arrives here as NumPy
arrays; nothing of the program is imported.

* ``pos_gap``, ``rot_gap``: the largest gap of a dynamic body's position
  (units) and rotation (cosine, sine) after the call;
* ``vel_gap``, ``spin_gap``: the same for its velocity (units/s) and spin
  (rad/s);
* ``pos_median_gap``, ``vel_median_gap``, ``spin_median_gap``: the
  median over the dynamic bodies of the position, velocity and spin
  gaps: steady where a call of many frames lets the few bodies at a near
  tie (a point on the verge of contact, whose rounding decides it) part
  from the reference;
* ``parted_share``: the percentage of dynamic bodies whose position gap
  passes ``PARTED`` units: a part of the scene left out or stepped wrong
  shows here where a median would not;
* ``pair_gap``: pairs in one cache and not in the other (the output cache
  holds every pair of the call's last broadphase);
* ``point_gap``: contact points, keyed (pair, feature id), in one cache and
  not in the other;
* ``impulse_gap``, ``impulse_median_gap``: the largest and the median
  gap of a shared point's accumulated normal or friction impulse, over
  the reference's largest normal impulse;
* ``penetration_gap``: the gap of the frame's deepest penetration (units);
* ``residual_gap``: the gap of the last velocity pass's residual, over
  the reference's largest normal impulse;
* ``overflow``: the program's overflow counters summed over the kept
  calls' outputs: a dropped pair is a wrong answer;
* ``build_gap``: the built state against the scene's arrays, exactly;
* ``readback_gap``: the host copy the client received against the
  call's output, exactly (cells that read back).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import engine

NUMBERS = ("pos_gap", "rot_gap", "vel_gap", "spin_gap", "pos_median_gap",
           "vel_median_gap", "spin_median_gap", "parted_share", "pair_gap",
           "point_gap", "impulse_gap", "impulse_median_gap",
           "penetration_gap", "residual_gap", "overflow", "build_gap",
           "readback_gap")
# a body whose position gap passes this (units) has parted from the
# reference
PARTED = 1e-3
OVERFLOW_KEYS = ("pair_overflow", "halo_overflow", "ovf_window", "ovf_slots",
                 "ovf_drop", "ovf_band", "ovf_slab")


def bodies_of(scene, capacity: int) -> dict:
    """The bodies' constants at the capacity, rounded to float32 as the
    program stores them: what the benchmark hands to the reference and
    holds the built state to."""
    b = len(scene)
    inv_m, inv_i = scene.inverse_masses()

    def col(x, fill=0.0):
        out = np.full((capacity,) + np.shape(x)[1:], fill, np.float32)
        out[:b] = x
        return out

    angle = scene.angle.astype(np.float32)
    active = np.zeros(capacity, bool)
    active[:b] = True
    return dict(pos=col(scene.pos), half=col(scene.half),
                rot=col(np.stack([np.cos(angle), np.sin(angle)], -1)
                        .astype(np.float32)),
                inv_mass=col(inv_m), inv_inertia=col(inv_i),
                friction=col(scene.friction),
                restitution=col(scene.restitution), active=active)


def build_gap(built: dict, expected: dict) -> float:
    """The largest gap of any built constant or pose of the scene's boxes
    (NaN counts as a gap of infinity)."""
    gap = 0.0
    for key, want in expected.items():
        got = np.asarray(built[key])
        if key == "active":
            gap = max(gap, float(np.sum(got != want)))
            continue
        rows = expected["active"]
        d = np.abs(got[rows].astype(np.float64) - want[rows])
        gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max(initial=0.0)))
    return gap


def _point_keys(pi, pj, fid, n):
    live = (pi >= 0) & (pi < n)
    pi, pj, fid = pi[live], pj[live], fid[live]
    keys, idx = [], []
    for s in range(2):
        ok = fid[:, s] >= 0
        keys.append((pi[ok] * n + pj[ok]) * 8 + fid[ok, s])
        idx.append(np.stack([np.nonzero(live)[0][ok],
                             np.full(ok.sum(), s)], 1))
    return np.concatenate(keys), np.concatenate(idx)


def compare(prog: dict, ref: dict, movable: np.ndarray) -> dict:
    """``prog``: the program's output state (``pos``, ``rot``, ``vel``,
    ``angvel``, the cache's ``pi``, ``pj``, ``fid``, ``normal_impulse``,
    ``friction_impulse``, and ``stats``); ``ref``: the reference's frame.
    Returns the numbers of ``NUMBERS`` that a call gives."""
    n = movable.shape[0]

    def gaps(key):
        d = np.abs(np.asarray(prog[key], np.float64)[movable]
                   - ref[key][movable])
        d = np.nan_to_num(d, nan=np.inf)
        return d.max(axis=1) if d.ndim == 2 else d

    def gap(key):
        return float(gaps(key).max(initial=0.0))

    pi, pj = np.asarray(prog["pi"], np.int64), np.asarray(prog["pj"], np.int64)
    live = (pi >= 0) & (pi < n)
    prog_pairs = set((pi[live] * n + pj[live]).tolist())
    ref_pairs = set((ref["pairs"][:, 0] * n + ref["pairs"][:, 1]).tolist())

    pk, pidx = _point_keys(pi, pj, np.asarray(prog["fid"]), n)
    rk, ridx = _point_keys(ref["pairs"][:, 0], ref["pairs"][:, 1],
                           ref["fid"], n)
    shared, pa, ra = np.intersect1d(pk, rk, return_indices=True)
    scale = max(float(np.abs(ref["normal_impulse"]).max(initial=0.0)), 1e-30)
    imp = np.zeros(shared.shape[0])
    for key in ("normal_impulse", "friction_impulse"):
        a = np.asarray(prog[key], np.float64)[pidx[pa, 0], pidx[pa, 1]]
        b = ref[key][ridx[ra, 0], ridx[ra, 1]]
        imp = np.maximum(imp, np.nan_to_num(np.abs(a - b), nan=np.inf))
    stats = prog["stats"]
    return dict(
        pos_gap=gap("pos"), rot_gap=gap("rot"), vel_gap=gap("vel"),
        spin_gap=gap("angvel"),
        pos_median_gap=float(np.median(gaps("pos"))),
        vel_median_gap=float(np.median(gaps("vel"))),
        spin_median_gap=float(np.median(gaps("angvel"))),
        parted_share=100.0 * float(np.mean(gaps("pos") > PARTED)),
        pair_gap=float(len(prog_pairs ^ ref_pairs)),
        point_gap=float(pk.shape[0] + rk.shape[0] - 2 * shared.shape[0]),
        impulse_gap=float(imp.max(initial=0.0)) / scale,
        impulse_median_gap=float(np.median(imp)) / scale if imp.size
        else 0.0,
        penetration_gap=abs(float(stats["max_penetration"])
                            - ref["max_penetration"]),
        residual_gap=abs(float(stats["residual"]) - ref["residual"]) / scale,
        overflow=float(sum(abs(int(stats[k])) for k in OVERFLOW_KEYS)))


def as_program_state(out: dict) -> dict:
    """A reference frame laid out as the program's state reaches
    ``compare``: the control, put in the program's place."""
    return dict(
        pos=out["pos"], rot=out["rot"], vel=out["vel"], angvel=out["angvel"],
        pi=out["pairs"][:, 0], pj=out["pairs"][:, 1], fid=out["fid"],
        normal_impulse=out["normal_impulse"],
        friction_impulse=out["friction_impulse"],
        stats=dict(dict.fromkeys(OVERFLOW_KEYS, 0),
                   max_penetration=out["max_penetration"],
                   residual=out["residual"]))


def judge(world, bodies: dict, kept: list, frames: int,
          control: bool = False) -> dict:
    """The numbers over ``kept`` calls, each (program input, program
    output, host copy or None): the reference runs ``frames`` frames from
    each input.  ``control``: the reference computed in bfloat16 takes
    the program output's place."""
    movable = bodies["active"] & (bodies["inv_mass"] > 0)
    out = {k: 0.0 for k in NUMBERS if k != "build_gap"}
    for state_in, state_out, host in kept:
        ref = engine.frames(world, state_in, frames)
        if control:
            state_out = as_program_state(
                engine.frames(world, state_in, frames, "bf16"))
            host = None
        for k, v in compare(state_out, ref, movable).items():
            out[k] = max(out[k], v)
        if host is not None:
            b = host.shape[0]
            want = np.concatenate([state_out["pos"][:b], state_out["rot"][:b]],
                                  axis=1)
            d = np.abs(np.asarray(host, np.float64) - want)
            out["readback_gap"] = max(out["readback_gap"], float(
                np.nan_to_num(d, nan=np.inf).max(initial=0.0)))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): each number the configuration gives a limit,
    beside it (a number missing from the run fails); the numbers without
    a limit are read, not compared."""
    lines, ok = [], True
    for k in NUMBERS:
        if k in limits:
            value = numbers.get(k, float("inf"))
            good = value <= limits[k]
            ok &= good
            lines.append(f"{k} {value!r} limit {limits[k]!r}"
                         f"{'' if good else ' FAILED'}")
        elif k in numbers:
            lines.append(f"{k} {numbers[k]!r} read, not compared")
    return ok, lines
