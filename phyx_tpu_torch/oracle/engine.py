"""NumPy golden oracle: loop-faithful scalar sequential-impulse engine.

A copy of the JAX package's ``phyx_tpu/oracle/engine.py`` (NumPy only,
the same arithmetic), so the port reaches its oracle without importing
that package.  Its only input from the package is the ``SimConfig``
fields, which the port's ``SimConfig`` has under the same names.

This is the "CPU-runnable reference" config (BASELINE.json:7) and the
validation oracle for every TPU kernel (SURVEY.md §4.1): a plain-Python /
NumPy implementation of the scalar algorithm — sorted-AABB sweep & prune,
box-box SAT + incident-face clipping with stable feature ids, feature-id
contact caching with warm starting, and a sequential-impulse solver with
velocity ("impulses") and position ("displacement") passes.

It intentionally mirrors the *scalar* semantics of the reference
(SURVEY.md §3.2-3.4): joints are processed one at a time in a configurable
order, so the graph-colored TPU sweeps can be validated against the exact
same processing order (set ``joint_order`` to the color-sorted permutation)
as well as against the natural sequential order (convergence-rate parity).

Everything here is deliberately simple and slow — correctness is its only
job.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# SAT reference-face preference (Box2D-style hysteresis so the reference
# face does not flip-flop between nearly-equal axes frame to frame).
REL_TOL = 0.98
ABS_TOL = 0.001


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _rot_mat(rot: np.ndarray) -> np.ndarray:
    c, s = float(rot[0]), float(rot[1])
    return np.array([[c, -s], [s, c]], dtype=np.float64)


def _perp(v):
    return np.array([-v[1], v[0]], dtype=np.float64)


def _cross(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


# Box vertex numbering (CCW): 0=(-x,-y) 1=(+x,-y) 2=(+x,+y) 3=(-x,+y).
# Face f has outward normal: 0:+x, 1:+y, 2:-x, 3:-y.
_FACE_VERTS = {0: (1, 2), 1: (2, 3), 2: (3, 0), 3: (0, 1)}


def _vertex_local(h, vid):
    sx = (-1.0, 1.0, 1.0, -1.0)[vid]
    sy = (-1.0, -1.0, 1.0, 1.0)[vid]
    return np.array([sx * h[0], sy * h[1]], dtype=np.float64)


def _face_index(axis: int, sign: float) -> int:
    if axis == 0:
        return 0 if sign > 0 else 2
    return 1 if sign > 0 else 3


def collide_box_box_np(pa, ra, ha, pb, rb, hb):
    """Box-box SAT + clipping, scalar reference.

    Returns (normal, points, penetrations, feature_ids) where normal points
    from body A toward body B, ``points`` are world positions of up to two
    contact points, and ``feature_ids`` are stable 3-bit ids
    (flip * 4 + incident-vertex-id).  Empty lists when separated.
    """
    pa = np.asarray(pa, np.float64)
    pb = np.asarray(pb, np.float64)
    ha = np.asarray(ha, np.float64)
    hb = np.asarray(hb, np.float64)
    Ra = _rot_mat(np.asarray(ra))
    Rb = _rot_mat(np.asarray(rb))

    d = pb - pa
    da = Ra.T @ d           # B center in A frame
    db = Rb.T @ (-d)        # A center in B frame
    C = Ra.T @ Rb           # columns: B axes in A frame
    absC = np.abs(C)

    sep_a = np.abs(da) - ha - absC @ hb
    sep_b = np.abs(db) - hb - absC.T @ ha
    if sep_a.max() > 0.0 or sep_b.max() > 0.0:
        return None, [], [], []

    axis_a = int(np.argmax(sep_a))
    axis_b = int(np.argmax(sep_b))
    use_b = sep_b[axis_b] > REL_TOL * sep_a[axis_a] + ABS_TOL

    if use_b:
        ref_p, ref_R, ref_h = pb, Rb, hb
        inc_p, inc_R, inc_h = pa, Ra, ha
        axis = axis_b
        sign = 1.0 if db[axis] >= 0.0 else -1.0
    else:
        ref_p, ref_R, ref_h = pa, Ra, ha
        inc_p, inc_R, inc_h = pb, Rb, hb
        axis = axis_a
        sign = 1.0 if da[axis] >= 0.0 else -1.0

    # world normal of the reference face
    n_face = sign * ref_R[:, axis]
    # manifold normal always points A -> B
    normal = -n_face if use_b else n_face

    # incident face: most anti-parallel to the reference face normal
    n_inc = inc_R.T @ n_face
    inc_axis = int(np.argmax(np.abs(n_inc)))
    inc_sign = -1.0 if n_inc[inc_axis] >= 0.0 else 1.0
    fidx = _face_index(inc_axis, inc_sign)
    v0_id, v1_id = _FACE_VERTS[fidx]

    # incident face endpoints in reference-local frame
    def to_ref_local(vid):
        w = inc_p + inc_R @ _vertex_local(inc_h, vid)
        return ref_R.T @ (w - ref_p)

    pts = [to_ref_local(v0_id), to_ref_local(v1_id)]
    ids = [v0_id, v1_id]

    # clip against the two side planes of the reference face
    other = 1 - axis
    for plane_sign in (-1.0, 1.0):
        d0 = plane_sign * pts[0][other] - ref_h[other]
        d1 = plane_sign * pts[1][other] - ref_h[other]
        if d0 > 0.0 and d1 > 0.0:
            return None, [], [], []    # incident face fully outside a side plane
        if d0 > 0.0:
            pts[0] = pts[0] + (pts[1] - pts[0]) * (d0 / (d0 - d1))
            # interpolated point keeps the id of the vertex it replaced,
            # so the id persists while that vertex stays clipped
        elif d1 > 0.0:
            pts[1] = pts[1] + (pts[0] - pts[1]) * (d1 / (d1 - d0))

    flip = 4 if use_b else 0
    out_pts, out_pen, out_ids = [], [], []
    for w, vid in zip(pts, ids):
        separation = sign * w[axis] - ref_h[axis]
        if separation <= 0.0:
            out_pts.append(ref_p + ref_R @ w)
            out_pen.append(-separation)
            out_ids.append(flip + vid)
    return normal, out_pts, out_pen, out_ids


# ---------------------------------------------------------------------------
# world
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _UserJoint:
    """Revolute (kind 1) or distance (kind 2) constraint; scalar analog of
    joints.py rows, solved after the contacts in every iteration."""
    kind: int
    b1: int
    b2: int
    a1: np.ndarray           # local anchors
    a2: np.ndarray
    rest: float = 0.0
    # prepared per frame:
    r1: np.ndarray = None
    r2: np.ndarray = None
    m00: float = 0.0         # revolute 2x2 inverse mass / distance mass
    m01: float = 0.0
    m11: float = 0.0
    n: np.ndarray = None     # distance axis
    dst: np.ndarray = None   # displacement target (2,) rev / (1,) dist
    accum: np.ndarray = None  # warm-start velocity impulse (2,)


@dataclasses.dataclass
class _Joint:
    """Per-contact-point constraint, the scalar analog of the reference's
    ContactJoint (normal + friction limiter, SURVEY.md §2 C6)."""
    b1: int
    b2: int
    normal: np.ndarray
    r1: np.ndarray
    r2: np.ndarray
    penetration: float
    fid: int
    mass_n: float = 0.0
    mass_t: float = 0.0
    dst_velocity: float = 0.0
    dst_disp_velocity: float = 0.0
    friction: float = 0.0
    accum_n: float = 0.0
    accum_t: float = 0.0
    accum_d: float = 0.0


class OracleWorld:
    """Scalar reference world.  Bodies are SoA numpy arrays (float64)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pos: List[np.ndarray] = []
        self.rot: List[np.ndarray] = []      # (cos, sin)
        self.vel: List[np.ndarray] = []
        self.angvel: List[float] = []
        self.inv_mass: List[float] = []
        self.inv_inertia: List[float] = []
        self.half_extent: List[np.ndarray] = []
        self.friction: List[float] = []
        self.restitution: List[float] = []
        # contact cache: {(i, j): {fid: (accum_n, accum_t)}}
        self.cache = {}
        self.joints: List[_Joint] = []
        self.user_joints: List[_UserJoint] = []
        self.last_pairs: List[Tuple[int, int]] = []

    # -- construction --
    def add_box(self, pos, half_extent, angle=0.0, density=1.0,
                friction=0.3, restitution=0.0, static=False,
                velocity=(0.0, 0.0), angvel=0.0) -> int:
        pos = np.asarray(pos, np.float64)
        h = np.asarray(half_extent, np.float64)
        if static:
            inv_m = inv_i = 0.0
        else:
            m = density * 4.0 * h[0] * h[1]
            inertia = m * (h[0] ** 2 + h[1] ** 2) / 3.0
            inv_m, inv_i = 1.0 / m, 1.0 / inertia
        self.pos.append(pos)
        self.rot.append(np.array([np.cos(angle), np.sin(angle)]))
        self.vel.append(np.asarray(velocity, np.float64))
        self.angvel.append(float(angvel))
        self.inv_mass.append(inv_m)
        self.inv_inertia.append(inv_i)
        self.half_extent.append(h)
        self.friction.append(float(friction))
        self.restitution.append(float(restitution))
        return len(self.pos) - 1

    def add_revolute_joint(self, b1: int, b2: int, world_anchor) -> int:
        w = np.asarray(world_anchor, np.float64)
        self.user_joints.append(_UserJoint(
            kind=1, b1=b1, b2=b2,
            a1=self._to_local(b1, w), a2=self._to_local(b2, w),
            accum=np.zeros(2)))
        return len(self.user_joints) - 1

    def add_distance_joint(self, b1: int, b2: int, anchor1, anchor2,
                           rest: Optional[float] = None) -> int:
        w1 = np.asarray(anchor1, np.float64)
        w2 = np.asarray(anchor2, np.float64)
        if rest is None:
            rest = float(np.linalg.norm(w2 - w1))
        self.user_joints.append(_UserJoint(
            kind=2, b1=b1, b2=b2, a1=self._to_local(b1, w1),
            a2=self._to_local(b2, w2), rest=rest, accum=np.zeros(2)))
        return len(self.user_joints) - 1

    def _to_local(self, i, w):
        return _rot_mat(self.rot[i]).T @ (w - self.pos[i])

    @property
    def n(self):
        return len(self.pos)

    # -- broadphase: sorted-AABB sweep & prune (SURVEY.md §3.2) --
    def _aabbs(self):
        lo, hi = [], []
        for i in range(self.n):
            c, s = self.rot[i]
            h = self.half_extent[i]
            e = np.array([abs(c) * h[0] + abs(s) * h[1],
                          abs(s) * h[0] + abs(c) * h[1]])
            lo.append(self.pos[i] - e)
            hi.append(self.pos[i] + e)
        return np.array(lo), np.array(hi)

    def broadphase(self) -> List[Tuple[int, int]]:
        lo, hi = self._aabbs()
        order = sorted(range(self.n), key=lambda i: lo[i, 0])
        skip = {(min(uj.b1, uj.b2), max(uj.b1, uj.b2))
                for uj in self.user_joints}   # collide-connected = false
        pairs = []
        for si, i in enumerate(order):
            for j in order[si + 1:]:
                if lo[j, 0] > hi[i, 0]:
                    break          # sweep: no later body can overlap in x
                if lo[j, 1] > hi[i, 1] or lo[i, 1] > hi[j, 1]:
                    continue
                if self.inv_mass[i] == 0.0 and self.inv_mass[j] == 0.0:
                    continue
                if (min(i, j), max(i, j)) in skip:
                    continue
                pairs.append((min(i, j), max(i, j)))
        pairs.sort()
        return pairs

    # -- one frame (Scene::Update equivalent, SURVEY.md §3.2) --
    def step(self, joint_order: Optional[Sequence[int]] = None):
        cfg = self.cfg
        dt = cfg.dt
        g = np.asarray(cfg.gravity, np.float64)

        # 1. integrate velocities
        for i in range(self.n):
            if self.inv_mass[i] > 0.0:
                self.vel[i] = self.vel[i] + g * dt

        # 2-3. broadphase + narrowphase with feature-id cache match
        pairs = self.broadphase()
        self.last_pairs = pairs
        joints: List[_Joint] = []
        new_cache = {}
        for (i, j) in pairs:
            normal, pts, pens, fids = collide_box_box_np(
                self.pos[i], self.rot[i], self.half_extent[i],
                self.pos[j], self.rot[j], self.half_extent[j])
            if not pts:
                continue
            old = self.cache.get((i, j), {})
            entry = {}
            for p, pen, fid in zip(pts, pens, fids):
                jt = _Joint(b1=i, b2=j, normal=np.asarray(normal),
                            r1=p - self.pos[i], r2=p - self.pos[j],
                            penetration=pen, fid=fid)
                if fid in old:
                    jt.accum_n, jt.accum_t = old[fid]
                joints.append(jt)
                entry[fid] = (0.0, 0.0)
            new_cache[(i, j)] = entry

        # 4. prepare (PrepareJoints, SURVEY.md §3.4)
        for jt in joints:
            self._prepare(jt)
        for uj in self.user_joints:
            self._prepare_user(uj)

        # 5. warm start: re-apply cached accumulated impulses
        for jt in joints:
            t = _perp(jt.normal)
            self._apply(jt, jt.normal * jt.accum_n + t * jt.accum_t)
        for uj in self.user_joints:
            if uj.kind == 1:
                self._apply_user(uj, uj.accum.copy())
            else:
                self._apply_user(uj, uj.n * uj.accum[0])

        order = list(joint_order) if joint_order is not None \
            else list(range(len(joints)))

        # 6. velocity iterations (SolveJointsImpulses, hot loop #1);
        #    user joints sweep after the contacts in every iteration,
        #    matching the kernels' slot ordering.  residual_history records
        #    the max |impulse delta| over contact rows per iteration —
        #    the same quantity the kernels report for their LAST iteration
        #    (the 1e-3 accuracy gate, BASELINE.json:5).
        self.residual_history = []
        for _ in range(cfg.velocity_iterations):
            res = 0.0
            for k in order:
                res = max(res, self._solve_velocity(joints[k]))
            for uj in self.user_joints:
                self._solve_user_velocity(uj)
            self.residual_history.append(res)

        # 7. position / displacement iterations (hot loop #2)
        dvel = [np.zeros(2) for _ in range(self.n)]
        dang = [0.0 for _ in range(self.n)]
        for _ in range(cfg.position_iterations):
            for k in order:
                self._solve_displacement(joints[k], dvel, dang)
            for uj in self.user_joints:
                self._solve_user_displacement(uj, dvel, dang)

        # 8. integrate positions (+ displacement pseudo-velocities)
        for i in range(self.n):
            self.pos[i] = self.pos[i] + self.vel[i] * dt + dvel[i]
            w = self.angvel[i] * dt + dang[i]
            c, s = np.cos(w), np.sin(w)
            rc, rs = self.rot[i]
            r = np.array([c * rc - s * rs, s * rc + c * rs])
            self.rot[i] = r / np.linalg.norm(r)

        # 9. store accumulated impulses for next-frame warm start
        for jt in joints:
            new_cache[(jt.b1, jt.b2)][jt.fid] = (jt.accum_n, jt.accum_t)
        self.cache = new_cache
        self.joints = joints
        return joints

    # -- solver internals --
    def _prepare(self, jt: _Joint):
        cfg = self.cfg
        i, j = jt.b1, jt.b2
        n = jt.normal
        t = _perp(n)
        rn1, rn2 = _cross(jt.r1, n), _cross(jt.r2, n)
        kn = (self.inv_mass[i] + self.inv_mass[j]
              + self.inv_inertia[i] * rn1 ** 2 + self.inv_inertia[j] * rn2 ** 2)
        jt.mass_n = 1.0 / kn if kn > 0.0 else 0.0
        rt1, rt2 = _cross(jt.r1, t), _cross(jt.r2, t)
        kt = (self.inv_mass[i] + self.inv_mass[j]
              + self.inv_inertia[i] * rt1 ** 2 + self.inv_inertia[j] * rt2 ** 2)
        jt.mass_t = 1.0 / kt if kt > 0.0 else 0.0
        jt.friction = float(np.sqrt(self.friction[i] * self.friction[j]))

        vn0 = float(n @ self._point_vel(j, jt.r2) - n @ self._point_vel(i, jt.r1))
        e = max(self.restitution[i], self.restitution[j])
        jt.dst_velocity = -e * vn0 if vn0 < -cfg.restitution_threshold else 0.0
        jt.dst_disp_velocity = min(
            cfg.max_displacement_velocity,
            cfg.contact_beta * max(0.0, jt.penetration - cfg.slop))

    def _point_vel(self, i, r):
        w = self.angvel[i]
        return self.vel[i] + np.array([-w * r[1], w * r[0]])

    # -- user joints (revolute / distance, joints.py semantics) --
    def _prepare_user(self, uj: _UserJoint):
        cfg = self.cfg
        i, j = uj.b1, uj.b2
        uj.r1 = _rot_mat(self.rot[i]) @ uj.a1
        uj.r2 = _rot_mat(self.rot[j]) @ uj.a2
        err = (self.pos[j] + uj.r2) - (self.pos[i] + uj.r1)
        im1, im2 = self.inv_mass[i], self.inv_mass[j]
        ii1, ii2 = self.inv_inertia[i], self.inv_inertia[j]
        lim = cfg.max_displacement_velocity
        if uj.kind == 1:
            k00 = im1 + im2 + ii1 * uj.r1[1] ** 2 + ii2 * uj.r2[1] ** 2
            k01 = -ii1 * uj.r1[0] * uj.r1[1] - ii2 * uj.r2[0] * uj.r2[1]
            k11 = im1 + im2 + ii1 * uj.r1[0] ** 2 + ii2 * uj.r2[0] ** 2
            det = k00 * k11 - k01 * k01
            inv = 1.0 / det if abs(det) > 1e-30 else 0.0
            uj.m00, uj.m01, uj.m11 = k11 * inv, -k01 * inv, k00 * inv
            uj.dst = np.clip(-cfg.joint_beta * err, -lim, lim)
        else:
            dist = float(np.linalg.norm(err))
            uj.n = err / dist if dist > 1e-9 else np.array([1.0, 0.0])
            rn1, rn2 = _cross(uj.r1, uj.n), _cross(uj.r2, uj.n)
            kd = im1 + im2 + ii1 * rn1 ** 2 + ii2 * rn2 ** 2
            uj.m00 = 1.0 / kd if kd > 0.0 else 0.0
            uj.dst = np.array([
                np.clip(cfg.joint_beta * (uj.rest - dist), -lim, lim)])

    def _apply_user(self, uj: _UserJoint, impulse: np.ndarray):
        i, j = uj.b1, uj.b2
        self.vel[i] = self.vel[i] - impulse * self.inv_mass[i]
        self.angvel[i] -= self.inv_inertia[i] * _cross(uj.r1, impulse)
        self.vel[j] = self.vel[j] + impulse * self.inv_mass[j]
        self.angvel[j] += self.inv_inertia[j] * _cross(uj.r2, impulse)

    def _solve_user_velocity(self, uj: _UserJoint):
        dv = self._point_vel(uj.b2, uj.r2) - self._point_vel(uj.b1, uj.r1)
        if uj.kind == 1:
            imp = -np.array([uj.m00 * dv[0] + uj.m01 * dv[1],
                             uj.m01 * dv[0] + uj.m11 * dv[1]])
            uj.accum = uj.accum + imp
        else:
            d = -uj.m00 * float(uj.n @ dv)
            uj.accum = uj.accum + np.array([d, 0.0])
            imp = uj.n * d
        self._apply_user(uj, imp)

    def _solve_user_displacement(self, uj: _UserJoint, dvel, dang):
        i, j = uj.b1, uj.b2
        pv1 = dvel[i] + np.array([-dang[i] * uj.r1[1], dang[i] * uj.r1[0]])
        pv2 = dvel[j] + np.array([-dang[j] * uj.r2[1], dang[j] * uj.r2[0]])
        dv = pv2 - pv1
        if uj.kind == 1:
            ex, ey = uj.dst[0] - dv[0], uj.dst[1] - dv[1]
            imp = np.array([uj.m00 * ex + uj.m01 * ey,
                            uj.m01 * ex + uj.m11 * ey])
        else:
            imp = uj.n * (uj.m00 * (uj.dst[0] - float(uj.n @ dv)))
        dvel[i] = dvel[i] - imp * self.inv_mass[i]
        dang[i] -= self.inv_inertia[i] * _cross(uj.r1, imp)
        dvel[j] = dvel[j] + imp * self.inv_mass[j]
        dang[j] += self.inv_inertia[j] * _cross(uj.r2, imp)

    def _apply(self, jt: _Joint, impulse: np.ndarray):
        i, j = jt.b1, jt.b2
        self.vel[i] = self.vel[i] - impulse * self.inv_mass[i]
        self.angvel[i] -= self.inv_inertia[i] * _cross(jt.r1, impulse)
        self.vel[j] = self.vel[j] + impulse * self.inv_mass[j]
        self.angvel[j] += self.inv_inertia[j] * _cross(jt.r2, impulse)

    def _solve_velocity(self, jt: _Joint) -> float:
        """Returns the max |impulse delta| of this visit (residual term)."""
        n = jt.normal
        t = _perp(n)
        # normal limiter
        dv = self._point_vel(jt.b2, jt.r2) - self._point_vel(jt.b1, jt.r1)
        d_imp = (jt.dst_velocity - float(n @ dv)) * jt.mass_n
        new_acc = max(jt.accum_n + d_imp, 0.0)
        d_imp = new_acc - jt.accum_n
        jt.accum_n = new_acc
        self._apply(jt, n * d_imp)
        res = abs(d_imp)
        # friction limiter (clamped by accumulated normal impulse)
        dv = self._point_vel(jt.b2, jt.r2) - self._point_vel(jt.b1, jt.r1)
        d_imp = -float(t @ dv) * jt.mass_t
        max_f = jt.friction * jt.accum_n
        new_acc = min(max(jt.accum_t + d_imp, -max_f), max_f)
        d_imp = new_acc - jt.accum_t
        jt.accum_t = new_acc
        self._apply(jt, t * d_imp)
        return max(res, abs(d_imp))

    def _solve_displacement(self, jt: _Joint, dvel, dang):
        i, j = jt.b1, jt.b2
        n = jt.normal
        pv1 = dvel[i] + np.array([-dang[i] * jt.r1[1], dang[i] * jt.r1[0]])
        pv2 = dvel[j] + np.array([-dang[j] * jt.r2[1], dang[j] * jt.r2[0]])
        d_imp = (jt.dst_disp_velocity - float(n @ (pv2 - pv1))) * jt.mass_n
        new_acc = max(jt.accum_d + d_imp, 0.0)
        d_imp = new_acc - jt.accum_d
        jt.accum_d = new_acc
        imp = n * d_imp
        dvel[i] -= imp * self.inv_mass[i]
        dang[i] -= self.inv_inertia[i] * _cross(jt.r1, imp)
        dvel[j] += imp * self.inv_mass[j]
        dang[j] += self.inv_inertia[j] * _cross(jt.r2, imp)

    # -- diagnostics --
    def max_penetration(self) -> float:
        pairs = self.broadphase()
        worst = 0.0
        for (i, j) in pairs:
            _, pts, pens, _ = collide_box_box_np(
                self.pos[i], self.rot[i], self.half_extent[i],
                self.pos[j], self.rot[j], self.half_extent[j])
            for pen in pens:
                worst = max(worst, pen)
        return worst

    def momentum(self) -> np.ndarray:
        p = np.zeros(2)
        for i in range(self.n):
            if self.inv_mass[i] > 0.0:
                p += self.vel[i] / self.inv_mass[i]
        return p

    def kinetic_energy(self) -> float:
        e = 0.0
        for i in range(self.n):
            if self.inv_mass[i] > 0.0:
                e += 0.5 * float(self.vel[i] @ self.vel[i]) / self.inv_mass[i]
            if self.inv_inertia[i] > 0.0:
                e += 0.5 * self.angvel[i] ** 2 / self.inv_inertia[i]
        return e
