"""2D vector / rotation math on SoA tensors (``phyx_tpu/math2d.py``).

A rotation is ``(c, s) = (cos t, sin t)`` stacked on the last axis.  Vectors
are ``(..., 2)`` tensors, scalars ``(...)`` tensors; every function is
shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import torch


def vec2(x, y):
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    return torch.stack(torch.broadcast_tensors(x, y), dim=-1)


def dot(a, b):
    return (a * b).sum(dim=-1)


def cross(a, b):
    """2D scalar cross product a.x*b.y - a.y*b.x."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cross_sv(s, v):
    """Cross of scalar (angular velocity) with vector: (-s*vy, s*vx)."""
    return torch.stack((-s * v[..., 1], s * v[..., 0]), dim=-1)


def perp(v):
    """Counter-clockwise perpendicular (-y, x)."""
    return torch.stack((-v[..., 1], v[..., 0]), dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v, eps=1e-12):
    return v / torch.clamp(length(v), min=eps)[..., None]


def rot_identity(shape=(), device=None):
    c = torch.ones(shape, dtype=torch.float32, device=device)
    s = torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.stack((c, s), dim=-1)


def rot_from_angle(theta):
    theta = torch.as_tensor(theta, dtype=torch.float32)
    return torch.stack((torch.cos(theta), torch.sin(theta)), dim=-1)


def rot_angle(r):
    return torch.atan2(r[..., 1], r[..., 0])


def rot_mul(a, b):
    """Compose rotations: result = a * b (apply b then a)."""
    c = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    s = a[..., 1] * b[..., 0] + a[..., 0] * b[..., 1]
    return torch.stack((c, s), dim=-1)


def rot_apply(r, v):
    """Rotate vector v by r."""
    x = r[..., 0] * v[..., 0] - r[..., 1] * v[..., 1]
    y = r[..., 1] * v[..., 0] + r[..., 0] * v[..., 1]
    return torch.stack((x, y), dim=-1)


def rot_inv_apply(r, v):
    """Rotate vector v by the inverse of r."""
    x = r[..., 0] * v[..., 0] + r[..., 1] * v[..., 1]
    y = -r[..., 1] * v[..., 0] + r[..., 0] * v[..., 1]
    return torch.stack((x, y), dim=-1)


def rot_normalize(r, eps=1e-12):
    """Re-orthonormalize a (cos, sin) pair after repeated composition."""
    return r / torch.clamp(torch.sqrt((r * r).sum(dim=-1)), min=eps)[..., None]


def rot_advance(r, omega_dt):
    """Advance rotation by a small angle omega*dt (exact trig + renorm)."""
    return rot_normalize(rot_mul(rot_from_angle(omega_dt), r))


def transform_point(pos, rot, p_local):
    """World position of a body-local point."""
    return pos + rot_apply(rot, p_local)


def inv_transform_point(pos, rot, p_world):
    return rot_inv_apply(rot, p_world - pos)
