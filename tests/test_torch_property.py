"""The reference's hypothesis properties (tests/test_property.py:42-145)
with the port's ``step`` on the CPU, under ``"pallas"``: the same
strategies, scenes and ``SETTLE`` settings.  The settling property is in
tests/test_torch_property_settle.py."""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import step
from phyx_tpu_torch.world import SceneBuilder

torch.set_num_threads(1)

SETTLE = dict(deadline=None, max_examples=25, derandomize=True)

CFG_FREE = SimConfig(max_bodies=16, max_pairs=64, broadphase="n2",
                     solver_backend="pallas", gravity=(0.0, 0.0))
CFG_G = SimConfig(max_bodies=16, max_pairs=64, broadphase="n2",
                  solver_backend="pallas")

box = st.tuples(
    st.floats(-2.0, 2.0), st.floats(-2.0, 2.0),      # pos
    st.floats(-3.1, 3.1),                            # angle
    st.floats(0.3, 1.2), st.floats(0.3, 1.2),        # half extents
    st.floats(-2.0, 2.0), st.floats(-2.0, 2.0),      # velocity
    st.floats(-2.0, 2.0),                            # angvel
)


def _build(boxes, cfg, friction=0.5, restitution=0.0):
    sb = SceneBuilder(cfg)
    for (x, y, a, hx, hy, vx, vy, w) in boxes:
        sb.add_box((x, y), (hx, hy), angle=a, friction=friction,
                   restitution=restitution, velocity=(vx, vy), angvel=w)
    return sb.build("cpu")


@settings(**SETTLE)
@given(st.lists(box, min_size=2, max_size=6))
def test_prop_momentum_conserved_without_gravity(boxes):
    """Contact impulses are internal (equal and opposite): with zero
    gravity and no static bodies, total linear momentum is invariant."""
    st_ = _build(boxes, CFG_FREE)
    inv_m = st_.bodies.inv_mass.numpy()
    mask = inv_m > 0
    p0 = (st_.bodies.vel.numpy()[mask] / inv_m[mask, None]).sum(0)
    for _ in range(10):
        st_ = step(st_, CFG_FREE)
    p1 = (st_.bodies.vel.numpy()[mask] / inv_m[mask, None]).sum(0)
    np.testing.assert_allclose(p1, p0, atol=1e-3 * max(1.0, np.abs(p0).max()))


@settings(**SETTLE)
@given(st.lists(box, min_size=2, max_size=6))
def test_prop_no_energy_gain(boxes):
    """With restitution 0 the sequential-impulse solve only dissipates:
    kinetic energy never increases (no gravity; split-impulse displacement
    adds no kinetic energy by construction)."""
    st_ = _build(boxes, CFG_FREE, restitution=0.0)

    def ke(s):
        inv_m = s.bodies.inv_mass.numpy()
        inv_i = s.bodies.inv_inertia.numpy()
        m = np.where(inv_m > 0, 1.0 / np.maximum(inv_m, 1e-9), 0.0)
        i = np.where(inv_i > 0, 1.0 / np.maximum(inv_i, 1e-9), 0.0)
        v2 = (s.bodies.vel.numpy() ** 2).sum(1)
        return float(0.5 * (m * v2 + i * s.bodies.angvel.numpy() ** 2).sum())

    e = ke(st_)
    for _ in range(10):
        st_ = step(st_, CFG_FREE)
        e2 = ke(st_)
        assert e2 <= e * (1 + 1e-4) + 1e-6, f"energy grew {e} -> {e2}"
        e = e2


@settings(**SETTLE)
@given(st.lists(box, min_size=2, max_size=6), st.floats(0.1, 0.9))
def test_prop_friction_cone(boxes, mu):
    """Accumulated friction impulses stay inside the cone |t| <= mu*n
    (the cache holds the accumulators written back after the solve)."""
    st_ = _build(boxes, CFG_G, friction=mu)
    for _ in range(8):
        st_ = step(st_, CFG_G)
    fn = st_.cache.normal_impulse.numpy().ravel()
    ft = st_.cache.friction_impulse.numpy().ravel()
    live = st_.cache.fid.numpy().ravel() >= 0
    assert np.all(fn[live] >= -1e-6), "negative normal impulse cached"
    assert np.all(np.abs(ft[live]) <= mu * fn[live] + 1e-5), \
        "friction impulse escaped the cone"


@settings(**SETTLE)
@given(st.lists(box, min_size=1, max_size=6))
def test_prop_rotation_basis_stays_normalized(boxes):
    """The (cos, sin) rotation basis must stay unit-norm under integration
    (rot_advance renormalizes)."""
    st_ = _build(boxes, CFG_G)
    for _ in range(15):
        st_ = step(st_, CFG_G)
    norm = (st_.bodies.rot.numpy() ** 2).sum(1)
    active = st_.bodies.active.numpy()
    np.testing.assert_allclose(norm[active], 1.0, atol=1e-4)


@settings(**SETTLE)
@given(st.lists(box, min_size=1, max_size=4), st.integers(0, 2 ** 31 - 1))
def test_prop_inactive_slots_never_move(boxes, seed):
    """Capacity padding: inactive body slots are parked and must be
    bit-identical after any number of steps."""
    st_ = _build(boxes, CFG_G)
    parked = st_.bodies.pos[len(boxes):].numpy().copy()
    for _ in range(5):
        st_ = step(st_, CFG_G)
    np.testing.assert_array_equal(st_.bodies.pos[len(boxes):].numpy(),
                                  parked)
    assert np.all(st_.bodies.vel[len(boxes):].numpy() == 0.0)
