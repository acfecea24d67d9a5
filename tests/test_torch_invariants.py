"""The reference's physical invariant tests under ``solver_backend=
"pallas"`` (tests/test_invariants.py) on the port: momentum without
gravity, no energy gain, stack stability, the friction cone and a
restitution bounce, at the reference's scenes, frames and tolerances.  On
the CPU the solve is the serial kernels' plain version."""

import numpy as np
import pytest
import torch

from phyx_tpu_torch import SceneBuilder, scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import rollout, step

torch.set_num_threads(1)

CFG = SimConfig(max_bodies=64, max_pairs=512, broadphase="n2",
                gravity=(0.0, 0.0), solver_backend="pallas")


def _dynamic(st):
    b = st.bodies
    return ((b.inv_mass > 0) & b.active).numpy()


def _momentum(st):
    dyn = _dynamic(st)
    v = st.bodies.vel.numpy()[dyn]
    m = 1.0 / st.bodies.inv_mass.numpy()[dyn]
    return (v * m[:, None]).sum(axis=0)


def _energy(st):
    dyn = _dynamic(st)
    v = st.bodies.vel.numpy()[dyn]
    m = 1.0 / st.bodies.inv_mass.numpy()[dyn]
    w = st.bodies.angvel.numpy()[dyn]
    i = 1.0 / st.bodies.inv_inertia.numpy()[dyn]
    return float(0.5 * (m * (v ** 2).sum(-1)).sum() + 0.5 * (i * w ** 2).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_momentum_conserved_zero_gravity(seed):
    """Collisions without gravity or statics: total linear momentum is
    invariant (impulses are internal, equal and opposite)."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(CFG)
    for k in range(8):
        sb.add_box((2.2 * k - 8.0, rng.uniform(-1, 1)), (0.5, 0.5),
                   velocity=(rng.uniform(-3, 3), rng.uniform(-1, 1)),
                   angvel=rng.uniform(-2, 2), friction=0.4)
    st = sb.build("cpu")
    p0 = _momentum(st)
    st = rollout(st, CFG, 120)
    np.testing.assert_allclose(p0, _momentum(st), atol=5e-3)


@pytest.mark.parametrize("seed", [0, 3])
def test_no_energy_gain(seed):
    """Inelastic contacts (restitution 0) never add kinetic energy."""
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(CFG)
    for k in range(8):
        sb.add_box((2.2 * k - 8.0, rng.uniform(-1, 1)), (0.5, 0.5),
                   velocity=(rng.uniform(-3, 3), rng.uniform(-1, 1)),
                   friction=0.5)
    st = sb.build("cpu")
    e = _energy(st)
    for _ in range(6):
        st = rollout(st, CFG, 20)
        e2 = _energy(st)
        assert e2 <= e * 1.001 + 1e-4, f"energy grew {e} -> {e2}"
        e = e2


def test_stack_stability_warm_start():
    """A tower of 12 boxes stays standing for 600 frames: only possible
    with working warm starts."""
    cfg = SimConfig(max_bodies=32, max_pairs=256, broadphase="n2",
                    solver_backend="pallas")
    st = rollout(scenes.stack(cfg, 12).build("cpu"), cfg, 600)
    ys = st.bodies.pos[1:13, 1].numpy()
    np.testing.assert_allclose(ys, 0.5 + np.arange(12), atol=0.08)
    assert float(st.stats.max_penetration) < 0.03


def test_friction_cone_respected():
    """A box on a shallow slope with high friction does not slide; with
    near-zero friction it does."""
    def run(mu):
        cfg = SimConfig(max_bodies=8, max_pairs=64, broadphase="n2",
                        solver_backend="pallas")
        sb = SceneBuilder(cfg)
        sb.add_box((0.0, -2.0), (50.0, 2.0), angle=0.15, static=True,
                   friction=mu)
        sb.add_box((0.0, 0.65), (0.5, 0.5), angle=0.15, friction=mu)
        st = rollout(sb.build("cpu"), cfg, 240)
        return float(st.bodies.pos[1, 0])

    assert abs(run(0.8)) < 0.05, "high-friction box slid on shallow slope"
    assert run(0.01) < -0.5, "frictionless box failed to slide"


def test_restitution_bounce():
    cfg = SimConfig(max_bodies=8, max_pairs=64, broadphase="n2",
                    solver_backend="pallas")
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -10.0), (100.0, 10.0), static=True)
    sb.add_box((0.0, 3.0), (0.5, 0.5), restitution=0.8)
    st = sb.build("cpu")
    peak = 0.0
    bounced = False
    prev_y = 3.0
    for _ in range(200):
        st = step(st, cfg)
        y = float(st.bodies.pos[1, 1])
        if y > prev_y and prev_y < 1.0:
            bounced = True
        if bounced:
            peak = max(peak, y)
        prev_y = y
    assert bounced and 1.0 < peak < 2.6, f"bounce peak {peak}"
