"""The reference's default-backend step tests (tests/test_step.py:17-133)
on the port: ``SimConfig``'s default ``solver_backend="xla"``, the colored
solve, held to the f64 oracle of the JAX package and to the invariants
those tests check, at their tolerances."""

import numpy as np
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
from phyx_tpu_torch import SceneBuilder, scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import step

torch.set_num_threads(1)

SMALL = dict(max_bodies=64, max_pairs=512, broadphase="n2")
CFG_SMALL = SimConfig(**SMALL)


def run(st, cfg, frames):
    for _ in range(frames):
        st = step(st, cfg)
    return st


def test_default_backend_is_xla():
    assert SimConfig().solver_backend == "xla" == JaxConfig().solver_backend


def test_free_fall():
    sb = SceneBuilder(CFG_SMALL)
    sb.add_box((0.0, 100.0), (0.5, 0.5))
    st = run(sb.build("cpu"), CFG_SMALL, 10)
    # y = 100 - sum_{k=1..10} g*k*dt^2 (symplectic Euler)
    dt, g = CFG_SMALL.dt, -CFG_SMALL.gravity[1]
    expect_y = 100.0 - g * dt * dt * sum(range(1, 11))
    assert abs(float(st.bodies.pos[0, 1]) - expect_y) < 1e-3
    assert abs(float(st.bodies.vel[0, 1]) + g * dt * 10) < 1e-4


def test_single_box_rests_on_ground():
    sb = SceneBuilder(CFG_SMALL)
    sb.add_box((0.0, -10.0), (100.0, 10.0), static=True)
    sb.add_box((0.0, 0.55), (0.5, 0.5))
    st = run(sb.build("cpu"), CFG_SMALL, 120)
    assert abs(float(st.bodies.pos[1, 1]) - 0.5) < 0.02
    assert abs(float(st.bodies.vel[1, 1])) < 0.01
    assert float(st.stats.max_penetration) < 0.03


def test_oracle_trajectory_parity_two_boxes():
    """One contact pair, no ordering ambiguity: the trajectory tracks the
    oracle's closely for 90 frames."""
    builders = (SceneBuilder(CFG_SMALL), JaxSceneBuilder(JaxConfig(**SMALL)))
    for sb in builders:
        sb.add_box((0.0, -10.0), (100.0, 10.0), static=True, friction=0.5)
        sb.add_box((0.0, 1.2), (0.5, 0.5), friction=0.5, velocity=(2.0, 0.0))
    st = builders[0].build("cpu")
    ow = builders[1].to_oracle()
    for frame in range(90):
        st = step(st, CFG_SMALL)
        ow.step()
        np.testing.assert_allclose(st.bodies.pos[1].numpy(),
                                   np.asarray(ow.pos[1]), atol=2e-3,
                                   err_msg=f"frame {frame}")


def test_oracle_parity_small_stack():
    """A 3-box stack settles where the oracle's does (the color order
    differs from the oracle's serial order: the reference's 2e-2)."""
    st = run(scenes.stack(CFG_SMALL, 3).build("cpu"), CFG_SMALL, 150)
    ow = jscenes.stack(JaxConfig(**SMALL), 3).to_oracle()
    for _ in range(150):
        ow.step()
    pos = st.bodies.pos[1:4].numpy()
    np.testing.assert_allclose(pos, np.asarray(ow.pos)[1:4], atol=2e-2)
    assert np.all(np.diff(pos[:, 1]) > 0.8)


def test_momentum_conservation_no_gravity():
    cfg = SimConfig(max_bodies=16, max_pairs=64, broadphase="n2",
                    gravity=(0.0, 0.0))
    sb = SceneBuilder(cfg)
    sb.add_box((-2.0, 0.0), (0.5, 0.5), velocity=(3.0, 0.0), friction=0.0)
    sb.add_box((2.0, 0.01), (0.5, 0.5), velocity=(-1.0, 0.0), friction=0.0)
    st = sb.build("cpu")

    def momentum(s):
        m = 1.0 / s.bodies.inv_mass[:2].numpy()
        return (s.bodies.vel[:2].numpy() * m[:, None]).sum(0)
    p0 = momentum(st)
    p1 = momentum(run(st, cfg, 120))
    assert np.allclose(p0, p1, atol=1e-3), f"{p0} vs {p1}"


def test_stack_stability_warm_start():
    """A 10-box stack stays standing for 300 frames."""
    cfg = SimConfig(max_bodies=32, max_pairs=256, broadphase="n2",
                    velocity_iterations=10, position_iterations=6)
    st = run(scenes.stack(cfg, 10).build("cpu"), cfg, 300)
    ys = st.bodies.pos[1:11, 1].numpy()
    xs = st.bodies.pos[1:11, 0].numpy()
    assert np.all(np.diff(ys) > 0.7), f"stack collapsed: {ys}"
    assert np.all(np.abs(xs) < 0.5), f"stack drifted: {xs}"
    assert float(st.stats.max_penetration) < 0.05


def test_no_energy_gain_pile():
    cfg = SimConfig(max_bodies=64, max_pairs=512, broadphase="n2")
    st = scenes.pile(cfg, 20, seed=3).build("cpu")

    def ke(s):
        b = s.bodies
        im, ii = b.inv_mass.numpy(), b.inv_inertia.numpy()
        m = np.where(im > 0, 1.0 / np.maximum(im, 1e-9), 0.0)
        iw = np.where(ii > 0, 1.0 / np.maximum(ii, 1e-9), 0.0)
        v2 = (b.vel.numpy() ** 2).sum(-1)
        return float((0.5 * m * v2 + 0.5 * iw * b.angvel.numpy() ** 2).sum())
    # settle, then energy must decay (restitution 0, friction on)
    st = run(st, cfg, 100)
    e0 = ke(st)
    e1 = ke(run(st, cfg, 100))
    assert e1 < max(e0, 1e-2) + 1e-3, f"energy grew {e0} -> {e1}"
