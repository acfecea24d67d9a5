"""The port's f64 oracle and ``SceneBuilder.to_oracle`` against the JAX
package's, and the accuracy gate (per-iteration residual within 1e-3 of
the oracle) with the port's ``step`` (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.oracle import OracleWorld
from phyx_tpu_torch.step import step

torch.set_num_threads(1)

# tests/test_pallas_solver.py's and tests/test_joints.py's oracle configs
ORACLE = dict(max_bodies=32, max_pairs=128, broadphase="n2",
              solver_backend="pallas")
JOINT_ORACLE = dict(max_bodies=64, max_pairs=256, max_joints=32,
                    broadphase="n2", solver_backend="pallas")
BODY_LISTS = ("pos", "rot", "vel", "angvel", "inv_mass", "inv_inertia",
              "half_extent", "friction", "restitution")
JOINT_FIELDS = ("kind", "b1", "b2", "a1", "a2", "rest", "accum")

SCENES = {
    "pile10": (ORACLE, lambda m, cfg: m.pile(cfg, 10, seed=2)),
    "chain5": (JOINT_ORACLE, lambda m, cfg: m.chain(cfg, 5)),
}


def assert_worlds_equal(a, b):
    assert type(a).__module__ == "phyx_tpu_torch.oracle.engine"
    assert a.n == b.n
    for name in BODY_LISTS:
        x = np.asarray(getattr(a, name), np.float64)
        y = np.asarray(getattr(b, name), np.float64)
        assert x.tobytes() == y.tobytes(), name
    assert len(a.user_joints) == len(b.user_joints)
    for ja, jb in zip(a.user_joints, b.user_joints):
        for name in JOINT_FIELDS:
            x, y = np.asarray(getattr(ja, name)), np.asarray(getattr(jb, name))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert a.cache.keys() == b.cache.keys()
    for key in a.cache:
        assert a.cache[key] == b.cache[key], key
    assert a.last_pairs == b.last_pairs
    assert a.residual_history == b.residual_history


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_to_oracle_matches_jax_over_30_frames(scene):
    kw, make = SCENES[scene]
    ours = make(scenes, SimConfig(**kw)).to_oracle()
    ref = make(jscenes, JaxConfig(**kw)).to_oracle()
    assert isinstance(ours, OracleWorld)
    ours.residual_history = ref.residual_history = []
    assert_worlds_equal(ours, ref)
    for _ in range(30):
        ours.step()
        ref.step()
    assert_worlds_equal(ours, ref)
    assert ours.max_penetration() == ref.max_penetration()
    assert ours.kinetic_energy() == ref.kinetic_energy()
    assert np.array_equal(ours.momentum(), ref.momentum())


def test_to_oracle_keeps_static_bodies_and_inverse_masses():
    """The builder's f64 rows reach the oracle: a static ground, a dense
    box and a spinning one."""
    from phyx_tpu_torch import SceneBuilder
    sb = SceneBuilder(SimConfig(**ORACLE))
    sb.add_box((0.0, -10.0), (100.0, 10.0), static=True, friction=0.5)
    sb.add_box((0.3, 1.2), (0.5, 0.25), angle=0.4, density=3.0,
               velocity=(2.0, -1.0), angvel=0.7, restitution=0.2)
    w = sb.to_oracle()
    assert w.inv_mass[0] == 0.0 and w.inv_inertia[0] == 0.0
    m = 3.0 * 4.0 * 0.5 * 0.25
    assert w.inv_mass[1] == 1.0 / m
    assert w.inv_inertia[1] == 1.0 / (m * (0.5 ** 2 + 0.25 ** 2) / 3.0)
    assert w.rot[1].tolist() == [np.cos(0.4), np.sin(0.4)]
    assert w.vel[1].tolist() == [2.0, -1.0] and w.angvel[1] == 0.7
    assert w.restitution[1] == 0.2


def test_per_iteration_residual_parity_vs_oracle():
    """The accuracy gate (tests/test_pallas_solver.py:57-100) with the
    port's ``step`` and the port's oracle: develop a 10-box pile, snapshot
    the bodies into both with cold caches; the port's residual at
    iteration k (a solve with velocity_iterations=k) must track the
    oracle's per-iteration residual within 1e-3 for k = 1..8."""
    K = 8
    cfg = SimConfig(**ORACLE)
    sb = scenes.pile(cfg, 10, seed=2)
    st = sb.build("cpu")
    fresh_cache = st.cache
    for _ in range(30):
        st = step(st, cfg)
    st = st.replace(cache=fresh_cache)      # cold start

    ow = sb.to_oracle()
    pos = st.bodies.pos.numpy().astype(np.float64)
    rot = st.bodies.rot.numpy().astype(np.float64)
    vel = st.bodies.vel.numpy().astype(np.float64)
    ang = st.bodies.angvel.numpy().astype(np.float64)
    for i in range(ow.n):
        ow.pos[i] = pos[i].copy()
        ow.rot[i] = rot[i].copy()
        ow.vel[i] = vel[i].copy()
        ow.angvel[i] = float(ang[i])
    ow.cache = {}                            # cold start
    ow.step()
    assert len(ow.residual_history) == cfg.velocity_iterations
    oracle_seq = ow.residual_history[:K]
    assert oracle_seq[0] > 0.01, "scene too settled to exercise the gate"

    engine_seq = [
        float(step(st, dataclasses.replace(
            cfg, velocity_iterations=k)).stats.residual)
        for k in range(1, K + 1)]

    err = np.abs(np.asarray(engine_seq) - np.asarray(oracle_seq))
    assert err.max() < 1e-3, (
        f"per-iteration residual diverges from oracle by {err.max()}:\n"
        f"engine {engine_seq}\noracle {oracle_seq}")
