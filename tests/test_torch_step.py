"""The port's whole ``step`` against the JAX package's ``step`` (its fused
Pallas solver in interpret mode) and against the f64 oracle, on piles and
on the jointed scenes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.step import step as jax_step
from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
from phyx_tpu.world import World as JaxWorld
from phyx_tpu_torch import SceneBuilder, scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.step import rollout, step
from phyx_tpu_torch.world import World

torch.set_num_threads(1)

PILE = dict(max_bodies=64, max_pairs=256, broadphase="sap_grid",
            sap_window=32, solver_backend="pallas")
ORACLE = dict(max_bodies=32, max_pairs=128, broadphase="n2",
              solver_backend="pallas")
JOINTED = dict(max_bodies=32, max_pairs=128, max_joints=16,
               broadphase="sap_grid", sap_window=16, solver_backend="pallas")
# tests/test_joints.py's oracle configuration
JOINT_ORACLE = dict(max_bodies=64, max_pairs=256, max_joints=32,
                    broadphase="n2", solver_backend="pallas")


def leaves(state):
    out = {}
    for rec in ("bodies", "joints", "cache", "stats"):
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            out[f"{rec}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def hold_steps_to_jax(jcfg, cfg, seed=None, scene=None, before=0,
                      min_contacts=100):
    """Ten frames of a 60-box pile (or of ``scene(scenes module, cfg)``
    after ``before`` JAX frames), the port's input re-synced from the JAX
    state every frame: integers (pairs, cache keys, feature ids, counts,
    overflow counters, joint slots) exact, floats within 1e-4."""
    if scene is None:
        jst = jscenes.pile(jcfg, 60, seed=seed).build()
    else:
        jst = scene(jscenes, jcfg).build()
    for _ in range(before):
        jst = jax_step(jst, jcfg)
    contacts = []
    for frame in range(10):
        ours = step(state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jst), "cpu"), cfg)
        jst = jax_step(jst, jcfg)
        ref = leaves(jax.tree_util.tree_map(np.asarray, jst))
        got = leaves(state_to_numpy(ours))
        for k, a in ref.items():
            b = got[k]
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, f"frame {frame} {k}")
            else:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                           err_msg=f"frame {frame} {k}")
        contacts.append(int(ref["stats.num_contacts"]))
    assert max(contacts) >= min_contacts


def test_step_matches_jax_step():
    hold_steps_to_jax(JaxConfig(**PILE), SimConfig(**PILE), seed=1)


@pytest.mark.parametrize("tols,seed", [
    # rl_preset's velocity gate plus the displacement gate it documents
    (dict(position_rel_tol=1e-2), 1),
    # a frame (6) where the reference's gate scale, which masks the
    # compacted warm impulses with the original-order `valid`, flips a gate
    # decision against the frame's true max (ROADMAP queue 3)
    (dict(velocity_rel_tol=0.2, position_rel_tol=0.2), 0),
], ids=["rl_preset", "scale_flip"])
def test_gated_step_matches_jax_step(tols, seed):
    hold_steps_to_jax(JaxConfig.rl_preset(**PILE, **tols),
                      SimConfig.rl_preset(**PILE, **tols), seed)


def test_matches_oracle_two_boxes():
    cfg = SimConfig(**ORACLE)
    builders = (SceneBuilder(cfg), JaxSceneBuilder(JaxConfig(**ORACLE)))
    for sb in builders:
        sb.add_box((0.0, -10.0), (100.0, 10.0), static=True, friction=0.5)
        sb.add_box((0.0, 1.2), (0.5, 0.5), friction=0.5, velocity=(2.0, 0.0))
    st = builders[0].build("cpu")
    ow = builders[1].to_oracle()
    for frame in range(60):
        st = step(st, cfg)
        ow.step()
        np.testing.assert_allclose(st.bodies.pos[1].numpy(),
                                   np.asarray(ow.pos[1]), atol=2e-3,
                                   err_msg=f"frame {frame}")


def test_matches_oracle_stack():
    cfg = SimConfig(**ORACLE)
    st = scenes.stack(cfg, 4).build("cpu")
    ow = jscenes.stack(JaxConfig(**ORACLE), 4).to_oracle()
    for _ in range(80):
        st = step(st, cfg)
        ow.step()
    np.testing.assert_allclose(st.bodies.pos[1:5].numpy(),
                               np.asarray(ow.pos)[1:5], atol=5e-3)


def test_rollout_equals_steps():
    cfg = SimConfig(**PILE)
    st0 = scenes.pile(cfg, 30, seed=2).build("cpu")
    by_steps = st0
    for _ in range(4):
        by_steps = step(by_steps, cfg)
    a = leaves(state_to_numpy(rollout(st0, cfg, 4)))
    b = leaves(state_to_numpy(by_steps))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_joints_raise():
    """A builder past ``max_joints`` raises."""
    with pytest.raises(ValueError, match="max_joints"):
        scenes.chain(SimConfig(**dict(JOINTED, max_joints=3)), 4)


def test_world_default_config_matches_jax_world():
    """``World`` on a default ``SimConfig()`` (the colored solve,
    ``broadphase="sap"``): three frames of a 40-box pile against the
    reference's ``World``, positions within 1e-4, stats' integers equal."""
    cfg, jcfg = SimConfig(), JaxConfig()
    st = scenes.pile(cfg, 40, seed=5).build("cpu")
    ours = World(cfg, st)
    ref = JaxWorld(jcfg, jscenes.pile(jcfg, 40, seed=5).build())
    ours.step(3)
    ref.step(3)
    np.testing.assert_allclose(ours.positions(41), ref.positions(41),
                               atol=1e-4, rtol=0)
    got, want = ours.stats(), ref.stats()
    assert got.keys() == want.keys() and want["num_contacts"] > 20
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-4, k
    empty = World(cfg, device="cpu").step()
    assert empty.stats()["num_pairs"] == 0
    assert empty.state.bodies.pos.device.type == "cpu"


@pytest.mark.parametrize("scene,before,min_contacts", [
    pytest.param(lambda m, cfg: m.chain(cfg, 8), 0, 0, id="chain"),
    # boxes resting on the planks: revolute rows and contacts together
    pytest.param(lambda m, cfg: m.bridge(cfg, 8, load_boxes=3), 50, 2,
                 id="loaded_bridge"),
    pytest.param(lambda m, cfg: m.net(cfg, 6), 0, 0, id="net"),
])
def test_jointed_step_matches_jax_step(scene, before, min_contacts):
    hold_steps_to_jax(JaxConfig(**JOINTED), SimConfig(**JOINTED),
                      scene=scene, before=before, min_contacts=min_contacts)


def test_gated_jointed_step_matches_jax_step():
    """Gates on a chain, which has no contacts: the relative gates' impulse
    scale is the joints' warm impulses alone, and the thresholds stop
    passes within the frame."""
    kw = dict(JOINTED, velocity_rel_tol=0.05, position_rel_tol=0.05)
    hold_steps_to_jax(JaxConfig(**kw), SimConfig(**kw),
                      scene=lambda m, cfg: m.chain(cfg, 8), before=5,
                      min_contacts=0)


@pytest.mark.parametrize("scene,count", [("chain", 5), ("net", 6)])
def test_jointed_scene_matches_oracle(scene, count):
    """60 frames against the f64 oracle at tests/test_joints.py's
    tolerance, and the scene moves."""
    cfg = SimConfig(**JOINT_ORACLE)
    st = getattr(scenes, scene)(cfg, count).build("cpu")
    ow = getattr(jscenes, scene)(JaxConfig(**JOINT_ORACLE), count).to_oracle()
    for _ in range(60):
        st = step(st, cfg)
        ow.step()
    k = count + 3 if scene == "net" else count + 2
    np.testing.assert_allclose(st.bodies.pos[:k].numpy(),
                               np.asarray(ow.pos)[:k], atol=2e-3)
    assert float(st.bodies.vel[1:k].abs().max()) > 1e-3
