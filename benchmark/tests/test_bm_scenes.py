"""benchmark/scenes/ gives, bit for bit, the boxes of the port's
``scenes.pile`` and ``scenes.avalanche`` for three seeds at small sizes,
and the harness builds the same state from them."""

import numpy as np
import pytest
import torch

from benchmark import check, run, scenes
from phyx_tpu_torch import SimConfig
from phyx_tpu_torch import scenes as port_scenes

SEEDS = (0, 7, 3_000_000_019)


def rows_of(sb):
    return {k: np.asarray([r[k] for r in sb._rows]) for k in sb._rows[0]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind,boxes", [("pile", 37), ("avalanche", 53)])
def test_scene_equals_the_ports(kind, boxes, seed):
    cfg = SimConfig(max_bodies=128, max_pairs=1024)
    port = rows_of(getattr(port_scenes, kind)(cfg, boxes, seed=seed))
    ours = scenes.make({"scene": {"kind": kind}, "boxes": boxes}, seed)
    inv_m, inv_i = ours.inverse_masses()
    np.testing.assert_array_equal(port["pos"], ours.pos)
    np.testing.assert_array_equal(port["h"], ours.half)
    np.testing.assert_array_equal(port["angle"], ours.angle)
    np.testing.assert_array_equal(port["friction"], ours.friction)
    np.testing.assert_array_equal(port["restitution"], ours.restitution)
    np.testing.assert_array_equal(port["inv_m"], inv_m)
    np.testing.assert_array_equal(port["inv_i"], inv_i)


@pytest.mark.parametrize("kind", ["pile", "avalanche"])
def test_harness_build_equals_the_ports(kind):
    config = dict(scene={"kind": kind}, boxes=30, max_bodies=64,
                  max_pairs=1024, broadphase="sap_grid", sap_window=32,
                  sap_hits=8, num_colors=24, solver_backend="pallas",
                  tile_stride=16384, tile_halo=2048, dt=1 / 60,
                  gravity=[0.0, -10.0], velocity_iterations=10,
                  position_iterations=6, slop=0.01, contact_beta=0.2,
                  max_displacement_velocity=0.2, restitution_threshold=1.0)
    scene = scenes.make(config, 5)
    cfg, st = run.build(config, scene, "cpu")
    port = getattr(port_scenes, kind)(cfg, 30, seed=5).build("cpu")
    for f in ("pos", "rot", "vel", "inv_mass", "inv_inertia", "half_extent",
              "friction", "restitution", "active"):
        assert torch.equal(getattr(st.bodies, f), getattr(port.bodies, f)), f
    built = {k: getattr(st.bodies, k).numpy() for k in
             ("pos", "rot", "inv_mass", "inv_inertia", "friction",
              "restitution", "active")}
    built["half"] = st.bodies.half_extent.numpy()
    assert check.build_gap(built, check.bodies_of(scene, 64)) == 0.0
