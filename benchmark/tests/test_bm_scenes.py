"""benchmark/scenes/ gives, bit for bit, the boxes of the port's
``scenes.pile`` and ``scenes.avalanche`` for three seeds at small sizes,
and of its env mega-scene (``demos.run_envs.envs_scene``, the envs laid
out by ``parallel.envs.concat_envs``) on one y-band and on eight; the
harness builds the same state from them."""

import numpy as np
import pytest
import torch

from benchmark import check, run, scenes
from phyx_tpu_torch import SimConfig
from phyx_tpu_torch import scenes as port_scenes
from phyx_tpu_torch.demos.run_envs import envs_layout, envs_scene
from phyx_tpu_torch.parallel.envs import concat_envs

SEEDS = (0, 7, 3_000_000_019)
# the env scenes' env counts by boxes an env: one y-band, and eight
ENVS = {5: 3, 3: 64}


def rows_of(sb):
    return {k: np.asarray([r[k] for r in sb._rows]) for k in sb._rows[0]}


def port_envs(boxes, seed):
    """``envs_scene``'s layout of ENVS[boxes] envs, env e's pile from the
    seed [seed, e]."""
    envs = ENVS[boxes]
    cfg, bands = envs_layout(envs, boxes)
    return concat_envs([port_scenes.pile(cfg, boxes, seed=[seed, e],
                                         ground_half=30.0)
                        for e in range(envs)], cfg, **bands)


def env_rows(envs, boxes):
    """The rows of each env as the kind lays them out: env by env."""
    return [range(e * (boxes + 1), (e + 1) * (boxes + 1))
            for e in range(envs)]


def port_scene(kind, boxes, seed):
    if kind == "envs":
        return port_envs(boxes, seed)[0]
    cfg = SimConfig(max_bodies=128, max_pairs=1024)
    return getattr(port_scenes, kind)(cfg, boxes, seed=seed)


def scene_entry(kind, boxes):
    return dict({"kind": kind}, **({"envs": ENVS[boxes]} if kind == "envs"
                                   else {}))


def assert_rows_equal(port, ours):
    inv_m, inv_i = ours.inverse_masses()
    np.testing.assert_array_equal(port["pos"], ours.pos)
    np.testing.assert_array_equal(port["h"], ours.half)
    np.testing.assert_array_equal(port["angle"], ours.angle)
    np.testing.assert_array_equal(port["friction"], ours.friction)
    np.testing.assert_array_equal(port["restitution"], ours.restitution)
    np.testing.assert_array_equal(port["inv_m"], inv_m)
    np.testing.assert_array_equal(port["inv_i"], inv_i)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind,boxes", [
    ("pile", 37), ("avalanche", 53),
    pytest.param("envs", 5, id="envs-3x5"),
    pytest.param("envs", 3, id="envs-64x3")])
def test_scene_equals_the_ports(kind, boxes, seed):
    port = rows_of(port_scene(kind, boxes, seed))
    ours = scenes.make({"scene": scene_entry(kind, boxes), "boxes": boxes},
                       seed)
    assert_rows_equal(port, ours)
    if kind == "envs":
        assert env_rows(ENVS[boxes], boxes) == \
            [range(s.start, s.stop) for s in port_envs(boxes, seed)[1]]


@pytest.mark.parametrize("boxes", [5, 3], ids=["1-band", "8-bands"])
def test_envs_layout_equals_envs_scene(boxes):
    """The kind's layout from the seeds 0, 1, ... is the port's
    ``envs_scene`` (env e's pile from seed e) row for row."""
    from benchmark.scenes import envs
    n = ENVS[boxes]
    _, mega, slices, _ = envs_scene(n, boxes)
    ours = envs.layout(list(range(n)), boxes)
    assert_rows_equal(rows_of(mega), ours)
    assert env_rows(n, boxes) == [range(s.start, s.stop) for s in slices]


@pytest.mark.parametrize("kind", ["pile", "avalanche", "envs"])
def test_harness_build_equals_the_ports(kind):
    boxes = 5 if kind == "envs" else 30
    config = dict(scene=scene_entry(kind, boxes), boxes=boxes,
                  max_bodies=64, max_pairs=1024, broadphase="sap_grid",
                  sap_window=32, sap_hits=8, num_colors=24,
                  solver_backend="pallas", tile_stride=16384, tile_halo=2048,
                  dt=1 / 60, gravity=[0.0, -10.0], velocity_iterations=10,
                  position_iterations=6, slop=0.01, contact_beta=0.2,
                  max_displacement_velocity=0.2, restitution_threshold=1.0)
    scene = scenes.make(config, 5)
    cfg, st = run.build(config, scene, "cpu")
    if kind == "envs":
        mega = port_envs(boxes, 5)[0]
        mega.cfg = cfg
        port = mega.build("cpu")
    else:
        port = getattr(port_scenes, kind)(cfg, 30, seed=5).build("cpu")
    for f in ("pos", "rot", "vel", "inv_mass", "inv_inertia", "half_extent",
              "friction", "restitution", "active"):
        assert torch.equal(getattr(st.bodies, f), getattr(port.bodies, f)), f
    built = {k: getattr(st.bodies, k).numpy() for k in
             ("pos", "rot", "inv_mass", "inv_inertia", "friction",
              "restitution", "active")}
    built["half"] = st.bodies.half_extent.numpy()
    assert check.build_gap(built, check.bodies_of(scene, 64)) == 0.0
