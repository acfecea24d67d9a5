"""The reference against the program on the CPU (the kernels' plain
versions) at small sizes, and its control: the reference computed in
bfloat16, put in the program's place, must fail the comparison.  On the
chip the same comparison runs at the cells' sizes (PERF.md)."""

import dataclasses
import json

import numpy as np
import pytest

from benchmark import check, run, scenes
from benchmark.reference import engine
from benchmark.tests.cells import REPO, TINY


def config_of(name, **more):
    base, changes = TINY[name]
    cfg = json.loads((REPO / f"benchmark/configs/{base}.json").read_text())
    cfg.update(changes, **more)
    return cfg


def frames_of(name, seed, settle, frames, **more):
    """(config, world, bodies, program input state, output after
    ``frames`` frames), the program on the CPU."""
    from phyx_tpu_torch.step import step
    config = config_of(name, **more)
    scene = scenes.make(config, seed)
    cfg, st = run.build(config, scene, "cpu")
    for _ in range(settle):
        st = step(st, cfg)
    out = st
    for _ in range(frames):
        out = step(out, cfg)
    bodies = check.bodies_of(scene, cfg.max_bodies)
    world = engine.world_from(bodies, config)
    return config, world, bodies, run.host_state(st), run.host_state(out)


CASES = [("tiny_pile", 40, 1), ("tiny_avalanche", 30, 1),
         ("tiny_avalanche", 30, 10), ("tiny_envs", 10, 1)]


@pytest.mark.parametrize("name,settle,frames", CASES)
def test_reference_agrees_with_the_program(name, settle, frames):
    config, world, bodies, st_in, st_out = frames_of(name, 11, settle, frames)
    assert world.tiled == (name != "tiny_pile")
    numbers = check.judge(world, bodies, [(st_in, st_out, None)], frames)
    ok, lines = check.verdict(dict(numbers, build_gap=0.0),
                              config["limits"])
    assert ok, lines
    assert numbers["pair_gap"] == numbers["point_gap"] == 0


@pytest.mark.parametrize("name,settle,frames", CASES)
def test_control_in_bfloat16_fails(name, settle, frames):
    config, world, bodies, st_in, _ = frames_of(name, 11, settle, 0)
    numbers = check.judge(world, bodies, [(st_in, None, None)], frames,
                          control=True)
    ok, lines = check.verdict(dict(numbers, build_gap=0.0),
                              config["limits"])
    assert not ok, lines


def test_tiled_order_matters():
    """On the tiled tier the walk's order is the slab-major one: the pair
    order walked instead reads a wider gap than the program's own (262
    bodies over three slabs of 128)."""
    config, world, bodies, st_in, st_out = frames_of(
        "tiny_avalanche", 11, 30, 1, boxes=260, max_bodies=512,
        max_pairs=1536)
    movable = bodies["active"] & (bodies["inv_mass"] > 0)
    right = check.compare(st_out, engine.frame(world, st_in), movable)
    world.tiled = False
    wrong = check.compare(st_out, engine.frame(world, st_in), movable)
    assert wrong["vel_gap"] > 10 * right["vel_gap"]
    assert np.isfinite(right["vel_gap"])


def port_bodies(n, cap, seed, drop):
    """A port state of ``n`` boxes at random poses (capacity ``cap``),
    spread over four bands of height 10 from y = -5, some boxes across a
    band boundary, and ``drop`` of them made inactive."""
    import torch
    from phyx_tpu_torch import SceneBuilder, SimConfig
    rng = np.random.default_rng(seed)
    sb = SceneBuilder(SimConfig(max_bodies=cap, max_pairs=1024))
    for k in range(n):
        y = rng.uniform(-5.0, 35.0)
        if k % 7 == 0:
            # centred on a boundary: its AABB crosses it
            y = -5.0 + 10.0 * rng.integers(1, 4)
        sb.add_box((float(rng.uniform(-40.0, 40.0)), float(y)),
                   (float(rng.uniform(0.2, 2.0)), float(rng.uniform(0.2, 2.0))),
                   angle=float(rng.uniform(-3.0, 3.0)))
    st = sb.build("cpu")
    st.bodies.active[torch.as_tensor(rng.choice(n, drop, replace=False))] = \
        False
    return st.bodies


BANDS = dict(sweep_band_h=10.0, sweep_band_y0=-5.0, sweep_band_span=128.0)
# R = 25 rows an env, B = 4 bands, X = 8 cells: 800 rows of the 1,024
LAYOUT = dict(BANDS, sweep_band_rows=25, sweep_band_n=4, sweep_band_cols=8)


@pytest.mark.parametrize("seed", [0, 1, 3_000_000_019])
@pytest.mark.parametrize("bands", [BANDS, LAYOUT], ids=["flat", "segmented"])
def test_banded_rank_equals_the_ports(bands, seed):
    """The reference's tiled-tier ranks (banded keys, flat or per band)
    equal the port's ``broadphase.rank_order`` to the bit: 900 boxes at
    random poses, a seventh across a band boundary, 40 inactive."""
    from phyx_tpu_torch import SimConfig
    from phyx_tpu_torch import broadphase as bp
    b = port_bodies(900, 1024, seed, 40)
    cfg = SimConfig(max_bodies=1024, max_pairs=1024, **bands)
    lo, hi = bp.compute_aabbs(b)
    want = bp.rank_order(b, lo, hi, cfg).numpy()
    world = engine.world_from(
        dict(inv_mass=b.inv_mass.numpy(), inv_inertia=b.inv_inertia.numpy(),
             half=b.half_extent.numpy(), friction=b.friction.numpy(),
             restitution=b.restitution.numpy(), active=b.active.numpy()),
        dict(json.loads((REPO / "benchmark/configs/pile_10k.json")
                        .read_text()), max_bodies=1024, max_pairs=1024,
             **bands))
    ref_lo, _ = engine.aabbs(b.pos.numpy(), b.rot.numpy(),
                             b.half_extent.numpy())
    np.testing.assert_array_equal(ref_lo, lo.numpy())
    crossers = world.active & (
        np.floor((ref_lo[:, 1] + 5.0) / 10.0)
        != np.floor((hi[:, 1].numpy() + 5.0) / 10.0))
    assert crossers.sum() >= 50
    np.testing.assert_array_equal(engine.rank_order(world, ref_lo), want)
    flat = engine.rank_order(
        dataclasses.replace(world, band_h=0.0, band_rows=0), ref_lo)
    assert not np.array_equal(flat, want)


def test_world_band_defaults_are_the_programs():
    from phyx_tpu_torch import SimConfig
    cfg = SimConfig()
    for key, value in engine.BAND_KEYS.items():
        assert getattr(cfg, key) == value, key


@pytest.mark.parametrize("seed", range(4))
def test_broadphase_equals_brute_force(seed):
    """Every overlapping pair of active bodies, one dynamic, each once:
    up to 300 boxes, up to 40 of them long (grounds over the others)."""
    rng = np.random.default_rng(seed)
    n = 300
    pos = rng.uniform(-60.0, 60.0, (n, 2)).astype(np.float32)
    half = rng.uniform(0.2, 1.5, (n, 2)).astype(np.float32)
    long_ids = rng.choice(n, 10 * (seed + 1), replace=False)
    half[long_ids, 0] = rng.uniform(20.0, 90.0, long_ids.size)
    angle = rng.uniform(-3.0, 3.0, n)
    rot = np.stack([np.cos(angle), np.sin(angle)], 1).astype(np.float32)
    rot[long_ids] = (1.0, 0.0)
    inv_mass = np.where(rng.uniform(size=n) < 0.3, 0.0, 1.0).astype(
        np.float32)
    active = rng.uniform(size=n) < 0.9
    world = engine.world_from(
        dict(inv_mass=inv_mass, inv_inertia=inv_mass, half=half,
             friction=inv_mass, restitution=inv_mass, active=active),
        dict(json.loads((REPO / "benchmark/configs/pile_10k.json")
                        .read_text()), max_bodies=n))
    lo, hi = engine.aabbs(pos, rot, half)
    i, j = np.triu_indices(n, 1)
    hit = (active[i] & active[j] & ((inv_mass[i] > 0) | (inv_mass[j] > 0))
           & (lo[j, 0] <= hi[i, 0]) & (lo[i, 0] <= hi[j, 0])
           & (lo[j, 1] <= hi[i, 1]) & (lo[i, 1] <= hi[j, 1]))
    want = np.stack([i[hit], j[hit]], 1)
    np.testing.assert_array_equal(engine.broadphase(world, lo, hi), want)
