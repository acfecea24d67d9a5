"""The reference against the program on the CPU (the kernels' plain
versions) at small sizes, and its control: the reference computed in
bfloat16, put in the program's place, must fail the comparison.  On the
chip the same comparison runs at the cells' sizes (PERF.md)."""

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
         ("tiny_avalanche", 30, 10)]


@pytest.mark.parametrize("name,settle,frames", CASES)
def test_reference_agrees_with_the_program(name, settle, frames):
    config, world, bodies, st_in, st_out = frames_of(name, 11, settle, frames)
    assert world.tiled == (name == "tiny_avalanche")
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
