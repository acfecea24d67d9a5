"""The port's configuration, scene builders and state conversion against the
JAX package (CPU)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "phyx_tpu_torch"
RECORDS = ("bodies", "joints", "cache", "stats")


def leaves(state):
    """{record.field: numpy array} of a State with numpy or tensor leaves."""
    out = {}
    for rec in RECORDS:
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            out[f"{rec}.{f.name}"] = (v.numpy() if torch.is_tensor(v)
                                      else np.asarray(v))
    return out


def assert_bit_identical(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, (k, la[k].dtype, lb[k].dtype)
        assert la[k].shape == lb[k].shape, (k, la[k].shape, lb[k].shape)
        assert la[k].tobytes() == lb[k].tobytes(), k


def test_config_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == ref
    assert dataclasses.asdict(SimConfig.rl_preset(max_bodies=64)) == \
        dataclasses.asdict(JaxConfig.rl_preset(max_bodies=64))
    assert SimConfig(max_pairs=10000).max_contacts == 20000
    with pytest.raises(ValueError):
        SimConfig(broadphase="bogus")
    with pytest.raises(ValueError):
        SimConfig(tile_stride=100)


@pytest.mark.parametrize("seed,boxes", [(0, 50), (3, 120), (7, 200)])
def test_pile_builds_bit_identical(seed, boxes):
    kw = dict(max_bodies=256, max_pairs=512)
    ref = jscenes.pile(JaxConfig(**kw), boxes, seed=seed).build()
    ours = scenes.pile(SimConfig(**kw), boxes, seed=seed).build("cpu")
    assert_bit_identical(jax.tree_util.tree_map(np.asarray, ref), ours)


def test_stack_builds_bit_identical():
    kw = dict(max_bodies=16, max_pairs=64)
    ref = jscenes.stack(JaxConfig(**kw), 5).build()
    ours = scenes.stack(SimConfig(**kw), 5).build("cpu")
    assert_bit_identical(jax.tree_util.tree_map(np.asarray, ref), ours)


def test_convert_round_trips():
    ref = jax.tree_util.tree_map(
        np.asarray, jscenes.pile(JaxConfig(max_bodies=64, max_pairs=128),
                                 40, seed=5).build())
    ours = state_from_numpy(ref, "cpu")
    assert ours.bodies.pos.dtype == torch.float32
    assert ours.bodies.active.dtype == torch.bool
    assert ours.cache.pi.dtype == torch.int32
    assert_bit_identical(ref, ours)
    assert_bit_identical(ref, state_to_numpy(ours))
    assert_bit_identical(ours, state_from_numpy(state_to_numpy(ours), "cpu"))


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import phyx_tpu_torch, phyx_tpu_torch.step, "
            "phyx_tpu_torch.convert, phyx_tpu_torch.scenes, "
            "phyx_tpu_torch.coloring, phyx_tpu_torch.world, "
            "phyx_tpu_torch.oracle, phyx_tpu_torch.checkpoint, "
            "phyx_tpu_torch.metrics, phyx_tpu_torch.debug, "
            "phyx_tpu_torch.profiling, phyx_tpu_torch.demos.run_scene, "
            "phyx_tpu_torch.demos.run_envs, phyx_tpu_torch.parallel, "
            "phyx_tpu_torch.parallel.spatial, phyx_tpu_torch.bench\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'phyx_tpu' "
            "or m.startswith('phyx_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PORT.parent)


def test_no_module_imports_jax():
    for path in PORT.rglob("*.py"):
        if "_build" in path.relative_to(PORT).parts:   # build output
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "phyx_tpu"), \
                    f"{path.name} imports {name}"
