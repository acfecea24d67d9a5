"""The port's stacked batches (``phyx_tpu_torch/parallel/envs.py``:
``make_env_batch``, ``sharded_env_step``, ``concat_envs_grouped``,
``sharded_mega_step``) against its own single-env and single-group steps,
to the bit, and against the JAX package's ``vmap`` and ``shard_map`` forms
on the virtual CPU devices of conftest, re-synced every frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.parallel import envs as jenvs
from phyx_tpu.step import step as jax_step
from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.parallel import make_env_batch, sharded_env_step
from phyx_tpu_torch.parallel.envs import (concat_envs, concat_envs_grouped,
                                          sharded_mega_step)
from phyx_tpu_torch.step import rollout, step
from test_torch_spatial import assert_exact, assert_resynced
from test_torch_step import leaves

torch.set_num_threads(1)

# tests/test_step.py:14
SMALL = dict(max_bodies=64, max_pairs=512, broadphase="n2")
# tests/test_mesh_sharding.py:27
N2 = dict(max_bodies=32, max_pairs=256, broadphase="n2", solver_backend="xla")
# tests/test_sharded_mega.py: 8 envs of 6 boxes in 4 groups
GROUPS, ENVS, BOXES = 4, 8, 6


def mega_kw(backend):
    return dict(max_bodies=64, max_pairs=256, broadphase="sap",
                sap_window=16, solver_backend=backend)


def numpy_tree(jst):
    return jax.tree_util.tree_map(np.asarray, jst)


def port_leaves(st):
    return leaves(state_to_numpy(st))


def part(batch, i):
    """Slice ``i`` of a stacked port batch, as numpy leaves."""
    return {k: v[i] for k, v in port_leaves(batch).items()}


def test_vmap_matches_single():
    """tests/test_step.py:136: stacks of 2, 3 and 4 boxes in one batch.
    10 frames (of the reference's 30, for the tests' time) of
    ``sharded_env_step`` equal each env's own ``step`` to the bit; and 10 batch frames re-synced from the JAX ``vmap`` batch are
    within 1e-4 of it, integers exact."""
    cfg, jcfg = SimConfig(**SMALL), JaxConfig(**SMALL)
    states = [scenes.stack(cfg, k).build("cpu") for k in (2, 3, 4)]
    batch = make_env_batch(states)
    vstep = sharded_env_step(cfg)
    for _ in range(10):
        batch = vstep(batch)
        states = [step(s, cfg) for s in states]
    for k, s in enumerate(states):
        assert_exact(port_leaves(s), part(batch, k))

    jbatch = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jscenes.stack(jcfg, k).build() for k in (2, 3, 4)])
    jvstep = jax.jit(jax.vmap(lambda s: jax_step(s, jcfg)))
    for frame in range(10):
        got = vstep(state_from_numpy(numpy_tree(jbatch), "cpu"))
        jbatch = jvstep(jbatch)
        assert_resynced(leaves(numpy_tree(jbatch)), port_leaves(got),
                        f"frame {frame}")
    assert int(np.asarray(jbatch.stats.num_contacts).min()) >= 2


@pytest.mark.parametrize("jointed", [False, True], ids=["piles", "chains"])
def test_uneven_envs_match_single(jointed):
    """tests/test_mesh_sharding.py:88 (8 piles of 6 boxes, one batch frame)
    and, with joint tables in the batch, 4 chains of :102 nudged apart (5
    frames): every env equal to the bit to its own steps.  The
    reference's split over devices has no counterpart: the batch shares
    one device."""
    if jointed:
        cfg, frames = SimConfig(**dict(N2, max_joints=16)), 5
        envs = []
        for e in range(4):
            st = scenes.chain(cfg, 4).build("cpu")
            envs.append(st.replace(bodies=st.bodies.replace(
                pos=st.bodies.pos + 0.01 * e)))
    else:
        cfg, frames = SimConfig(**N2), 1
        envs = [scenes.pile(cfg, 6, seed=s).build("cpu") for s in range(8)]
    batch = make_env_batch(envs)
    vstep = sharded_env_step(cfg)
    for _ in range(frames):
        batch = vstep(batch)
    for e, st in enumerate(envs):
        assert_exact(port_leaves(rollout(st, cfg, frames)), part(batch, e))


def builders(make, cfg):
    return [make.pile(cfg, BOXES, seed=s, ground_half=6.0)
            for s in range(ENVS)]


@pytest.mark.parametrize("y_bands", [1, 2])
def test_concat_envs_grouped_equals_jax(y_bands):
    """The stacked group states, env slices and offsets exactly equal to
    the reference's."""
    kw = mega_kw("pallas")
    bands = dict(band_width=30.0, y_bands=y_bands,
                 band_height=40.0 if y_bands > 1 else 0.0)
    ref = jenvs.concat_envs_grouped(builders(jscenes, JaxConfig(**kw)),
                                    JaxConfig(**kw), GROUPS, **bands)
    got = concat_envs_grouped(builders(scenes, SimConfig(**kw)),
                              SimConfig(**kw), GROUPS, device="cpu", **bands)
    assert_exact(leaves(numpy_tree(ref[0])), port_leaves(got[0]))
    assert got[0].bodies.pos.shape[0] == GROUPS
    assert got[1] == ref[1]
    for a, b in zip(ref[2], got[2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sharded_mega_bit_identical_to_per_group():
    """tests/test_sharded_mega.py:41: 10 frames of ``sharded_mega_step``
    under "pallas"; each group equal to the bit to its own mega-scene's
    ``rollout``, counters included, no overflow."""
    cfg = SimConfig(**mega_kw("pallas"))
    bs = builders(scenes, cfg)
    stacked, _, _ = concat_envs_grouped(bs, cfg, GROUPS, band_width=30.0,
                                        device="cpu")
    out = sharded_mega_step(cfg, num_steps=10)(stacked)
    per = ENVS // GROUPS
    for g in range(GROUPS):
        mega, _, _ = concat_envs(bs[g * per:(g + 1) * per], cfg,
                                 band_width=30.0)
        ref = rollout(mega.build("cpu"), cfg, 10)
        assert_exact(port_leaves(ref), part(out, g))
        assert int(ref.stats.num_contacts) > 0
        assert int(ref.stats.pair_overflow) == 0


def test_sharded_mega_resynced_to_jax():
    """tests/test_sharded_mega.py:77 ("xla"): 5 frames of the port's
    grouped step, each from the reference's stacked state, within 1e-4 of
    the reference's ``sharded_mega_step``, integers exact."""
    kw = mega_kw("xla")
    jcfg = JaxConfig(**kw)
    jst, _, _ = jenvs.concat_envs_grouped(builders(jscenes, jcfg), jcfg,
                                          GROUPS, band_width=30.0)
    mesh = Mesh(np.array(jax.devices()[:GROUPS]), axis_names=("env",))
    jfn = jenvs.sharded_mega_step(jcfg, mesh, num_steps=1)
    fn = sharded_mega_step(SimConfig(**kw))
    for frame in range(5):
        got = fn(state_from_numpy(numpy_tree(jst), "cpu"))
        jst = jfn(jst)
        assert_resynced(leaves(numpy_tree(jst)), port_leaves(got),
                        f"frame {frame}")
    assert int(np.asarray(jst.stats.num_contacts).min()) > 0


def test_grouped_builder_rejects_ragged_split():
    """tests/test_sharded_mega.py:94."""
    cfg = SimConfig(**mega_kw("xla"))
    with pytest.raises(ValueError):
        concat_envs_grouped(builders(scenes, cfg)[:7], cfg, GROUPS,
                            device="cpu")


def test_make_env_batch_device():
    """The batch lies on the device named, every leaf with the env axis."""
    cfg = SimConfig(**N2)
    envs = [scenes.pile(cfg, 6, seed=s).build("cpu") for s in range(3)]
    batch = make_env_batch(envs, device="cpu")
    for f in dataclasses.fields(batch.bodies):
        t = getattr(batch.bodies, f.name)
        assert t.device.type == "cpu" and t.shape[0] == 3
    assert batch.cache.pi.shape == (3, cfg.max_pairs)
