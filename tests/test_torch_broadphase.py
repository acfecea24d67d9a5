"""The port's broadphases against the JAX package on identical bodies:
pair buffers, counts and every overflow counter must be exactly equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.broadphase import broadphase as jax_broadphase
from phyx_tpu.broadphase import lex_sort_pairs as jax_lex_sort_pairs
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.step import step as jax_step
from phyx_tpu_torch.broadphase import EMPTY, broadphase, lex_sort_pairs
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.step import step
from test_torch_step import leaves

torch.set_num_threads(1)

COUNTS = ("num", "overflow", "ovf_window", "ovf_slots", "ovf_drop",
          "ovf_band", "ovf_slab")


def jittered_pile(cfg_kw, boxes, seed):
    """A pile from ``seed`` with numpy-made rotations and position noise
    (overlaps, touching and separated boxes, a few long bodies), as a
    numpy State tree both packages can take."""
    st = jscenes.pile(JaxConfig(**cfg_kw), boxes, seed=seed).build()
    st = jax.tree_util.tree_map(np.asarray, st)
    rng = np.random.default_rng(1000 + seed)
    b = st.bodies
    k = boxes + 1                                  # ground + boxes
    pos = b.pos.copy()
    pos[1:k] += rng.normal(0.0, 0.06, (boxes, 2)).astype(np.float32)
    ang = rng.uniform(-0.6, 0.6, boxes).astype(np.float32)
    rot = b.rot.copy()
    rot[1:k] = np.stack([np.cos(ang), np.sin(ang)], -1)
    half = b.half_extent.copy()
    wide = rng.choice(boxes, 4, replace=False) + 1  # a few long boxes
    half[wide, 0] = rng.uniform(2.0, 6.0, 4).astype(np.float32)
    static = rng.choice(boxes, 6, replace=False) + 1
    inv_mass = b.inv_mass.copy()
    inv_mass[static] = 0.0
    bodies = b.replace(pos=pos, rot=rot, half_extent=half,
                       inv_mass=inv_mass)
    return st.replace(bodies=bodies)


@functools.lru_cache(maxsize=None)
def _jax_bp(cfg):
    return jax.jit(functools.partial(jax_broadphase, cfg=cfg))


def compare(cfg_kw, boxes, seed):
    st = jittered_pile(cfg_kw, boxes, seed)
    ref = _jax_bp(JaxConfig(**cfg_kw))(
        jax.tree_util.tree_map(jnp.asarray, st.bodies))
    ours = broadphase(state_from_numpy(st, "cpu").bodies,
                      SimConfig(**cfg_kw))
    for name in ("pi", "pj", "valid") + COUNTS:
        a = np.asarray(getattr(ref, name))
        b = getattr(ours, name).numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    return {name: int(getattr(ours, name)) for name in COUNTS}


BASE = dict(max_bodies=256, max_pairs=1024, sap_window=32, sap_hits=8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("broadphase_name", ["sap_grid", "n2"])
def test_pairs_exact(broadphase_name, seed):
    counts = compare(dict(BASE, broadphase=broadphase_name), 200, seed)
    assert counts["num"] > 100
    assert counts["overflow"] == 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("budget,counter", [
    (dict(sap_window=3), "ovf_window"),
    (dict(sap_hits=1), "ovf_slots"),
    (dict(max_pairs=64), "ovf_drop"),
])
def test_grid_overflow_exact(budget, counter, seed):
    counts = compare(dict(BASE, broadphase="sap_grid", **budget), 200, seed)
    assert counts[counter] > 0


def test_n2_drop_keeps_lowest_pairs():
    counts = compare(dict(BASE, broadphase="n2", max_pairs=48), 120, 4)
    assert counts["ovf_drop"] > 0 and counts["num"] == 48


def test_unported_paths_raise():
    """The sweep-emission configs (K7 at this capacity): their broadphase
    equals the reference's under every backend, and ``sap_kernel`` under
    ``xla`` (the colored solve), which raised before the colored solve was
    ported, steps as the reference does: integers exact, floats within
    1e-4."""
    for name, backend in (("sap_kernel", "xla"), ("sap_kernel", "pallas"),
                          ("sap", "pallas")):
        cfg_kw = dict(BASE, broadphase=name, solver_backend=backend)
        counts = compare(cfg_kw, 200, 0)
        assert counts["num"] > 100 and counts["overflow"] == 0
    cfg_kw = dict(cfg_kw, solver_backend="xla")
    tree = jittered_pile(cfg_kw, 200, 0)
    ours = leaves(state_to_numpy(step(state_from_numpy(tree, "cpu"),
                                      SimConfig(**cfg_kw))))
    ref = leaves(jax.tree_util.tree_map(np.asarray, jax_step(
        jax.tree_util.tree_map(jnp.asarray, tree), JaxConfig(**cfg_kw))))
    assert ref["stats.num_contacts"] > 100
    for k, a in ref.items():
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, ours[k], k)
        else:
            np.testing.assert_allclose(a, ours[k], atol=1e-4, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("n_cap", [256, 1 << 16])
def test_lex_sort_pairs_matches_jax(n_cap):
    """Both the reference's packed key (256) and its two-key fallback
    (2^16 bodies) against the port's one int64 key."""
    rng = np.random.default_rng(n_cap)
    a = rng.integers(0, n_cap - 1, 300).astype(np.int32)
    b = rng.integers(0, n_cap - 1, 300).astype(np.int32)
    pi, pj = np.minimum(a, b), np.maximum(a, b) + 1
    empty = rng.random(300) < 0.3
    pi[empty] = EMPTY
    pj[empty] = EMPTY
    ref = jax_lex_sort_pairs(jnp.asarray(pi), jnp.asarray(pj), n_cap)
    ours = lex_sort_pairs(torch.from_numpy(pi), torch.from_numpy(pj))
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
