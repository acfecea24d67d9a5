"""The port's windowed sweep (``broadphase="sap_window"``,
``broadphase_sap``) against the JAX package's ``broadphase_sap`` and brute
force: tests/test_broadphase.py's cases, run through both packages, and the
jittered piles of tests/test_torch_broadphase.py, where buffers, ``num``
and every counter must be exactly equal."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from phyx_tpu.broadphase import broadphase_sap as jax_broadphase_sap
from phyx_tpu.broadphase import compute_aabbs as jax_compute_aabbs
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.types import Bodies as JaxBodies
from phyx_tpu_torch import broadphase as bp
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.step import solve_inputs
from phyx_tpu_torch.types import EMPTY, Bodies
from test_torch_broadphase import BASE, COUNTS, compare, jittered_pile

torch.set_num_threads(1)


def make_bodies(cap, n_real, pos, half, inv_mass, ang=None):
    """The same bodies for both packages: (JAX Bodies, port Bodies)."""
    b = JaxBodies.zeros(cap)
    ang = np.zeros(n_real, np.float32) if ang is None else ang
    rot = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    b = b.replace(
        pos=b.pos.at[:n_real].set(pos),
        rot=b.rot.at[:n_real].set(rot),
        half_extent=b.half_extent.at[:n_real].set(half),
        inv_mass=b.inv_mass.at[:n_real].set(inv_mass),
        inv_inertia=b.inv_inertia.at[:n_real].set(inv_mass),
        active=b.active.at[:n_real].set(True))
    ours = Bodies(**{f.name: torch.from_numpy(np.array(getattr(b, f.name)))
                     for f in dataclasses.fields(Bodies)})
    return b, ours


def random_bodies(n_real, cap, seed=0, spread=20.0):
    """tests/test_broadphase.py's random_bodies, for both packages."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n_real, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n_real).astype(np.float32)
    h = rng.uniform(0.3, 1.2, (n_real, 2)).astype(np.float32)
    inv_m = (rng.uniform(0, 1, n_real) > 0.2).astype(np.float32)
    return make_bodies(cap, n_real, pos, h, inv_m, ang)


def brute_pairs(jax_bodies, n_real):
    lo, hi = map(np.asarray, jax_compute_aabbs(jax_bodies))
    im = np.asarray(jax_bodies.inv_mass)
    out = set()
    for i in range(n_real):
        for j in range(i + 1, n_real):
            if (lo[i, 0] <= hi[j, 0] and lo[j, 0] <= hi[i, 0]
                    and lo[i, 1] <= hi[j, 1] and lo[j, 1] <= hi[i, 1]
                    and not (im[i] == 0.0 and im[j] == 0.0)):
                out.add((i, j))
    return out


def got_pairs(pairs):
    pi, pj = pairs.pi.numpy(), pairs.pj.numpy()
    return {(int(a), int(b)) for a, b in zip(pi, pj) if a != EMPTY}


@functools.lru_cache(maxsize=None)
def _jax_sap(cfg):
    return jax.jit(functools.partial(jax_broadphase_sap, cfg=cfg))


def sweep_both(bodies, **cfg_kw):
    """The port's ``broadphase_sap`` and the reference's on the same
    bodies: buffers, ``num`` and every counter equal.  Returns the
    port's pairs."""
    jb, ours_b = bodies
    kw = dict(cfg_kw, broadphase="sap_window")
    ref = _jax_sap(JaxConfig(**kw))(jb)
    ours = bp.broadphase(ours_b, SimConfig(**kw))
    for name in ("pi", "pj", "valid") + COUNTS:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.routing is None
    return ours


def test_sap_window_matches_brute():
    bodies = random_bodies(100, 128, seed=2, spread=40.0)
    pairs = sweep_both(bodies, max_bodies=128, max_pairs=4096, sap_window=64)
    assert got_pairs(pairs) == brute_pairs(bodies[0], 100)


def test_sap_window_overflow_flagged():
    """Crowded scene + tiny window: missed pairs are counted."""
    bodies = random_bodies(80, 128, seed=3, spread=3.0)
    small = sweep_both(bodies, max_bodies=128, max_pairs=4096, sap_window=2)
    big = sweep_both(bodies, max_bodies=128, max_pairs=4096, sap_window=100)
    missed = len(got_pairs(big)) - len(got_pairs(small))
    assert missed > 0 and int(small.ovf_window) > 0
    assert int(small.overflow) == int(small.ovf_window)
    assert got_pairs(big) == brute_pairs(bodies[0], 80)


def test_sap_window_pairs_lex_sorted():
    pairs = sweep_both(random_bodies(100, 128, seed=4, spread=10.0),
                       max_bodies=128, max_pairs=4096, sap_window=64)
    keys = list(zip(pairs.pi.tolist(), pairs.pj.tolist()))
    assert keys == sorted(keys)
    assert int(pairs.num) == int(pairs.valid.sum()) > 0


def test_sap_window_inactive_bodies_never_pair():
    pairs = sweep_both(random_bodies(10, 64, seed=5, spread=1.0),
                       max_bodies=64, max_pairs=1024, sap_window=63)
    assert got_pairs(pairs)
    for (i, j) in got_pairs(pairs):
        assert i < 10 and j < 10


def test_sap_window_long_object_beyond_window():
    """A ground plane spanning the axis pairs with every box on it, though
    the boxes far outnumber the window (the long lane)."""
    n_boxes = 100
    xs = np.linspace(-200.0, 200.0, n_boxes).astype(np.float32)
    pos = np.concatenate([np.stack([xs, np.full(n_boxes, 0.4, np.float32)],
                                   -1), [[0.0, -10.0]]]).astype(np.float32)
    half = np.concatenate([np.full((n_boxes, 2), 0.5, np.float32),
                           [[1e4, 10.0]]]).astype(np.float32)
    inv_m = np.concatenate([np.ones(n_boxes, np.float32), [0.0]])
    bodies = make_bodies(128, n_boxes + 1, pos, half,
                         inv_m.astype(np.float32))
    pairs = got_pairs(sweep_both(bodies, max_bodies=128, max_pairs=4096,
                                 sap_window=8))
    for i in range(n_boxes):
        assert (i, n_boxes) in pairs, f"box {i} lost its ground contact"
    assert pairs == brute_pairs(bodies[0], n_boxes + 1)


def test_sap_window_many_long_objects_exact():
    """Six long bodies (sap_long_k 8) among regular ones: equal to brute
    force, long-long pairs included."""
    rng = np.random.default_rng(7)
    n_real = 40
    pos = rng.uniform(-30, 30, (n_real, 2)).astype(np.float32)
    h = rng.uniform(0.3, 1.0, (n_real, 2)).astype(np.float32)
    h[:6, 0] = rng.uniform(50.0, 90.0, 6)
    bodies = make_bodies(64, n_real, pos, h, np.ones(n_real, np.float32))
    pairs = sweep_both(bodies, max_bodies=64, max_pairs=4096, sap_window=48,
                       sap_long_k=8)
    assert got_pairs(pairs) == brute_pairs(bodies[0], n_real)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hits", [2, 8])
def test_jittered_pile_matches_jax(hits, seed):
    """The jittered piles through ``broadphase`` in both packages: pairs,
    ``num`` and every counter equal.  The window sweep has no hit slots,
    so ``sap_hits`` 2 changes nothing: the grid at 2 hits spills."""
    counts = compare(dict(BASE, broadphase="sap_window", sap_hits=hits,
                          solver_backend="xla"), 200, seed)
    assert counts["overflow"] == 0 and counts["num"] > 600
    if seed == 0:
        # the reference's count on this pile (ROADMAP queue 3)
        assert counts["num"] == 745
        grid = compare(dict(BASE, broadphase="sap_grid", sap_hits=hits,
                            solver_backend="xla"), 200, seed)
        assert (grid["ovf_slots"] > 0) == (hits == 2)


@pytest.mark.parametrize("budget,counter", [
    (dict(sap_window=3), "ovf_window"),
    (dict(max_pairs=64), "ovf_drop"),
])
def test_jittered_pile_overflow_exact(budget, counter):
    counts = compare(dict(BASE, broadphase="sap_window", **budget), 200, 1)
    assert counts[counter] > 0
    assert counts["overflow"] == counts[counter]


def test_tiled_backend_takes_the_routed_solve():
    """Under ``pallas_tiled`` the windowed sweep emits no slab-major
    routing, so the step's solve is K5's (the routed rows), as the
    reference's step takes its ``solve_pallas_tiled``."""
    kw = dict(BASE, broadphase="sap_window", solver_backend="pallas_tiled",
              tile_stride=256, tile_halo=256)
    st = state_from_numpy(jittered_pile(kw, 200, 0), "cpu")
    cfg = SimConfig(**kw)
    assert bp.broadphase(st.bodies, cfg).routing is None
    args = solve_inputs(st, cfg)
    assert "slab_counts" in args and "cum" not in args
