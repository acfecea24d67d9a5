"""The port's narrowphase and contact cache against the JAX package and the
f64 oracle: ``valid``/``fid`` and cache keys exact, floats within 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.broadphase import broadphase as jax_broadphase
from phyx_tpu.cache import build_cache as jax_build_cache
from phyx_tpu.cache import warm_start_from_cache as jax_warm_start
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.narrowphase import narrowphase_with_props as jax_narrowphase
from phyx_tpu.oracle.engine import collide_box_box_np
from phyx_tpu_torch.broadphase import EMPTY, Pairs, broadphase
from phyx_tpu_torch.cache import build_cache, lex_join, warm_start_from_cache
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.narrowphase import narrowphase_with_props
from phyx_tpu_torch.types import Bodies

torch.set_num_threads(1)

KW = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
          sap_window=32)
FLOATS = ("normal", "r1", "r2", "penetration")


def pile_state(seed, boxes=200, noise=0.06):
    """Numpy State tree of a pile with numpy-made rotations and position
    noise: overlapping, touching and separated boxes."""
    st = jax.tree_util.tree_map(
        np.asarray, jscenes.pile(JaxConfig(**KW), boxes, seed=seed).build())
    rng = np.random.default_rng(2000 + seed)
    b = st.bodies
    pos = b.pos.copy()
    pos[1:boxes + 1] += rng.normal(0.0, noise, (boxes, 2)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, boxes).astype(np.float32)
    rot = b.rot.copy()
    rot[1:boxes + 1] = np.stack([np.cos(ang), np.sin(ang)], -1)
    return st.replace(bodies=b.replace(pos=pos, rot=rot))


@functools.lru_cache(maxsize=None)
def _jax_contacts_fn():
    cfg = JaxConfig(**KW)

    def fn(bodies):
        pairs = jax_broadphase(bodies, cfg)
        contacts, props = jax_narrowphase(bodies, pairs, cfg)
        return pairs, contacts, props
    return jax.jit(fn)


def both(st):
    ref = _jax_contacts_fn()(jax.tree_util.tree_map(jnp.asarray, st.bodies))
    bodies = state_from_numpy(st, "cpu").bodies
    pairs = broadphase(bodies, SimConfig(**KW))
    contacts, props = narrowphase_with_props(bodies, pairs, SimConfig(**KW))
    return ref, (pairs, contacts, props)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_narrowphase_matches_jax(seed):
    (_, rc, rprops), (_, oc, oprops) = both(pile_state(seed))
    for name in ("valid", "fid", "b1", "b2"):
        np.testing.assert_array_equal(np.asarray(getattr(rc, name)),
                                      getattr(oc, name).numpy(), name)
    assert int(oc.valid.sum()) > 150
    for name in FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(rc, name)),
                                   getattr(oc, name).numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
    for a, b in zip(rprops, oprops):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_warm_start_and_cache_match_jax(seed):
    """Frame 1 builds a cache from random accumulators; frame 2 (bodies
    moved) warm-starts from it.  Everything integer or copied is exact."""
    st1 = pile_state(seed)
    (rp1, rc1, _), (op1, oc1, _) = both(st1)
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0.0, 2.0, (2, rc1.valid.shape[0])).astype(np.float32)
    rcache = jax_build_cache(rc1, rp1, jnp.asarray(acc[0]),
                             jnp.asarray(acc[1]))
    ocache = build_cache(oc1, op1, torch.from_numpy(acc[0]),
                         torch.from_numpy(acc[1]))
    for name in ("pi", "pj", "fid", "normal_impulse", "friction_impulse"):
        np.testing.assert_array_equal(np.asarray(getattr(rcache, name)),
                                      getattr(ocache, name).numpy(), name)

    st2 = st1.replace(bodies=st1.bodies.replace(
        pos=st1.bodies.pos + rng.normal(0.0, 0.01, st1.bodies.pos.shape
                                        ).astype(np.float32)))
    (rp2, rc2, _), (op2, oc2, _) = both(st2)
    rw = jax_warm_start(rc2, rp2, rcache, n_cap=KW["max_bodies"])
    ow = warm_start_from_cache(oc2, op2, ocache)
    np.testing.assert_array_equal(np.asarray(rc2.valid), oc2.valid.numpy())
    np.testing.assert_array_equal(np.asarray(rc2.fid), oc2.fid.numpy())
    for name in ("warm_n", "warm_t"):
        np.testing.assert_array_equal(np.asarray(getattr(rw, name)),
                                      getattr(ow, name).numpy(), name)
    assert int((ow.warm_n > 0).sum()) > 50        # the join really hit


def test_lex_join_unsorted_table_and_empty_keys():
    ka = torch.tensor([5, 1, EMPTY, 3, 1], dtype=torch.int32)
    kb = torch.tensor([9, 4, EMPTY, 7, 2], dtype=torch.int32)
    qa = torch.tensor([1, 3, EMPTY, 1, 6], dtype=torch.int32)
    qb = torch.tensor([2, 7, EMPTY, 9, 0], dtype=torch.int32)
    idx, hit = lex_join(ka, kb, qa, qb)
    assert hit.tolist() == [True, True, False, False, False]
    assert idx.tolist() == [4, 3, 0, 0, 0]


def _one_pair(pa, aa, ha, pb, ab, hb):
    n = 2
    b = Bodies.zeros(n, "cpu")
    ang = torch.tensor([aa, ab], dtype=torch.float32)
    b = b.replace(pos=torch.tensor([pa, pb], dtype=torch.float32),
                  rot=torch.stack([torch.cos(ang), torch.sin(ang)], -1),
                  half_extent=torch.tensor([ha, hb], dtype=torch.float32),
                  inv_mass=torch.ones(n), inv_inertia=torch.ones(n),
                  active=torch.ones(n, dtype=torch.bool))
    i32 = dict(dtype=torch.int32)
    z = torch.zeros((), **i32)
    pi = torch.tensor([0, EMPTY, EMPTY, EMPTY], **i32)
    pj = torch.tensor([1, EMPTY, EMPTY, EMPTY], **i32)
    pairs = Pairs(pi=pi, pj=pj, valid=pi != EMPTY,
                  num=torch.ones((), **i32), overflow=z, ovf_window=z,
                  ovf_slots=z, ovf_drop=z, ovf_band=z, ovf_slab=z)
    c, _ = narrowphase_with_props(b, pairs, SimConfig(max_bodies=2,
                                                      max_pairs=4))
    return c


def _check_oracle(pa, aa, ha, pb, ab, hb, tol):
    c = _one_pair(pa, aa, ha, pb, ab, hb)
    normal_o, pts_o, pens_o, fids_o = collide_box_box_np(
        np.asarray(pa, float), np.array([np.cos(aa), np.sin(aa)]),
        np.asarray(ha, float), np.asarray(pb, float),
        np.array([np.cos(ab), np.sin(ab)]), np.asarray(hb, float))
    got = {int(c.fid[k]): (c.r1[k].numpy() + np.asarray(pa),
                           float(c.penetration[k]), c.normal[k].numpy())
           for k in range(2) if bool(c.valid[k])}
    assert len(got) == len(pts_o)
    for p_o, pen_o, f_o in zip(pts_o, pens_o, fids_o):
        assert f_o in got
        p_g, pen_g, n_g = got[f_o]
        np.testing.assert_allclose(p_g, p_o, atol=tol)
        assert abs(pen_g - pen_o) < tol
        np.testing.assert_allclose(n_g, np.asarray(normal_o), atol=tol)


ORACLE_CASES = [
    ((0, 0), 0.0, (1, 1), (0, 1.9), 0.0, (1, 1)),        # face-face
    ((0, 0), 0.0, (1, 1), (0.7, 1.8), 0.0, (1, 1)),      # shifted overlap
    ((0, 0), 0.0, (1, 1), (0.2, 1.8), 0.3, (1, 1)),      # rotated top box
    ((0, 0), 0.0, (1, 1), (1.2, 1.2), 0.78, (1, 1)),     # corner poke
    ((0, 0), 0.0, (1, 1), (0.0, 0.5), 0.1, (1, 1)),      # deep overlap
    ((0, 0), 0.0, (1, 1), (5, 5), 0.0, (1, 1)),          # separated
    ((0, 0), 0.0, (2.0, 0.1), (0.5, 0.15), 0.05, (0.5, 0.1)),  # slivers
]


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_narrowphase_matches_oracle(case):
    _check_oracle(*case, tol=2e-4)


def test_narrowphase_fuzz_vs_oracle():
    rng = np.random.default_rng(42)
    mismatches = 0
    for _ in range(200):
        pa = rng.uniform(-1, 1, 2)
        pb = pa + rng.uniform(-2.2, 2.2, 2)
        aa, ab = rng.uniform(-np.pi, np.pi, 2)
        ha = rng.uniform(0.3, 1.5, 2)
        hb = rng.uniform(0.3, 1.5, 2)
        # near-degenerate SAT ties legitimately differ between f32 and f64
        _, pts, pens, _ = collide_box_box_np(
            pa, np.array([np.cos(aa), np.sin(aa)]), ha,
            pb, np.array([np.cos(ab), np.sin(ab)]), hb)
        if pts and min(pens) < 1e-4:
            continue
        try:
            _check_oracle(tuple(pa), aa, tuple(ha), tuple(pb), ab, tuple(hb),
                          tol=5e-4)
        except AssertionError:
            mismatches += 1
    assert mismatches <= 3, f"{mismatches} fuzz mismatches"
