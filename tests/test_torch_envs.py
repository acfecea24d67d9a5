"""Batched envs as one mega-scene on the port: ``concat_envs``, banded and
segmented sweep keys, the banded grid, the reference's banded-sweep checks
(tests/test_banded_sweep.py) and env mega-scene steps through K4 with K3
and with K5, all against the JAX package."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phyx_tpu.broadphase as jbp
from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.parallel.envs import concat_envs as jax_concat_envs
from phyx_tpu.step import step as jax_step
import phyx_tpu_torch.broadphase as bp
from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.parallel.envs import concat_envs, env_positions
from phyx_tpu_torch.step import step

torch.set_num_threads(1)

# tests/test_banded_sweep.py's grid: 8 envs x 24 boxes, 4 y-bands 120
# apart, x cells 40 apart, keys banded over a 256-unit span
GRID = dict(max_bodies=1024, max_pairs=4096, broadphase="sap_tiled",
            sap_long_k=4, solver_backend="pallas")
BANDED = dict(sweep_band_h=120.0, sweep_band_y0=-60.0, sweep_band_span=256.0)
# R = 25 rows an env, B = 4 bands, X = 2 cells
SEGMENTED = dict(BANDED, sweep_band_rows=25, sweep_band_n=4,
                 sweep_band_cols=2)
PAIRS = ("pi", "pj", "valid", "num", "overflow", "ovf_window", "ovf_slots",
         "ovf_drop", "ovf_band", "ovf_slab")


def leaves(state):
    out = {}
    for rec in ("bodies", "joints", "cache", "stats"):
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            out[f"{rec}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def env_builders(m, cfg, n_envs=8, boxes=24, chain=False):
    """Per-env piles (seed = env), and a short chain as the last env."""
    out = [m.pile(cfg, boxes, seed=s, ground_half=8.0)
           for s in range(n_envs)]
    if chain:
        out[-1] = m.chain(cfg, 6)
    return out


def grid_state(kw, moves=None):
    """The 8-env band grid as a numpy State tree (the JAX build), with
    ``moves`` {body: (x, y)} applied."""
    jcfg = JaxConfig(**kw)
    mega, _, _ = jax_concat_envs(env_builders(jscenes, jcfg), jcfg,
                                 band_width=40.0, y_bands=4,
                                 band_height=120.0)
    st = jax.tree_util.tree_map(np.asarray, mega.build())
    pos = st.bodies.pos.copy()
    for idx, xy in (moves or {}).items():
        pos[idx] = xy
    return st.replace(bodies=st.bodies.replace(pos=pos))


def port_bodies(tree):
    return state_from_numpy(tree, "cpu").bodies


def jax_bodies(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree.bodies)


def first_dynamic(tree):
    return int(np.argmax(tree.bodies.inv_mass > 0))


@pytest.mark.parametrize("y_bands", [1, 4])
def test_concat_envs_matches_jax(y_bands):
    """The mega-scene's arrays (bodies and joints) equal the JAX build's to
    the bit; slices and offsets too."""
    kw = dict(max_bodies=256, max_pairs=1024, max_joints=16)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    band = dict(band_width=40.0, y_bands=y_bands,
                band_height=120.0 if y_bands > 1 else 0.0)
    jm, jslices, joff = jax_concat_envs(
        env_builders(jscenes, jcfg, chain=True), jcfg, **band)
    tm, slices, off = concat_envs(env_builders(scenes, cfg, chain=True), cfg,
                                  **band)
    assert slices == jslices
    np.testing.assert_array_equal(off, joff)
    ref = leaves(jax.tree_util.tree_map(np.asarray, jm.build()))
    got = leaves(state_to_numpy(tm.build("cpu")))
    for k, a in ref.items():
        assert a.dtype == got[k].dtype, k
        np.testing.assert_array_equal(a, got[k], k)
    assert int(got["joints.kind"].astype(bool).sum()) == 6
    local = env_positions(tm.build("cpu"), slices, off)
    assert max(np.abs(p[:, 0]).max() for p in local[:-1]) < 20.0
    with pytest.raises(ValueError):
        concat_envs(env_builders(scenes, cfg), cfg, y_bands=2)


def test_banded_keys_and_segmented_order_match_jax():
    """``banded_x`` keys, ``n_cross`` (one body moved onto a band
    boundary) and ``segmented_order``, and the tiled solves' ranking,
    equal the reference's to the bit."""
    tree = grid_state(GRID, {first_dynamic(grid_state(GRID)): (0.0, 60.0)})
    jcfg, cfg = JaxConfig(**GRID, **SEGMENTED), SimConfig(**GRID, **SEGMENTED)
    jb, b = jax_bodies(tree), port_bodies(tree)
    jlo, jhi = jbp.compute_aabbs(jb)
    lo, hi = bp.compute_aabbs(b)
    ref = jbp.banded_x(jlo, jhi, jb.active, jcfg)
    got = bp.banded_x(lo, hi, b.active, cfg)
    for name, a, g in zip(("swx_lo", "swx_hi", "n_cross", "bucket"), ref,
                          got):
        np.testing.assert_array_equal(np.asarray(a), g.numpy(), name)
    assert int(got[2]) == 1
    keys = np.where(tree.bodies.active, np.asarray(ref[0]), np.inf)
    keys = keys.astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jbp.segmented_order(jnp.asarray(keys), jcfg)),
        bp.segmented_order(torch.from_numpy(keys), cfg).numpy())
    for c, jc in ((cfg, jcfg), (SimConfig(**GRID, **BANDED),
                                JaxConfig(**GRID, **BANDED))):
        np.testing.assert_array_equal(
            np.asarray(jbp._routing_rank_sort(jb, jlo, jhi, jc)[0]),
            bp.rank_order(b, lo, hi, c).numpy())


@functools.lru_cache(maxsize=None)
def _jax_grid(cfg, emit_routing):
    return jax.jit(functools.partial(jbp.broadphase_sap_grid, cfg=cfg,
                                     emit_routing=emit_routing))


@pytest.mark.parametrize("layout", ["banded", "segmented"])
@pytest.mark.parametrize("emit_routing", [False, True])
def test_banded_grid_matches_jax(layout, emit_routing):
    """The grid with banded keys and the true-x accept: every Pairs field
    and counter (``ovf_band`` included, one crosser) exact, and the
    routing on banded (and segmented) ranks."""
    kw = dict(GRID, broadphase="sap_grid", sap_window=192, sap_hits=48,
              tile_stride=256, tile_halo=256,
              **(BANDED if layout == "banded" else SEGMENTED))
    tree = grid_state(kw, {first_dynamic(grid_state(kw)): (0.0, 60.0)})
    ref = _jax_grid(JaxConfig(**kw), emit_routing)(jax_bodies(tree))
    got = bp.broadphase_sap_grid(port_bodies(tree), SimConfig(**kw),
                                 emit_routing=emit_routing)
    for name in PAIRS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(got, name).numpy(), name)
    assert int(got.ovf_band) == 1 and int(got.num) > 50
    if emit_routing:
        for name in ("order", "pair_cum", "ranked_cols"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref.routing, name)),
                getattr(got.routing, name).numpy(), name)
        np.testing.assert_array_equal(np.asarray(ref.routing.lb1) // 8,
                                      got.routing.lb1.numpy())


def true_overlaps(tree):
    b = tree.bodies
    lo, hi = (x.numpy() for x in bp.compute_aabbs(port_bodies(tree)))
    act, dyn = b.active, b.inv_mass > 0
    out = set()
    for i in range(int(act.sum())):
        for j in range(i + 1, int(act.sum())):
            if (act[i] and act[j] and (dyn[i] or dyn[j])
                    and lo[i, 0] <= hi[j, 0] and lo[j, 0] <= hi[i, 0]
                    and lo[i, 1] <= hi[j, 1] and lo[j, 1] <= hi[i, 1]):
                out.add((i, j))
    return out


def pair_set(pairs):
    return {(int(a), int(b)) for a, b, v in
            zip(pairs.pi, pairs.pj, pairs.valid) if v}


@pytest.mark.parametrize("broadphase", ["sap_tiled", "sap_grid"])
def test_banded_sweep_finds_all_true_pairs(broadphase):
    """tests/test_banded_sweep.py on the port: the plain and the banded
    sweep find every true overlap, the banded one no pair across y-bands
    and only a few candidates beyond the plain one's."""
    kw = dict(GRID, broadphase=broadphase, sap_window=192, sap_hits=48)
    tree = grid_state(kw)
    b = port_bodies(tree)
    truth = true_overlaps(tree)
    plain = pair_set(bp.broadphase(b, SimConfig(**kw)))
    banded = pair_set(bp.broadphase(b, SimConfig(**kw, **BANDED)))
    assert truth <= plain and truth <= banded
    assert len(banded - plain) <= len(truth) // 4 + 2
    ylo = bp.compute_aabbs(b)[0][:, 1].numpy()
    band = np.floor((ylo + 60.0) / 120.0)
    assert all(band[i] == band[j] for i, j in banded)


def test_band_crosser_and_drifter_counted():
    """A body straddling a band boundary counts into the banded sweep's
    overflow; one moved wholly into another band pairs under the flat
    banded sort but counts into the segmented sort's overflow."""
    tree = grid_state(GRID)
    idx = first_dynamic(tree)
    kw_b, kw_s = dict(GRID, **BANDED), dict(GRID, **SEGMENTED)

    def overflow(kw, xy):
        b = port_bodies(grid_state(GRID, {idx: xy}))
        return int(bp.broadphase_sap_tiled(b, SimConfig(**kw)).overflow)

    assert overflow(kw_b, (0.0, 60.0)) >= 1
    assert overflow(GRID, (0.0, 60.0)) == 0
    drifted = (float(tree.bodies.pos[idx, 0]), 120.0)
    assert overflow(kw_b, drifted) == 0
    assert overflow(kw_s, drifted) >= 1


def test_segmented_equals_flat():
    """With every body home, the segmented sort gives the flat banded
    sort's pair buffer bit for bit, and ranks the bodies alike."""
    tree = grid_state(GRID)
    b = port_bodies(tree)
    flat = bp.broadphase_sap_tiled(b, SimConfig(**GRID, **BANDED))
    seg = bp.broadphase_sap_tiled(b, SimConfig(**GRID, **SEGMENTED))
    for name in PAIRS:
        assert torch.equal(getattr(flat, name), getattr(seg, name)), name
    assert int(seg.overflow) == 0
    lo, hi = bp.compute_aabbs(b)
    keys = bp.rank_order(b, lo, hi, SimConfig(**GRID, **BANDED))
    n = int(b.active.sum())
    assert torch.equal(keys[:n], bp.rank_order(
        b, lo, hi, SimConfig(**GRID, **SEGMENTED))[:n])


# the env mega-scene step: 8 envs x 24 boxes (200 bodies), broadphase
# "sap" under pallas_tiled (K4), two solve slabs of 128 bodies, 4 + 2
# passes; K3 on the slab-major buffer, K5 with tiled_routing off
STEP = dict(max_bodies=256, max_pairs=1024, broadphase="sap", sap_long_k=4,
            solver_backend="pallas_tiled", tile_stride=256, tile_halo=256,
            velocity_iterations=4, position_iterations=2)
STEPS = {
    "k3_banded": dict(STEP, **BANDED),
    "k5_segmented": dict(STEP, **SEGMENTED, tiled_routing=False),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_env_step_matches_jax_step(case):
    """Ten frames of the env mega-scene after four JAX frames, the port's
    input re-synced from the JAX state every frame: integers (pairs in the
    path's order, cache keys, feature ids, every counter) exact, floats
    within 1e-4."""
    kw = STEPS[case]
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    mega, _, _ = jax_concat_envs(env_builders(jscenes, jcfg), jcfg,
                                 band_width=40.0, y_bands=4,
                                 band_height=120.0)
    jst = mega.build()
    for _ in range(4):
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
        assert int(ref["stats.pair_overflow"]) == 0
    assert max(contacts) >= 150
