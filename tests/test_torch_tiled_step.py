"""The port's tiled step against the JAX package's (its tiled Pallas
kernels in interpret mode) over re-synced frames, and the reference's own
tiled tests (tests/test_tiled_solver.py, tests/test_overflow_causes.py)
on the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.broadphase import broadphase_sap_grid as jax_grid
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.step import step as jax_step
from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
from phyx_tpu_torch import SceneBuilder, scenes, tiling
from phyx_tpu_torch.broadphase import broadphase_sap_grid
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.step import rollout, step

torch.set_num_threads(1)

# two slabs of 128 bodies, 4 + 2 passes (the plain solve is scalar torch)
TILED = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
             sap_window=48, solver_backend="pallas_tiled", tile_stride=256,
             tile_halo=256, velocity_iterations=4, position_iterations=2)
# tests/test_overflow_causes.py's slab-clamp configuration
CLAMP = dict(max_bodies=512, max_pairs=1024, broadphase="n2",
             solver_backend="pallas_tiled", tile_stride=256, tile_halo=128,
             velocity_iterations=4, position_iterations=2)


def leaves(state):
    out = {}
    for rec in ("bodies", "joints", "cache", "stats"):
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            out[f"{rec}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def scrambled_stack(builder_cls, cfg, n=384, seed=0, spacing=1.02):
    """tests/test_overflow_causes.py's rank-scrambled stack (x jitter makes
    the x-rank order a random permutation of the stack); a spacing below
    1.0 starts it compressed, every neighbour in contact."""
    rng = np.random.default_rng(seed)
    sb = builder_cls(cfg)
    sb.add_box((0.0, -1.0), (20.0, 1.0), static=True)
    for k in range(n):
        sb.add_box((float(rng.uniform(-0.1, 0.1)), 0.5 + spacing * k),
                   (0.5, 0.5), friction=0.5)
    return sb


def chain_beside_pile(m, cfg):
    """A 12-link chain beside a 140-box pile: joint rows and contacts over
    two slabs."""
    sb = m.pile(cfg, 140, seed=0)
    prev = sb.add_box((-20.0, 8.0), (0.2, 0.2), static=True)
    for k in range(12):
        cx = -20.0 + 0.6 + 1.2 * k
        link = sb.add_box((cx, 8.0), (0.6, 0.15), friction=0.2, density=2.0)
        sb.add_revolute_joint(prev, link, (cx - 0.6, 8.0))
        prev = link
    return sb


CASES = {
    # slab-major pairs, K3
    "grid_tiled2": (TILED, lambda m, cfg: m.pile(cfg, 150, seed=0), 4),
    # all-pairs broadphase, rows routed to slab budgets, K5; contacts
    # spanning past the halo are clamped and counted (ovf_slab)
    "n2_tiled": (CLAMP, lambda m, cfg: scrambled_stack(
        JaxSceneBuilder if m is jscenes else SceneBuilder, cfg,
        spacing=0.99), 1),
    # a jointed scene: no slab-major routing, K5 with joint rows
    "jointed_tiled": (dict(TILED, max_joints=32), chain_beside_pile, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_step_matches_jax_step(case):
    """Ten frames after ``before`` JAX frames, the port's input re-synced
    from the JAX state every frame: integers (the pair buffer in its path's
    order, cache keys, feature ids, counts, every overflow counter, joint
    slots) exact, floats within 1e-4."""
    kw, scene, before = CASES[case]
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst = scene(jscenes, jcfg).build()
    for _ in range(before):
        jst = jax_step(jst, jcfg)
    contacts, slab_clamps = [], 0
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
        slab_clamps += int(ref["stats.ovf_slab"])
    assert max(contacts) >= 100
    assert (slab_clamps > 0) == (case == "n2_tiled")


def test_slab_major_kinematic_static_velocity():
    """tests/test_tiled_solver.py's belt: a kinematic static (inverse mass
    0, velocity set) keeps its own embedded row on the slab-major path and
    drags the box resting on it."""
    cfg = SimConfig(**dict(TILED, max_bodies=512))
    sb = scenes.pile(cfg, 200, seed=1)
    sb.add_box((60.0, 0.25), (3.0, 0.25), static=True, friction=0.9,
               velocity=(2.0, 0.0))
    sb.add_box((60.0, 1.0), (0.4, 0.4), friction=0.9)
    st = sb.build("cpu")
    assert not bool(tiling.zero_safe_mask(st.bodies)[201])
    assert bool(tiling.zero_safe_mask(st.bodies)[0])      # the ground
    st = rollout(st, cfg, 30)
    vx = float(st.bodies.vel[202, 0])
    assert vx > 0.5, f"slab-major belt did not drag the box: vx={vx}"
    assert int(st.stats.pair_overflow) == 0


def test_slab_major_halo_violation_counted():
    """tests/test_tiled_solver.py: a contact spanning more x-ranks than the
    window is clamped by the broadphase's routing and lands in ovf_slab,
    the same count as the reference's."""
    kw = dict(TILED, max_bodies=1024, max_pairs=2048, sap_window=1024)
    cfg = SimConfig(**kw)
    sbs = (SceneBuilder(cfg), JaxSceneBuilder(JaxConfig(**kw)))
    for sb in sbs:
        sb.add_box((0.0, 0.0), (100.0, 0.25), friction=0.5)
        sb.add_box((99.0, 0.65), (0.4, 0.4), friction=0.5)
        for k in range(700):
            sb.add_box((-95.0 + 0.27 * k, 50.0), (0.1, 0.1))
    st = step(sbs[0].build("cpu"), cfg)
    assert int(st.stats.ovf_slab) > 0, "slab clamp was not counted"
    assert int(st.stats.pair_overflow) >= int(st.stats.ovf_slab)
    # the count is the broadphase's, on positions the step has not moved
    ours = broadphase_sap_grid(sbs[0].build("cpu").bodies, cfg)
    theirs = jax_grid(sbs[1].build().bodies, JaxConfig(**kw),
                      emit_routing=True)
    assert int(ours.ovf_slab) == int(theirs.ovf_slab) == \
        int(st.stats.ovf_slab)


def test_slab_clamp_fires_ovf_slab():
    """tests/test_overflow_causes.py:181-211 on the port, over a shorter
    rollout: the clamps land in ovf_slab and only there, the sum is the
    pair overflow, an adequate halo has none, and the clamped rows solve
    against the wrong bodies, so the two runs part."""
    base = SimConfig(**CLAMP)
    ok = base.replace(tile_halo=512)     # window 768 covers all 384 ranks
    st = scrambled_stack(SceneBuilder, base).build("cpu")
    a = rollout(st, base, 12)
    b = rollout(st, ok, 12)
    causes = {f: int(getattr(a.stats, f)) for f in
              ("ovf_window", "ovf_slots", "ovf_drop", "ovf_band", "ovf_slab")}
    assert causes["ovf_slab"] > 0
    assert sum(causes.values()) == causes["ovf_slab"]
    assert int(a.stats.pair_overflow) == causes["ovf_slab"]
    assert int(b.stats.pair_overflow) == 0
    act = st.bodies.active
    rms = float((a.bodies.pos - b.bodies.pos)[act].square().sum(1).mean()
                .sqrt())
    assert rms > 1e-3, f"expected slab clamps to change the trajectory: {rms}"
