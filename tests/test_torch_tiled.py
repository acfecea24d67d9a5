"""The port's tiled tier against the JAX package: the tiling helpers, the
grid's slab-major finalize, the plain versions of K3 and K5 against the JAX
interpret-mode kernels on the same packed inputs, the tier rule and the
colored fallback."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu import solver as jsolver
from phyx_tpu import tiling as jtiling
from phyx_tpu.broadphase import broadphase_sap_grid as jax_grid
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.kernels.contact_solver_tiled import \
    solve_contacts_tiled as jax_tiled
from phyx_tpu.kernels.contact_solver_tiled2 import \
    solve_contacts_tiled2 as jax_tiled2
from phyx_tpu.step import step as jax_step
from phyx_tpu_torch import tiling
from phyx_tpu_torch.broadphase import broadphase_sap_grid
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.kernels import contact_solver
from phyx_tpu_torch.kernels.contact_solver_tiled import (
    solve_contacts_tiled, solve_contacts_tiled2, solve_contacts_tiled2_plain,
    solve_contacts_tiled_plain)
from phyx_tpu_torch.step import solve_inputs, step
from test_torch_step import leaves

torch.set_num_threads(1)

BLK = 1024
# a 200-box pile over two slabs (rps 128), 4 + 2 passes
TILED = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
             sap_window=48, solver_backend="pallas_tiled", tile_stride=256,
             tile_halo=256, velocity_iterations=4, position_iterations=2)
JOINTED = dict(TILED, max_joints=32)


@pytest.mark.parametrize("n,stride,halo", [(256, 256, 256),
                                           (1024, 256, 128),
                                           (32768, 16384, 2048)])
def test_tiling_helpers_match_jax(n, stride, halo):
    """slab_dims, pz_table, route_pairs (slab, clamped rows, in_win) and
    routing_bits_ok equal the reference's on numpy-made ranks and pairs,
    half of them far apart in rank."""
    kw = dict(max_bodies=n, tile_stride=stride, tile_halo=halo)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    dims = tiling.slab_dims(cfg, n)
    assert dims == jtiling.slab_dims(jcfg, n)
    rng = np.random.default_rng(n)
    rank = rng.permutation(n).astype(np.int32)
    zero = rng.random(n) < 0.2
    jpz = jtiling.pz_table(jnp.asarray(rank), jnp.asarray(zero), jcfg, n)
    pz = tiling.pz_table(torch.from_numpy(rank), torch.from_numpy(zero),
                         cfg, n)
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jpz))
    e1 = rng.integers(0, n, 4096).astype(np.int32)
    e2 = np.where(rng.random(4096) < 0.5,
                  np.clip(e1 + rng.integers(-64, 64, 4096), 0, n - 1),
                  rng.integers(0, n, 4096)).astype(np.int32)
    ref = jtiling.route_pairs(jpz, jnp.asarray(e1), jnp.asarray(e2), jcfg, n)
    got = tiling.route_pairs(pz, torch.from_numpy(e1), torch.from_numpy(e2),
                             cfg, n)
    for name, a, b in zip(("lb1", "lb2", "slab", "in_win"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert bool(got[3].any())
    if n > stride + halo:       # some pairs do span more than a window
        assert not bool(got[3].all())
    for m in (n, 2 ** 20, 2 ** 27):
        assert tiling.routing_bits_ok(m, dims[4]) == \
            jtiling.routing_bits_ok(m, dims[4])


@pytest.mark.parametrize("name,kw,tiled,fused", [
    # bench.py's build() capacities: the 10k pile (K1), the 1000-link
    # chain and the 1k pile (K2), the 20k pile (K3)
    ("pile10k", dict(max_bodies=16384, max_pairs=32256), False, False),
    ("chain", dict(max_bodies=1024, max_pairs=2048, max_joints=1024), False,
     True),
    ("pile1k", dict(max_bodies=1024, max_pairs=3584), False, True),
    ("pile20k", dict(max_bodies=32768, max_pairs=64000), True, False),
])
def test_tier_rule(name, kw, tiled, fused):
    """The tiled tier where the reference tiles, and nowhere else; inside
    the untiled tier the fused-or-streamed predicate is the card's own.
    The reference's budget formulas are copied exactly."""
    kw = dict(kw, solver_backend="pallas", broadphase="sap_grid")
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    n, c, j = cfg.max_bodies, 2 * cfg.max_pairs, cfg.max_joints
    assert tiling.resolve_tiled(cfg, n, c) == tiled
    assert jtiling.resolve_tiled(jcfg, n, c) == tiled
    assert not tiling.colored_fallback(cfg, n, c, j)
    assert tiling.ref_fused_bytes(n, c + j) == jsolver.pallas_smem_bytes(
        n, c + j)
    assert tiling.ref_streamed_bytes(n) == \
        jsolver.pallas_streamed_smem_bytes(n)
    assert tiling.REF_SMEM_BUDGET == jsolver.PALLAS_SMEM_BUDGET
    if not tiled:
        assert contact_solver.fits(n, c + j) == fused


def test_colored_fallback_raises():
    """Above the reference's fused budget with contact slots that are not
    whole 1024-slot blocks, the reference solves with its colored XLA
    sweeps (phyx_tpu/step.py:165-177).  The port raised there until the
    colored solve was ported; now it takes that solve too: three frames
    re-synced from the reference's, integers exact, floats within 1e-4."""
    kw = dict(max_bodies=1024, max_pairs=5400, broadphase="sap_grid",
              sap_window=32, solver_backend="pallas")
    n, c = 1024, 2 * 5400
    # the reference's own rule: over its fused budget, blocks not whole
    assert jsolver.pallas_smem_bytes(n, c) > jsolver.PALLAS_SMEM_BUDGET
    assert c % BLK and not jtiling.resolve_tiled(JaxConfig(**kw), n, c)
    cfg = SimConfig(**kw)
    assert tiling.colored_fallback(cfg, n, c, 0)
    jcfg = JaxConfig(**kw)
    jst = jscenes.pile(jcfg, 20, seed=0).build()
    for frame in range(3):
        ours = leaves(state_to_numpy(step(state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jst), "cpu"), cfg)))
        jst = jax_step(jst, jcfg)
        for k, a in leaves(jax.tree_util.tree_map(np.asarray, jst)).items():
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, ours[k], f"{frame} {k}")
            else:
                np.testing.assert_allclose(a, ours[k], atol=1e-4, rtol=0,
                                           err_msg=f"{frame} {k}")


def pile_state(kw, boxes, seed):
    """Numpy State tree of a pile with numpy-made overlaps and
    velocities (a frame with many contacts and no settling)."""
    st = jax.tree_util.tree_map(
        np.asarray, jscenes.pile(JaxConfig(**kw), boxes, seed=seed).build())
    rng = np.random.default_rng(4000 + seed)
    b = st.bodies
    k = slice(1, boxes + 1)
    pos, vel, angvel = b.pos.copy(), b.vel.copy(), b.angvel.copy()
    pos[k] += rng.normal(0.0, 0.08, (boxes, 2)).astype(np.float32)
    vel[k] = rng.normal(0.0, 1.0, (boxes, 2)).astype(np.float32)
    angvel[k] = rng.normal(0.0, 1.0, boxes).astype(np.float32)
    return st.replace(bodies=b.replace(pos=pos, vel=vel, angvel=angvel))


def scrambled_stack_state(kw, n=384, seed=0):
    """tests/test_overflow_causes.py's rank-scrambled stack, compressed so
    neighbours overlap: x jitter makes the x-rank order a random
    permutation of the stack, so contacts span up to ~n ranks."""
    from phyx_tpu.world import SceneBuilder as JaxSceneBuilder
    rng = np.random.default_rng(seed)
    sb = JaxSceneBuilder(JaxConfig(**kw))
    sb.add_box((0.0, -1.0), (20.0, 1.0), static=True)
    for k in range(n):
        sb.add_box((float(rng.uniform(-0.1, 0.1)), 0.5 + 0.98 * k),
                   (0.5, 0.5), friction=0.5)
    return jax.tree_util.tree_map(np.asarray, sb.build())


def jax_bodies(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree.bodies)


GRID_CASES = {
    "pile": (TILED, lambda kw: pile_state(kw, 200, 0)),
    # the buffer full: the highest (pi, pj) pairs drop before routing
    "drop": (dict(TILED, max_pairs=96), lambda kw: pile_state(kw, 200, 1)),
    # contacts beyond the halo: clamped and counted into ovf_slab
    "halo": (dict(TILED, max_bodies=512, tile_halo=128, sap_window=400),
             scrambled_stack_state),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_slab_major_matches_jax(case):
    """broadphase_sap_grid(emit_routing=True): the (slab, pi, pj) buffer,
    num, the routing (order, ranked columns, window-local rows, pair
    cumsum) and every overflow counter equal the reference's; its rows are
    pre-scaled by 8, the port's are not."""
    kw, make = GRID_CASES[case]
    tree = make(kw)
    ref = jax_grid(jax_bodies(tree), JaxConfig(**kw), emit_routing=True)
    got = broadphase_sap_grid(state_from_numpy(tree, "cpu").bodies,
                              SimConfig(**kw), emit_routing=True)
    for f in ("pi", "pj", "valid", "num", "overflow", "ovf_window",
              "ovf_slots", "ovf_drop", "ovf_band", "ovf_slab"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    r, g = ref.routing, got.routing
    for f in ("order", "ranked_cols", "pair_cum"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(r, f)), f)
    for f in ("lb1", "lb2"):
        np.testing.assert_array_equal(getattr(g, f).numpy() * 8,
                                      np.asarray(getattr(r, f)), f)
    assert int(got.num) > 50
    if case == "drop":
        assert int(got.ovf_drop) > 0
    if case == "halo":
        assert int(got.ovf_slab) > 0


@functools.lru_cache(maxsize=None)
def _jax_kernel(fn, **static):
    # gated flags on: a threshold of 0.0 never fires, so the same compiled
    # kernel serves the ungated inputs
    return jax.jit(functools.partial(fn, vel_gated=True, pos_gated=True,
                                     **static))


def with_warm(args, seed):
    """The packed rows with numpy-made warm impulses on the live contact
    slots (mass_n > 0: SAT-dead slots keep zero, as in the step)."""
    rng = np.random.default_rng(seed)
    cw = args["cw"].reshape(-1, 14).clone()
    live = cw[:, 6] > 0.0
    s = cw.shape[0]
    wn = torch.from_numpy(rng.uniform(0.0, 0.3, s).astype(np.float32))
    wt = torch.from_numpy(rng.uniform(-0.05, 0.05, s).astype(np.float32))
    cw[:, 12] = torch.where(live, wn, cw[:, 12])
    cw[:, 13] = torch.where(live, wt, cw[:, 13])
    return dict(args, cw=cw.reshape(-1))


def jax_rows(b12):
    """The reference kernels' endpoint layout: rows x8, block-transposed
    ([b1 x 1024][b2 x 1024] per block)."""
    return jnp.asarray((b12.numpy().reshape(-1, BLK, 2) * 8).swapaxes(1, 2)
                       .reshape(-1))


def assert_close(ours, ref, atol=1e-6):
    for name, a, b in zip(("body", "acc", "residual"), ref, ours):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def gate_thresholds(args, gated):
    if not gated:
        return dict(args, tols=None)
    # thresholds from a scale of 0.3 (the warm impulses' max): both gates
    # stop passes within the frame
    return dict(args, tols=torch.tensor([0.3, 0.3]))


@pytest.mark.parametrize("gated", [False, True])
def test_tiled2_plain_matches_jax_kernel(gated):
    cfg = SimConfig(**TILED)
    st = state_from_numpy(pile_state(TILED, 200, 2), "cpu")
    args = gate_thresholds(with_warm(solve_inputs(st, cfg, "tiled2"), 2),
                           gated)
    cum = args["cum"]
    assert int(cum[-1]) > 200 and int(cum[1]) > 0 and int(cum[2]) > cum[1]
    ours = solve_contacts_tiled2_plain(**args)
    tols = args["tols"]
    ref = _jax_kernel(jax_tiled2, vel_iters=4, pos_iters=2, n_slabs=2,
                      slab_stride=256, window_rows=512)(
        jnp.asarray(args["body_flat"].numpy()), jax_rows(args["b12"]),
        jnp.asarray(args["cw"].numpy()), jnp.asarray(cum.numpy()),
        tols=jnp.zeros(2) if tols is None else jnp.asarray(tols.numpy()))
    assert_close(ours, ref)
    if gated:
        ungated = solve_contacts_tiled2_plain(**dict(args, tols=None))
        assert not torch.equal(ungated[0], ours[0])
    # the wrapper takes the plain version on the CPU, without a launch
    before = solve_contacts_tiled2.launches
    got = solve_contacts_tiled2(**args)
    assert solve_contacts_tiled2.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ours))


def jointed_state(kw, seed=0):
    """A 12-link chain beside a 140-box pile (two slabs), with numpy-made
    velocities and joint warm impulses."""
    cfg = JaxConfig(**kw)
    sb = jscenes.pile(cfg, 140, seed=seed)
    prev = sb.add_box((-20.0, 8.0), (0.2, 0.2), static=True)
    for k in range(12):
        cx = -20.0 + 0.6 + 1.2 * k
        link = sb.add_box((cx, 8.0), (0.6, 0.15), friction=0.2, density=2.0)
        sb.add_revolute_joint(prev, link, (cx - 0.6, 8.0))
        prev = link
    tree = jax.tree_util.tree_map(np.asarray, sb.build())
    rng = np.random.default_rng(5000 + seed)
    pos = tree.bodies.pos.copy()
    pos[1:141] += rng.normal(0.0, 0.08, (140, 2)).astype(np.float32)
    accum = tree.joints.accum.copy()
    live = tree.joints.kind != 0
    accum[live] = rng.normal(0.0, 0.2, (int(live.sum()), 2))
    b = tree.bodies
    vel = b.vel.copy()
    k = b.inv_mass > 0
    vel[k] += rng.normal(0.0, 0.5, (int(k.sum()), 2)).astype(np.float32)
    return tree.replace(bodies=b.replace(pos=pos, vel=vel),
                        joints=tree.joints.replace(accum=accum))


@pytest.mark.parametrize("case", ["contacts", "contacts_gated", "joints"])
def test_tiled_plain_matches_jax_kernel(case):
    kw = JOINTED if case == "joints" else TILED
    cfg = SimConfig(**kw)
    tree = (jointed_state(kw) if case == "joints"
            else pile_state(kw, 200, 3))
    args = gate_thresholds(
        with_warm(solve_inputs(state_from_numpy(tree, "cpu"), cfg, "tiled"),
                  3), case == "contacts_gated")
    counts = args["slab_counts"]
    assert int(counts[0]) > 50 and int(counts[1]) > 0
    if case == "joints":
        assert args["j_slots"] == BLK and int(counts[2:].sum()) == 12
    ours = solve_contacts_tiled_plain(**args)
    tols = args["tols"]
    ref = _jax_kernel(jax_tiled, vel_iters=4, pos_iters=2, n_slabs=2,
                      slab_stride=256, window_rows=512,
                      jbps=args["j_slots"] // BLK)(
        jnp.asarray(args["body_flat"].numpy()), jax_rows(args["b12"]),
        jnp.asarray(args["cw"].numpy()), jnp.asarray(counts.numpy()),
        tols=jnp.zeros(2) if tols is None else jnp.asarray(tols.numpy()))
    assert_close(ours, ref)
    before = solve_contacts_tiled.launches
    got = solve_contacts_tiled(**args)
    assert solve_contacts_tiled.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ours))


def test_tiled_wrappers_check_inputs():
    cfg = SimConfig(**TILED)
    st = state_from_numpy(pile_state(TILED, 60, 4), "cpu")
    a2 = solve_inputs(st, cfg, "tiled2")
    a5 = solve_inputs(st, cfg, "tiled")
    with pytest.raises(TypeError):
        solve_contacts_tiled2(**dict(a2, b12=a2["b12"].long()))
    with pytest.raises(ValueError):
        solve_contacts_tiled2(**dict(a2, cum=a2["cum"][:-1]))
    with pytest.raises(ValueError):     # windows past the table
        solve_contacts_tiled2(**dict(a2, window_rows=a2["window_rows"] + 128))
    with pytest.raises(ValueError):     # joint slots must leave contacts
        solve_contacts_tiled(**dict(a5, j_slots=a5["b12"].numel() // 4))


@pytest.mark.parametrize("kw", [
    TILED, dict(TILED, tiled_routing=False), dict(TILED, broadphase="n2"),
    dict(TILED, solver_backend="pallas"),
    dict(TILED, max_pairs=512)], ids=["tiled", "no_routing", "n2",
                                      "untiled", "blocks_short"])
def test_broadphase_emits_routing_where_the_reference_does(kw):
    """With ``tiled_routing`` unset, the slab-major buffer is emitted
    exactly where the reference emits it: the grid under the tiled tier
    with ``cfg.tiled_routing``."""
    from phyx_tpu.broadphase import broadphase as jax_broadphase
    from phyx_tpu_torch.broadphase import broadphase
    tree = pile_state(kw, 60, 5)
    ref = jax_broadphase(jax_bodies(tree), JaxConfig(**kw))
    got = broadphase(state_from_numpy(tree, "cpu").bodies, SimConfig(**kw))
    assert (got.routing is None) == (ref.routing is None)
    np.testing.assert_array_equal(got.pi.numpy(), np.asarray(ref.pi))
