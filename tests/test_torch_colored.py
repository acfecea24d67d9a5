"""The port's colored solve (``solver_backend="xla"`` and the colored
fallback) against the JAX package: the coloring exactly, one warm start +
velocity + displacement solve on the same prepared contacts, and whole
steps re-synced every frame."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import coloring as jcoloring
from phyx_tpu import scenes as jscenes
from phyx_tpu import solver as jsolver
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.narrowphase import Contacts as JaxContacts
from phyx_tpu.step import step as jax_step
from phyx_tpu.types import Bodies as JaxBodies
from phyx_tpu_torch import coloring, solver, tiling
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.step import colored_rows, contact_stage
from test_torch_step import JOINTED, PILE, hold_steps_to_jax

torch.set_num_threads(1)

XLA_PILE = dict(PILE, solver_backend="xla")
XLA_JOINTED = dict(JOINTED, solver_backend="xla")
# 200 boxes, 2048 contact slots
BIG_PILE = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
                sap_window=32, solver_backend="xla")


def jittered_pile(kw, boxes, seed):
    """Numpy State tree of a pile with numpy-made overlaps and velocities:
    a frame with many contacts, ground contacts among them."""
    st = jax.tree_util.tree_map(
        np.asarray, jscenes.pile(JaxConfig(**kw), boxes, seed=seed).build())
    rng = np.random.default_rng(6000 + seed)
    b = st.bodies
    k = slice(1, boxes + 1)
    pos, vel, angvel = b.pos.copy(), b.vel.copy(), b.angvel.copy()
    pos[k] += rng.normal(0.0, 0.06, (boxes, 2)).astype(np.float32)
    vel[k] = rng.normal(0.0, 1.0, (boxes, 2)).astype(np.float32)
    angvel[k] = rng.normal(0.0, 1.0, boxes).astype(np.float32)
    return st.replace(bodies=b.replace(pos=pos, vel=vel, angvel=angvel))


def settled(kw, scene, frames):
    """Numpy State tree after ``frames`` JAX steps of ``scene``: a frame
    with warm impulses in its cache."""
    jcfg = JaxConfig(**kw)
    st = scene(jscenes, jcfg).build()
    for _ in range(frames):
        st = jax_step(st, jcfg)
    return jax.tree_util.tree_map(np.asarray, st)


def static_mask(bodies):
    return (bodies.inv_mass == 0.0) & (bodies.inv_inertia == 0.0)


def rows_of(tree, kw, what):
    """(b1, b2, valid, body_static) numpy rows of a frame: its contacts
    after the port's contact stage, or its joint rows."""
    cfg = SimConfig(**kw)
    st = state_from_numpy(tree, "cpu")
    if what == "joints":
        j = st.joints
        n = cfg.max_bodies - 1
        rows = (torch.clamp(j.b1, max=n), torch.clamp(j.b2, max=n),
                j.kind != 0)
    else:
        _, _, c, _, _ = contact_stage(st, cfg)
        rows = (c.b1, c.b2, c.valid)
    return tuple(x.numpy() for x in rows) + (
        static_mask(st.bodies).numpy(),)


@pytest.mark.parametrize("what,num_colors", [
    ("pile", 24), ("pile", 4), ("joints", 24), ("joints", 2)])
def test_colors_equal_jax(what, num_colors):
    """Colors exactly equal to the reference's on a jittered 200-box pile
    (ground contacts among them) and on a 60-link chain's joint rows (a
    static anchor among them), with colors
    plentiful and scarce; ``check_coloring`` equal, and 0."""
    if what == "pile":
        kw = BIG_PILE
        tree = jittered_pile(kw, 200, 1)
    else:
        kw = dict(XLA_JOINTED, max_bodies=64, max_joints=64)
        tree = jax.tree_util.tree_map(
            np.asarray, jscenes.chain(JaxConfig(**kw), 60).build())
    b1, b2, valid, static = rows_of(tree, kw, what)
    ours = coloring.color_rows(*(torch.from_numpy(x) for x in (
        b1, b2, valid, static)), num_colors)
    ref = np.array(jcoloring.color_rows(
        *(jnp.asarray(x) for x in (b1, b2, valid, static)), num_colors))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert valid.sum() > (300 if what == "pile" else 40)
    assert static[b1[valid]].any() or static[b2[valid]].any()
    if num_colors < 8:
        # colors scarce: the final class holds real conflicts
        assert (ref[valid] == num_colors - 1).sum() > 10
    rows = types.SimpleNamespace(b1=b1, b2=b2, valid=valid, color=ref)
    cfg = types.SimpleNamespace(num_colors=num_colors)
    got = coloring.check_coloring(
        types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in
                                 vars(rows).items()}),
        torch.from_numpy(static), cfg)
    want = jcoloring.check_coloring(
        types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in
                                 vars(rows).items()}),
        jnp.asarray(static), cfg)
    assert int(got) == int(want) == 0
    # a deliberately clashing coloring is counted the same way
    bad = np.where(valid, 0, num_colors - 1).astype(np.int32)
    clash = [f(types.SimpleNamespace(b1=conv(b1), b2=conv(b2),
                                     valid=conv(valid), color=conv(bad)),
               conv(static), cfg)
             for f, conv in ((coloring.check_coloring, torch.from_numpy),
                             (jcoloring.check_coloring, jnp.asarray))]
    assert int(clash[0]) == int(clash[1]) > 0


def test_priority_hash_matches_uint32():
    """The int64 emulation of the reference's uint32 hash, bit for bit, at
    indices near 2^20 and for every round."""
    c = 2 ** 20 - 1
    pri = coloring.priorities(c, 24, "cpu").numpy()
    idx = np.arange(c, dtype=np.uint32)
    for r in range(23):
        with np.errstate(over="ignore"):      # uint32 wrap-around
            h = idx * np.uint32(2654435761) + np.uint32(r + 1) * np.uint32(
                0x9E3779B9)
        h = h ^ (h >> np.uint32(15))
        ref = ((h << np.uint32(20)) & np.uint32(0x7FF00000)).astype(
            np.int32) | idx.astype(np.int32)
        np.testing.assert_array_equal(pri[r], ref)


def test_capacity_assert():
    """2^20 rows or more break the priority packing: the reference's check
    and message."""
    c = 2 ** 20
    z = torch.zeros(c, dtype=torch.int32)
    with pytest.raises(AssertionError, match=r"row capacity 1048576 >= 2\^20"):
        coloring.color_rows(z, z, torch.zeros(c, dtype=torch.bool),
                            torch.zeros(4, dtype=torch.bool), 16)
    ok = coloring.color_rows(z[:c - 1], z[:c - 1],
                             torch.zeros(c - 1, dtype=torch.bool),
                             torch.zeros(4, dtype=torch.bool), 2)
    assert (ok == 1).all()


def jax_contacts(c):
    return JaxContacts(**{k: jnp.asarray(getattr(c, k).numpy())
                          for k in JaxContacts.__dataclass_fields__})


def jax_bodies(b):
    return JaxBodies(**{k: jnp.asarray(getattr(b, k).numpy())
                        for k in JaxBodies.__dataclass_fields__})


def solve_both(tree, kw):
    """The port's and the reference's warm start, velocity and
    displacement passes on the port's prepared, colored contacts and joint
    rows of one frame.  Returns (port outputs, reference outputs) as dicts
    of numpy arrays."""
    cfg, jcfg = SimConfig(**kw), JaxConfig(**kw)
    st = state_from_numpy(tree, "cpu")
    bodies, _, contacts, jrows, jwarm = contact_stage(st, cfg)
    _, contacts, xj = colored_rows(bodies, contacts, st.joints, jrows,
                                   jwarm, cfg)
    jxj = None
    if xj is not None:
        jxj = jsolver.XlaJoints(*(jnp.asarray(x.numpy()) for x in xj))
    out = {}
    for name, mod, b, c, j, conf in (
            ("port", solver, bodies, contacts, xj, cfg),
            ("jax", jsolver, jax_bodies(bodies), jax_contacts(contacts), jxj,
             jcfg)):
        b = mod.warm_start(b, c, j)
        warm = b
        v = mod.solve_velocity(b, c, conf, j)
        p = mod.solve_position(v[0], c, conf, j)
        out[name] = {k: np.asarray(x) for k, x in dict(
            warm_vel=warm.vel, warm_angvel=warm.angvel, vel=p.vel,
            angvel=p.angvel, dvel=p.dvel, dangvel=p.dangvel, accum_n=v[1],
            accum_t=v[2], residual=v[3],
            **({"joint_accum": v[4]} if j is not None else {})).items()}
    return out["port"], out["jax"], contacts


def assert_solves_close(ours, ref):
    for k, a in ref.items():
        np.testing.assert_allclose(ours[k], a, atol=1e-5, rtol=0,
                                   err_msg=k)


SOLVE_FRAMES = {
    # a settling pile: warm impulses from 30 frames
    "pile": (XLA_PILE, lambda m, cfg: m.pile(cfg, 60, seed=2), 30, 100),
    # boxes on a bridge: revolute rows and contacts
    "loaded_bridge": (XLA_JOINTED, lambda m, cfg: m.bridge(
        cfg, 8, load_boxes=3), 50, 2),
    # distance rows alone
    "net": (XLA_JOINTED, lambda m, cfg: m.net(cfg, 6), 10, 0),
}


@pytest.mark.parametrize("scene", list(SOLVE_FRAMES))
def test_solve_matches_jax(scene):
    """warm_start, solve_velocity and solve_position on the same prepared
    contacts (and joint rows), ungated: velocities, pseudo-velocities,
    accumulators and residual within 1e-5."""
    kw, make, frames, min_contacts = SOLVE_FRAMES[scene]
    ours, ref, contacts = solve_both(settled(kw, make, frames), kw)
    assert int(contacts.valid.sum()) >= min_contacts
    assert np.abs(ref["vel"] - ref["warm_vel"]).max() > 1e-3
    assert_solves_close(ours, ref)


@pytest.mark.parametrize("what,num_colors", [("pile", 4), ("joints", 2)])
def test_card_summation_matches_cpu_summation(what, num_colors,
                                              monkeypatch):
    """The card's sum of rows that share a body (the sorted
    ``index_put(accumulate=True)`` of ``solver._ordered_add``), run here on
    one thread, where it sums in row order as the CPU's ``index_add``
    does.  Colors scarce, so the final class holds real conflicts (the
    jittered 200-box pile's contacts, the 60-link chain's joint rows): the
    solve equal to the bit to the CPU's and, after one pass of each kind
    (over 10 + 6 passes a final class this full amplifies last-bit
    differences past 1e-5), within 1e-5 of the reference's."""
    one = dict(num_colors=num_colors, velocity_iterations=1,
               position_iterations=1)
    if what == "pile":
        kw = dict(BIG_PILE, **one)
        tree = jittered_pile(kw, 200, 1)
    else:
        kw = dict(XLA_JOINTED, max_bodies=64, max_joints=64, **one)
        tree = jax.tree_util.tree_map(
            np.asarray, jscenes.chain(JaxConfig(**kw), 60).build())
    b1, b2, valid, static = rows_of(tree, kw, what)
    color = coloring.color_rows(*(torch.from_numpy(x) for x in (
        b1, b2, valid, static)), num_colors).numpy()
    assert (color[valid] == num_colors - 1).sum() > 10
    cpu, ref, _ = solve_both(tree, kw)
    assert torch.get_num_threads() == 1
    monkeypatch.setattr(solver, "_ordered_add", lambda v, idx, upd: (
        v.index_put((idx,), upd, accumulate=True)))
    card, _, _ = solve_both(tree, kw)
    for k, a in cpu.items():
        np.testing.assert_array_equal(card[k].view(np.uint32),
                                      a.view(np.uint32), err_msg=k)
    assert_solves_close(card, ref)


@pytest.mark.parametrize("scene,tols", [
    ("pile", dict(velocity_rel_tol=0.2, position_rel_tol=0.2)),
    ("pile", dict(velocity_tol=5e-3)),
    ("loaded_bridge", dict(velocity_rel_tol=0.05, position_rel_tol=0.05)),
], ids=["pile_rel", "pile_abs", "bridge_rel"])
def test_gated_solve_matches_jax(scene, tols):
    """The same with the residual gates on, on frames where they skip
    passes: the gated result differs from the ungated one and still
    matches the reference's, whose skipped passes are the same."""
    kw, make, frames, _ = SOLVE_FRAMES[scene]
    tree = settled(kw, make, frames)
    ours, ref, _ = solve_both(tree, dict(kw, **tols))
    assert_solves_close(ours, ref)
    full, _, _ = solve_both(tree, kw)
    assert np.abs(full["vel"] - ours["vel"]).max() > 1e-6, \
        "the gates skipped no pass"


def test_xla_step_matches_jax_step():
    hold_steps_to_jax(JaxConfig(**XLA_PILE), SimConfig(**XLA_PILE), seed=1)


def test_gated_xla_step_matches_jax_step():
    kw = dict(XLA_PILE, position_rel_tol=1e-2)
    hold_steps_to_jax(JaxConfig.rl_preset(**kw), SimConfig.rl_preset(**kw),
                      seed=1)


@pytest.mark.parametrize("scene,before,min_contacts", [
    pytest.param(lambda m, cfg: m.chain(cfg, 8), 0, 0, id="chain"),
    pytest.param(lambda m, cfg: m.bridge(cfg, 8, load_boxes=3), 50, 2,
                 id="loaded_bridge"),
])
def test_jointed_xla_step_matches_jax_step(scene, before, min_contacts):
    hold_steps_to_jax(JaxConfig(**XLA_JOINTED), SimConfig(**XLA_JOINTED),
                      scene=scene, before=before, min_contacts=min_contacts)


def test_colored_fallback_step_matches_jax_step():
    """A "pallas" configuration over the reference's fused budget whose
    contact slots are not whole 1024-slot blocks takes the colored solve,
    as the reference does."""
    kw = dict(PILE, max_pairs=5888)
    n, c = kw["max_bodies"], 2 * kw["max_pairs"]
    assert jsolver.pallas_smem_bytes(n, c) > jsolver.PALLAS_SMEM_BUDGET
    assert tiling.colored_fallback(SimConfig(**kw), n, c, 0)
    hold_steps_to_jax(JaxConfig(**kw), SimConfig(**kw), seed=3)
