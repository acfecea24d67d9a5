"""The port's solver prepare and the plain version of the serial solve
kernel against the JAX package (its streamed Pallas kernel in interpret
mode) on identical packed inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.kernels.contact_solver_streamed import \
    solve_contacts_streamed as jax_solve_streamed
from phyx_tpu.solver import prepare as jax_prepare
from phyx_tpu_torch import solver
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    solve_contacts_levels_plain, solve_contacts_streamed,
    solve_contacts_streamed_plain)
from phyx_tpu_torch.narrowphase import narrowphase_with_props
from phyx_tpu_torch.step import compact_contacts, contact_stage

torch.set_num_threads(1)

# 200 boxes, 2 * 1024 = 2048 contact rows (the streamed kernel's minimum)
KW = dict(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
          sap_window=32, solver_backend="pallas")
PREPARED = ("mass_n", "mass_t", "friction", "dst_v", "dst_dv", "c_nt")


def frame_state(seed, boxes=200):
    """Numpy State tree of a pile frame: overlapping rotated boxes with
    numpy-made velocities and restitution."""
    st = jax.tree_util.tree_map(
        np.asarray, jscenes.pile(JaxConfig(**KW), boxes, seed=seed).build())
    rng = np.random.default_rng(3000 + seed)
    b = st.bodies
    k = slice(1, boxes + 1)
    pos, rot, vel = b.pos.copy(), b.rot.copy(), b.vel.copy()
    angvel, rest = b.angvel.copy(), b.restitution.copy()
    pos[k] += rng.normal(0.0, 0.06, (boxes, 2)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, boxes).astype(np.float32)
    rot[k] = np.stack([np.cos(ang), np.sin(ang)], -1)
    vel[k] = rng.normal(0.0, 1.5, (boxes, 2)).astype(np.float32)
    angvel[k] = rng.normal(0.0, 1.0, boxes).astype(np.float32)
    rest[k] = rng.uniform(0.0, 0.5, boxes).astype(np.float32)
    return st.replace(bodies=b.replace(pos=pos, rot=rot, vel=vel,
                                       angvel=angvel, restitution=rest))


def test_prepare_matches_jax():
    st = frame_state(0)
    cfg = SimConfig(**KW)
    bodies, pairs, contacts, _, _ = contact_stage(
        state_from_numpy(st, "cpu"), cfg)
    # the same narrowphase output, handed to the JAX prepare as numpy
    raw, props = narrowphase_with_props(bodies, pairs, cfg)
    from phyx_tpu.narrowphase import Contacts as JaxContacts
    jc = JaxContacts(**{k: jnp.asarray(getattr(raw, k).numpy())
                        for k in JaxContacts.__dataclass_fields__})
    jb = jax.tree_util.tree_map(jnp.asarray, st.bodies).replace(
        vel=jnp.asarray(bodies.vel.numpy()))
    ref = jax_prepare(jb, jc, JaxConfig(**KW), pair_props=tuple(
        jnp.asarray(p.numpy()) for p in props))
    assert int(contacts.valid.sum()) > 150
    assert float(contacts.dst_v.max()) > 0.0     # restitution exercised
    for name in PREPARED:
        np.testing.assert_allclose(np.asarray(getattr(ref, name)),
                                   getattr(contacts, name).numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def packed_inputs(seed, gated):
    """The kernel's packed input of one pile frame, with numpy-made warm
    impulses on the live rows (the frame starts from a cold cache)."""
    cfg = SimConfig(**KW)
    if gated:
        # thresholds = tol * max warm impulse (0.3): both gates fire within
        # the frame's 10 + 6 passes
        cfg = cfg.replace(velocity_rel_tol=1.0, position_rel_tol=1.0)
    bodies, _, contacts, _, _ = contact_stage(
        state_from_numpy(frame_state(seed), "cpu"), cfg)
    rng = np.random.default_rng(seed)
    warm_n = torch.from_numpy(rng.uniform(0.0, 0.3, contacts.valid.shape
                                          ).astype(np.float32))
    warm_t = torch.from_numpy(rng.uniform(-0.05, 0.05, contacts.valid.shape
                                          ).astype(np.float32))
    contacts = contacts.replace(
        warm_n=torch.where(contacts.valid, warm_n, 0.0),
        warm_t=torch.where(contacts.valid, warm_t, 0.0))
    compacted, _, num = compact_contacts(contacts)
    return solver.pack_rows(bodies, compacted, num, cfg)


@functools.lru_cache(maxsize=None)
def _jax_kernel(vel_iters, pos_iters, vel_gated, pos_gated):
    return jax.jit(functools.partial(
        jax_solve_streamed, vel_iters=vel_iters, pos_iters=pos_iters,
        vel_gated=vel_gated, pos_gated=pos_gated))


def run_both(args, plain=solve_contacts_streamed_plain):
    ours = plain(**args)
    tols = args["tols"]
    # the JAX kernel's static gate flags: both on whenever thresholds are
    # given (an ungated kind's 0.0 threshold never fires)
    gated = tols is not None
    ref = _jax_kernel(args["vel_iters"], args["pos_iters"], gated, gated)(
        jnp.asarray(args["body_flat"].numpy()),
        jnp.asarray(args["b1"].numpy() * 8),     # the TPU kernel's row offsets
        jnp.asarray(args["b2"].numpy() * 8),
        jnp.asarray(args["con_flat"].numpy()),
        jnp.asarray(args["warm_flat"].numpy()),
        jnp.asarray(args["num_contacts"].numpy()),
        tols=None if tols is None else jnp.asarray(tols.numpy()))
    return ours, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("gated,plain", [
    pytest.param(False, solve_contacts_streamed_plain, id="False"),
    pytest.param(True, solve_contacts_streamed_plain, id="True"),
    # the level-by-level plain version
    pytest.param(False, solve_contacts_levels_plain, id="levels-False"),
    pytest.param(True, solve_contacts_levels_plain, id="levels-True"),
])
def test_plain_kernel_matches_jax_streamed(gated, plain):
    args = packed_inputs(1, gated)
    assert args["b1"].shape[0] >= 2048
    num = int(args["num_contacts"])
    assert num > 150
    ours, ref = run_both(args, plain)
    for name, a, b in zip(("body", "acc", "residual"), ref, ours):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    if gated:
        # both gates fired: velocity columns differ from the ungated
        # solve, displacement columns from the velocity-gated-only one
        ungated = solve_contacts_streamed_plain(**dict(args, tols=None))
        vel_only = solve_contacts_streamed_plain(**dict(
            args, tols=args["tols"] * torch.tensor([1.0, 0.0])))
        rows = lambda t: t.reshape(-1, 8)
        assert not torch.equal(rows(ungated[0])[:, :3], rows(ours[0])[:, :3])
        assert not torch.equal(rows(vel_only[0])[:, 5:], rows(ours[0])[:, 5:])


def test_wrapper_takes_plain_on_cpu_and_checks_inputs():
    args = packed_inputs(2, False)
    args = dict(args, vel_iters=2, pos_iters=1)
    before = solve_contacts_streamed.launches
    got = solve_contacts_streamed(**args)
    ref = solve_contacts_streamed_plain(**args)
    assert solve_contacts_streamed.launches == before   # no kernel launch
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        solve_contacts_streamed(**dict(args, b1=args["b1"].long()))
    with pytest.raises(ValueError):
        solve_contacts_streamed(**dict(args, con_flat=args["con_flat"][:-1]))
    with pytest.raises(TypeError):      # a count must be a device tensor
        solve_contacts_streamed(**dict(args, num_joints=3))
