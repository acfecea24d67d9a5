"""User joints in the port against the JAX package: the jointed scenes, the
joint prepare, jointed-pair exclusion, the serial solve with joint rows
(the JAX fused Pallas kernel in interpret mode) and the kernel choice."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu import scenes as jscenes
from phyx_tpu.broadphase import broadphase as jax_broadphase
from phyx_tpu.config import SimConfig as JaxConfig
from phyx_tpu.joints import prepare_joint_rows as jax_prepare_joint_rows
from phyx_tpu.kernels.contact_solver import \
    solve_contacts_fused as jax_solve_fused
from phyx_tpu.step import exclude_joint_pairs as jax_exclude
from phyx_tpu.step import step as jax_step
from phyx_tpu_torch import SceneBuilder, scenes
from phyx_tpu_torch.broadphase import broadphase
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
from phyx_tpu_torch.joints import prepare_joint_rows
from phyx_tpu_torch.kernels import contact_solver
from phyx_tpu_torch.kernels.contact_solver import solve_contacts_fused
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    solve_contacts_streamed, solve_contacts_streamed_plain)
from phyx_tpu_torch.step import exclude_joint_pairs, solve_inputs

torch.set_num_threads(1)

KW = dict(max_bodies=32, max_pairs=128, max_joints=16,
          broadphase="sap_grid", sap_window=16, solver_backend="pallas")

RECORDS = ("bodies", "joints", "cache", "stats")

SCENES = {
    "chain": lambda m, cfg: m.chain(cfg, 8),
    "bridge": lambda m, cfg: m.bridge(cfg, 8, load_boxes=3),
    "net": lambda m, cfg: m.net(cfg, 6),
    "pyramid": lambda m, cfg: m.pyramid(cfg, 5),
    "avalanche": lambda m, cfg: m.avalanche(cfg, 40, seed=1),
}


def assert_bit_identical(a, b):
    """Every field of the two State trees has the same dtype, shape and
    bytes (leaves numpy arrays or tensors)."""
    for rec in RECORDS:
        for f in dataclasses.fields(getattr(a, rec)):
            x, y = (np.asarray(getattr(getattr(s, rec), f.name))
                    for s in (a, b))
            key = f"{rec}.{f.name}"
            assert (x.dtype, x.shape) == (y.dtype, y.shape), key
            assert x.tobytes() == y.tobytes(), key


# frames of JAX steps after which the loaded bridge's boxes rest on it
BRIDGE_LOADED = 50


def jax_state(scene, kw=KW, frames=0):
    """Numpy State tree of a JAX-built scene after ``frames`` JAX steps
    (read-only: shared between the tests of a process)."""
    return _jax_state(scene, tuple(sorted(kw.items())), frames)


@functools.lru_cache(maxsize=None)
def _jax_state(scene, kw, frames):
    jcfg = JaxConfig(**dict(kw))
    st = SCENES[scene](jscenes, jcfg).build()
    for _ in range(frames):
        st = jax_step(st, jcfg)
    return jax.tree_util.tree_map(np.asarray, st)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_builds_bit_identical(scene):
    kw = dict(KW, max_bodies=64)
    ours = SCENES[scene](scenes, SimConfig(**kw)).build("cpu")
    assert_bit_identical(jax_state(scene, kw), ours)


def test_build_defaults_to_the_card():
    """With no device named, the state lands on the card; a torch without
    CUDA raises instead of falling back to the CPU."""
    sb = scenes.chain(SimConfig(**KW), 4)
    if torch.cuda.is_available():
        assert sb.build().bodies.pos.device.type == "cuda"
    else:
        with pytest.raises(AssertionError, match="CUDA"):
            sb.build()


def test_convert_round_trips_joints():
    ref = jax_state("bridge", frames=3)
    assert (ref.joints.kind == 1).sum() == 9
    assert np.abs(ref.joints.accum).max() > 0.0
    ours = state_from_numpy(ref, "cpu")
    assert ours.joints.kind.dtype == torch.int32
    assert ours.joints.a1.dtype == torch.float32
    assert_bit_identical(ref, ours)
    assert_bit_identical(ref, state_to_numpy(ours))


def test_joint_count_past_capacity_raises():
    sb = SceneBuilder(SimConfig(**dict(KW, max_joints=1)))
    a = sb.add_box((0.0, 0.0), (0.5, 0.5))
    b = sb.add_box((1.0, 0.0), (0.5, 0.5))
    sb.add_revolute_joint(a, b, (0.5, 0.0))
    with pytest.raises(ValueError, match="max_joints"):
        sb.add_distance_joint(a, b, (0.0, 0.0), (1.0, 0.0))


def perturbed(tree, seed):
    """The tree with numpy-made positions, rotations and joint impulses on
    its live bodies and joints, so the anchor arms and errors are not the
    build's round numbers."""
    rng = np.random.default_rng(seed)
    b, j = tree.bodies, tree.joints
    live = np.flatnonzero(b.active & (b.inv_mass > 0))
    pos, rot = b.pos.copy(), b.rot.copy()
    pos[live] += rng.normal(0.0, 0.05, (live.size, 2)).astype(np.float32)
    ang = rng.uniform(-0.4, 0.4, live.size).astype(np.float32)
    rot[live] = np.stack([np.cos(ang), np.sin(ang)], -1)
    accum = np.where((j.kind != 0)[:, None],
                     rng.normal(0.0, 0.2, j.accum.shape), 0.0
                     ).astype(np.float32)
    return tree.replace(bodies=b.replace(pos=pos, rot=rot),
                        joints=j.replace(accum=accum))


@pytest.mark.parametrize("scene", ["bridge", "net"])
def test_prepare_joint_rows_matches_jax(scene):
    tree = perturbed(jax_state(scene), seed=4)
    cfg = SimConfig(**KW)
    ours = prepare_joint_rows(state_from_numpy(tree, "cpu").bodies,
                              state_from_numpy(tree, "cpu").joints, cfg)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jax_prepare_joint_rows(jt.bodies, jt.joints, JaxConfig(**KW))
    kind = tree.joints.kind
    assert (kind != 0).sum() >= 7 and (kind == 0).sum() >= 7   # free slots
    rows, warm = (t.numpy() for t in ours)
    np.testing.assert_array_equal(rows[:, 11], np.asarray(ref[0])[:, 11])
    for name, a, b in (("rows", ref[0], rows), ("warm", ref[1], warm)):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("bp", ["n2", "sap_grid"])
@pytest.mark.parametrize("scene", ["chain", "bridge"])
def test_exclude_joint_pairs_matches_jax(scene, bp):
    kw = dict(KW, broadphase=bp)
    tree = jax_state(scene, kw,
                     frames=BRIDGE_LOADED if scene == "bridge" else 0)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jcfg = JaxConfig(**kw)
    jpairs = jax_broadphase(jt.bodies, jcfg, tiled_routing=False)
    ref = jax_exclude(jpairs, jt.joints, n_cap=jcfg.max_bodies)
    st = state_from_numpy(tree, "cpu")
    pairs = broadphase(st.bodies, SimConfig(**kw))
    got = exclude_joint_pairs(pairs, st.joints)
    # jointed pairs were candidates; on the loaded bridge, the planks' and
    # boxes' contacts survive
    assert int(pairs.num) > int(got.num) >= (scene == "bridge")
    for name in ("pi", "pj", "valid", "num"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(got, name).numpy(), name)


def jointed_inputs(scene, gated, seed=0):
    """The solve kernels' packed input of one jointed frame: the port's
    stages on a JAX-settled state, with numpy-made warm impulses on the
    live contact and joint rows."""
    frames = BRIDGE_LOADED if scene == "bridge" else 10
    cfg = SimConfig(**KW)
    args = solve_inputs(state_from_numpy(jax_state(scene, frames=frames),
                                         "cpu"), cfg)
    rng = np.random.default_rng(seed)
    c, num = args["c_cap"], int(args["num_contacts"])
    numj = int(args["num_joints"])
    warm = args["warm_flat"].reshape(-1, 2).clone()
    warm[:num, 0] = torch.from_numpy(rng.uniform(0.0, 0.3, num)
                                     .astype(np.float32))
    warm[:num, 1] = torch.from_numpy(rng.uniform(-0.05, 0.05, num)
                                     .astype(np.float32))
    warm[c:c + numj] = torch.from_numpy(rng.normal(0.0, 0.1, (numj, 2))
                                        .astype(np.float32))
    args = dict(args, warm_flat=warm.reshape(-1))
    if gated:
        # thresholds that stop both kinds of pass within the frame's 10 + 6
        args["tols"] = torch.tensor([2e-3, 2e-3])
    return args


@functools.lru_cache(maxsize=None)
def _jax_fused(vel_iters, pos_iters, j_cap, gated):
    return jax.jit(functools.partial(
        jax_solve_fused, vel_iters=vel_iters, pos_iters=pos_iters,
        j_cap=j_cap, vel_gated=gated, pos_gated=gated))


def run_jax_fused(args):
    r = args["b1"].numel()
    tols = args["tols"]
    out = _jax_fused(args["vel_iters"], args["pos_iters"],
                     r - args["c_cap"], tols is not None)(
        jnp.asarray(args["body_flat"].numpy()),
        jnp.asarray(args["b1"].numpy() * 8),     # the TPU kernel's offsets
        jnp.asarray(args["b2"].numpy() * 8),
        jnp.asarray(args["con_flat"].numpy()),
        jnp.asarray(args["warm_flat"].numpy()),
        jnp.asarray(args["num_contacts"].numpy()),
        num_joints=jnp.asarray(args["num_joints"].numpy()),
        tols=None if tols is None else jnp.asarray(tols.numpy()))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("scene", ["bridge", "net"])
def test_plain_solve_with_joints_matches_jax_fused(scene, gated):
    args = jointed_inputs(scene, gated)
    num, numj = int(args["num_contacts"]), int(args["num_joints"])
    kinds = args["con_flat"].reshape(-1, 12)[args["c_cap"]:, 11]
    if scene == "bridge":     # revolute rows and contacts
        assert num >= 4 and numj == 9 and (kinds == 1.0).sum() == 9
    else:                     # distance rows
        assert numj == 7 and (kinds == 2.0).sum() == 7
    ours = solve_contacts_streamed_plain(**args)
    ref = run_jax_fused(args)
    for name, a, b in zip(("body", "acc", "residual"), ref, ours):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert float(ours[2][0]) > 0.0
    if gated:
        ungated = solve_contacts_streamed_plain(**dict(args, tols=None))
        assert not torch.equal(ungated[0], ours[0])   # a gate fired


def test_wrappers_take_plain_on_cpu_and_check_inputs():
    args = dict(jointed_inputs("bridge", False), vel_iters=3, pos_iters=2)
    ref = solve_contacts_streamed_plain(**args)
    for wrapper in (solve_contacts_fused, solve_contacts_streamed):
        before = wrapper.launches
        got = wrapper(**args)
        assert wrapper.launches == before        # no kernel on the CPU
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        with pytest.raises(TypeError):
            wrapper(**dict(args, num_joints=int(args["num_joints"])))
        with pytest.raises(ValueError):
            wrapper(**dict(args, c_cap=args["b1"].numel() + 1))
        with pytest.raises(ValueError):
            wrapper(**dict(args, num_joints=None))   # joint slots, no count
    # without the joint rows' count the joint slots are not visited
    no_joints = solve_contacts_streamed_plain(**dict(
        args, num_joints=torch.zeros((), dtype=torch.int32)))
    assert not torch.equal(no_joints[0], ref[0])
    c = args["c_cap"]
    assert not no_joints[1].reshape(-1, 4)[c:].any()


@pytest.mark.parametrize("n_cap,contact_slots,joint_slots,fused", [
    (1024, 2 * 2048, 1024, True),        # the 1000-link chain: 114,688 B
    (1024, 2 * 3584, 0, True),           # the 1k pile: 147,456 B
    (16384, 2 * 32256, 0, False),        # the 10k pile: 1.56 MB
    (1024, 12480, 0, True),              # 232,448 B: the limit itself
    (1024, 12481, 0, False),
])
def test_kernel_choice(n_cap, contact_slots, joint_slots, fused):
    r = contact_slots + joint_slots
    assert contact_solver.fits(n_cap, r) is fused
    assert (contact_solver.fused_smem_bytes(n_cap, r)
            <= contact_solver.SMEM_LIMIT) is fused
