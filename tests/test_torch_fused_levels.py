"""The fused solve kernel K2's schedule on the CPU: the narrow/wide split of
a level list into steps (``fused_steps``), the ring's order of records
(``ring_schedule``), the solve run step by step
(``solve_contacts_fused_levels_plain``) equal to the bit to the serial plain
version and within 1e-5 of the JAX package's fused Pallas kernel (interpret
mode), and the kernel's shared-memory layout (``fused_layout``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyx_tpu.kernels.contact_solver import \
    solve_contacts_fused as jax_solve_fused
from phyx_tpu_torch import scenes, solver
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.kernels import contact_solver as k2
from phyx_tpu_torch.kernels.contact_solver import (
    NARROW, SOLVERS, STAGE, STAGES, fits, fused_layout, fused_prepass,
    fused_steps, ring_schedule, solve_contacts_fused,
    solve_contacts_fused_levels_plain)
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    solve_contacts_streamed_plain, visit_levels)
from phyx_tpu_torch.step import compact_contacts, contact_stage, solve_inputs
from test_torch_levels import assert_bit_equal, bits
from test_torch_solver import KW, frame_state, packed_inputs

torch.set_num_threads(1)

# the tolerance against the JAX kernel, which runs in interpret mode under
# XLA on the CPU and need not round each operation as the port does
ATOL = 1e-5


def chain_frame(gated):
    """The 20-link chain built by the port: 20 revolute rows in one path
    (every level one visit), numpy-made warm impulses."""
    cfg = SimConfig(max_bodies=32, max_pairs=128, max_joints=32,
                    broadphase="sap_grid", sap_window=16,
                    solver_backend="pallas")
    args = solve_inputs(scenes.chain(cfg, 20).build("cpu"), cfg)
    c, numj = args["c_cap"], int(args["num_joints"])
    rng = np.random.default_rng(7)
    warm = args["warm_flat"].reshape(-1, 2).clone()
    warm[c:c + numj] = torch.from_numpy(
        rng.normal(0.0, 0.1, (numj, 2)).astype(np.float32))
    return dict(args, warm_flat=warm.reshape(-1),
                tols=torch.tensor([1e-3, 1e-3]) if gated else None)


def rl_preset_frame(gated):
    """A 200-box pile frame under ``SimConfig.rl_preset`` (its velocity gate,
    and a displacement gate that fires within the frame's 6 passes), packed
    as the step packs it, with numpy-made warm impulses; ``gated`` False
    drops the thresholds."""
    cfg = SimConfig.rl_preset(**KW, position_rel_tol=0.1)
    bodies, _, contacts, _, _ = contact_stage(
        state_from_numpy(frame_state(4), "cpu"), cfg)
    rng = np.random.default_rng(4)
    shape = contacts.valid.shape
    contacts = contacts.replace(
        warm_n=torch.where(contacts.valid, torch.from_numpy(
            rng.uniform(0.0, 0.3, shape).astype(np.float32)), 0.0),
        warm_t=torch.where(contacts.valid, torch.from_numpy(
            rng.uniform(-0.05, 0.05, shape).astype(np.float32)), 0.0))
    compacted, _, num = compact_contacts(contacts)
    args = solver.pack_rows(bodies, compacted, num, cfg)
    assert args["tols"] is not None
    return args if gated else dict(args, tols=None)


def rows_frame(b1, b2, num, n, seed, nan_row=None, gated=False):
    """Numpy-made contact rows between the given body ids (a static body 0
    of zero inverse mass), numpy-made warm impulses; ``nan_row`` gets a NaN
    warm impulse.  The rows' masses are small beside the bodies' inverse
    masses, so the iteration converges as a real frame's does."""
    rng = np.random.default_rng(seed)
    c_cap = len(b1)
    body = np.zeros((n, 8), np.float32)
    body[:, 0:3] = rng.normal(0.0, 0.5, (n, 3))
    body[0, 0:3] = 0.0
    body[1:, 3] = rng.uniform(0.5, 2.0, n - 1)
    body[1:, 4] = rng.uniform(0.5, 2.0, n - 1)
    ang = rng.uniform(0.0, 2 * np.pi, c_cap)
    con = np.zeros((c_cap, 12), np.float32)
    con[:, 0], con[:, 1] = np.cos(ang), np.sin(ang)
    con[:, 2:6] = rng.normal(0.0, 0.5, (c_cap, 4))
    con[:, 6:8] = rng.uniform(0.02, 0.1, (c_cap, 2))
    con[:, 8] = rng.uniform(0.2, 0.8, c_cap)
    con[:, 9] = rng.uniform(0.0, 0.3, c_cap)
    con[:, 10] = rng.uniform(0.0, 0.05, c_cap)
    con[:, 11] = rng.normal(0.0, 0.1, c_cap)
    warm = np.zeros((c_cap, 2), np.float32)
    warm[:, 0] = rng.uniform(0.0, 0.3, c_cap)
    warm[:, 1] = rng.uniform(-0.05, 0.05, c_cap)
    if nan_row is not None:
        warm[nan_row, 0] = np.nan
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x).reshape(-1))
    return dict(body_flat=f(body),
                b1=torch.tensor(b1, dtype=torch.int32),
                b2=torch.tensor(b2, dtype=torch.int32), con_flat=f(con),
                warm_flat=f(warm),
                num_contacts=torch.tensor(num, dtype=torch.int32),
                vel_iters=10, pos_iters=6, num_joints=None, c_cap=c_cap,
                tols=torch.tensor([0.05, 0.02]) if gated else None)


def narrow_frame(gated):
    """Every level narrow, of widths 1 to 32: groups of disjoint pairs,
    each group's pairs sharing a body with the group before."""
    b1, b2 = [], []
    for width in (1, 3, 8, 17, 32, 5, 32, 2):
        b1 += list(range(1, width + 1))
        b2 += list(range(40, 40 + width))
    return rows_frame(b1, b2, len(b1), 80, 1, gated=gated)


def wide_frame(gated):
    """Levels of 320, 20 (five), 40 and 10 rows: wide levels (three steps
    of the kernel's solving threads, then one) after narrow ones and
    narrow after wide."""
    b1 = list(range(1, 301))                       # level 1: 300 pairs
    b2 = list(range(301, 601))
    for c in range(20):                            # 20 chains of 6 rows
        b1 += [601 + c] * 6
        b2 += list(range(621 + 6 * c, 627 + 6 * c))
    b1 += [601 + c for c in range(20)] + [626 + 6 * c for c in range(20)]
    b2 += list(range(741, 761)) + list(range(761, 781))   # level 7: 40
    b1 += [601 + c for c in range(10)]             # level 8: 10
    b2 += list(range(781, 791))
    return rows_frame(b1, b2, len(b1), 800, 2, gated=gated)


def nan_frame(gated):
    """A pile of rows with one NaN warm impulse: the NaN spreads through
    the bodies of later levels and into the residual."""
    rng = np.random.default_rng(3)
    b1 = rng.integers(0, 30, 120).tolist()
    b2 = rng.integers(0, 30, 120).tolist()
    return rows_frame(b1, b2, 100, 30, 3, nan_row=17, gated=gated)


def empty_frame(gated):
    """num = 0: no visit, the bodies unchanged, zero accumulators."""
    return rows_frame([1, 2, 3], [4, 5, 6], 0, 8, 4, gated=gated)


FRAMES = {
    "chain20": chain_frame,
    "pile200": lambda gated: packed_inputs(2, gated),
    "rl_preset": rl_preset_frame,
    "all_narrow": narrow_frame,
    "wide": wide_frame,
    "nan_impulse": nan_frame,
    "num0": empty_frame,
}


@functools.lru_cache(maxsize=None)
def _jax_fused(vel_iters, pos_iters, j_cap, gated):
    return jax.jit(functools.partial(
        jax_solve_fused, vel_iters=vel_iters, pos_iters=pos_iters,
        j_cap=j_cap, vel_gated=gated, pos_gated=gated))


def run_jax_fused(args):
    r = args["b1"].numel()
    tols, nj = args["tols"], args["num_joints"]
    out = _jax_fused(args["vel_iters"], args["pos_iters"],
                     r - args["c_cap"], tols is not None)(
        jnp.asarray(args["body_flat"].numpy()),
        jnp.asarray(args["b1"].numpy() * 8),     # the TPU kernel's offsets
        jnp.asarray(args["b2"].numpy() * 8),
        jnp.asarray(args["con_flat"].numpy()),
        jnp.asarray(args["warm_flat"].numpy()),
        jnp.asarray(args["num_contacts"].numpy()),
        num_joints=None if nj is None else jnp.asarray(nj.numpy()),
        tols=None if tols is None else jnp.asarray(tols.numpy()))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_schedule_equals_serial_and_jax(frame, gated):
    args = FRAMES[frame](gated)
    ref = solve_contacts_streamed_plain(**args)
    got = solve_contacts_fused_levels_plain(**args)
    assert_bit_equal(got, ref)
    for name, a, b in zip(("body", "acc", "residual"), run_jax_fused(args),
                          got):
        np.testing.assert_allclose(a, b.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)
    n = args["body_flat"].numel() // 8
    lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                      args["num_joints"], args["c_cap"], n)
    widths = lv["offsets"].diff()
    if frame == "num0":
        assert lv["n_levels"] == 0
        assert torch.equal(got[0], args["body_flat"])
        assert not got[1].any() and float(got[2][0]) == 0.0
    elif frame == "nan_impulse":
        assert torch.isnan(got[2]).all() and torch.isnan(got[0]).any()
    elif frame == "wide":
        assert widths.tolist() == [320] + [20] * 5 + [40, 10]
        assert int(widths.max()) > 2 * SOLVERS
    else:
        assert int(widths.max()) <= NARROW and lv["n_levels"] > 1
    if gated and frame in ("chain20", "pile200", "rl_preset"):
        ungated = solve_contacts_streamed_plain(**dict(args, tols=None))
        assert not torch.equal(bits(ungated[0]), bits(ref[0]))  # a gate fired


@pytest.mark.parametrize("offsets,steps", [
    ([0, 1, 2, 34, 66], [(0, 1, True), (1, 2, True), (2, 34, True),
                         (34, 66, True)]),
    ([0, 33], [(0, 33, False)]),
    ([0, 300, 301], [(0, 128, False), (128, 256, False), (256, 300, False),
                     (300, 301, True)]),
    ([5, 5, 37], [(5, 5, True), (5, 37, True)]),
    ([0], []),
])
def test_steps_split_levels(offsets, steps):
    assert fused_steps(offsets) == steps
    # the steps cover the records once, in order, and none is wider than
    # the solving threads
    flat = [p for a, b, _ in steps for p in range(a, b)]
    assert flat == list(range(offsets[0], offsets[-1]))
    assert all(b - a <= (NARROW if nar else SOLVERS) for a, b, nar in steps)


@pytest.mark.parametrize("offsets,passes", [
    ([0, 300, 301, 700, 730, 731, 900], 3),
    (list(range(0, 1001, 1)), 2),
    (list(range(0, 961, 30)), 4),
    ([0, 31, 33, 65, 200, 231, 263], 17),
])
def test_ring_reads_every_record_from_its_stage(offsets, passes):
    v = offsets[-1]
    steps = fused_steps(offsets)
    reads = ring_schedule(steps, v, passes, STAGES)
    nsp = -(-v // STAGE)
    assert len(reads) == passes
    for p, order in enumerate(reads):
        assert [pos for pos, _ in order] == list(range(v))
        assert all(slot == (p * nsp + pos // STAGE) % STAGES
                   for pos, slot in order)


def test_ring_too_shallow_deadlocks():
    """A wide step of 128 records at an odd start spans 5 stages: a ring of
    4 cannot hold it, and the model says so."""
    steps = fused_steps([0, 20, 148])
    with pytest.raises(RuntimeError, match="ring of 4 stages"):
        ring_schedule(steps, 148, 1, 4)
    ring_schedule(steps, 148, 1, 5)


@pytest.mark.parametrize("n_cap,r_cap,acc_smem", [
    (1024, 2 * 2048 + 1024, True),       # the 1000-link chain
    (1024, 2 * 3584, True),              # the 1k pile
    (512, 2 * 2048, True),               # the 500-box pile
    (7264, 0, True),                     # the most bodies that fit
    (1024, 12480, False),                # the most rows: the tier's limit
    (1, 14526, False),
])
def test_layout_fits_one_block(n_cap, r_cap, acc_smem):
    assert fits(n_cap, r_cap)
    place = fused_layout(n_cap, r_cap)
    assert place["acc_smem"] is acc_smem
    assert place["stages"] == STAGES
    assert place["ring_bytes"] == STAGES * STAGE * 80
    assert place["smem_bytes"] <= k2.SMEM_LIMIT - 1_024


def test_cpu_tensors_take_the_serial_plain_version():
    args = narrow_frame(True)
    before = solve_contacts_fused.launches
    got = solve_contacts_fused(**args)
    assert solve_contacts_fused.launches == before
    assert_bit_equal(got, solve_contacts_streamed_plain(**args))
    with pytest.raises(ValueError, match="CUDA"):
        fused_prepass(**args)
