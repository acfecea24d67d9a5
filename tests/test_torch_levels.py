"""The level schedule of the streamed solve kernel K1: its pre-pass
(``visit_levels``) against a loop over the recurrence, and the level-by-level
solve (``solve_contacts_levels_plain``) against the serial plain version,
to the bit, on a pile frame, a jointed frame and a frame whose static body
moves at -0.0; and the free rows (all +0.0: a static at rest), which are no
nodes of the schedule while every write to them is +0.0, with the fallback
over the full graph where one is not."""

import functools

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    free_rows, freed_walk, levels_walk, placement, prepass,
    solve_contacts_levels_plain, solve_contacts_streamed,
    solve_contacts_streamed_plain, solve_in_device_memory, visit_levels)
from phyx_tpu_torch.step import rollout, solve_inputs
from test_torch_solver import packed_inputs

torch.set_num_threads(1)


def serial_levels(b1, b2, num, numj, c_cap, n, free=()):
    """The recurrence, walked: level(k) = 1 + max(last[i], last[j]), a
    free row's last level 0 throughout."""
    r = len(b1)
    num = min(max(num, 0), c_cap)
    numj = 0 if numj is None else min(max(numj, 0), r - c_cap)
    slots = list(range(num)) + list(range(c_cap, c_cap + numj))
    last = [0] * n
    out = []
    for k in slots:
        i = min(max(b1[k], 0), n - 1)
        j = min(max(b2[k], 0), n - 1)
        lvl = 1 + max(last[i], last[j])
        for b in (i, j):
            if b not in free:
                last[b] = lvl
        out.append((k, i, j, lvl))
    return out


def check_levels(b1, b2, num, numj, c_cap, n):
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    lv = visit_levels(t(b1), t(b2), t(num), None if numj is None else t(numj),
                      c_cap, n)
    ref = serial_levels(b1, b2, num, numj, c_cap, n)
    assert lv["slots"].tolist() == [v[0] for v in ref]
    assert lv["i"].tolist() == [v[1] for v in ref]
    assert lv["j"].tolist() == [v[2] for v in ref]
    level = lv["level"].tolist()
    assert level == [v[3] for v in ref]
    assert lv["n_levels"] == max(level, default=0)
    # the buckets: levels ascending, serial order inside a level
    order, offsets = lv["order"].tolist(), lv["offsets"].tolist()
    assert sorted(order) == list(range(len(ref)))
    assert [level[q] for q in order] == sorted(level)
    for lvl in range(lv["n_levels"]):
        members = order[offsets[lvl]:offsets[lvl + 1]]
        assert members == sorted(members)
        assert all(level[q] == lvl + 1 for q in members)
        # no two visits of a level share a body
        bodies = [b for q in members for b in {ref[q][1], ref[q][2]}]
        assert len(bodies) == len(set(bodies))
    # two visits that share a body keep their serial order
    seen = {}
    for q, (_, i, j, lvl) in enumerate(ref):
        for b in {i, j}:
            assert level[q] > seen.get(b, 0)
            seen[b] = level[q]
    return lv


@pytest.mark.parametrize("case", [
    # self pairs, repeated pairs, a chain through one body
    ([0, 1, 1, 2, 0, 3], [0, 2, 2, 2, 3, 3], 6, None, 6, 4),
    # ids out of range, clamped into [0, n)
    ([-5, 7, 2, 9, -1], [3, -2, 11, 0, 4], 5, None, 5, 5),
    # num 0, and no joint rows
    ([0, 1], [1, 2], 0, None, 2, 3),
    # joint rows only
    ([5, 6, 0, 1, 1], [6, 7, 1, 2, 0], 0, 3, 2, 8),
    # contacts past num skipped; joints past num_joints skipped; negative
    # counts
    ([0, 1, 2, 3, 0, 2, 1], [1, 2, 3, 0, 3, 1, 0], 3, 2, 4, 4),
    ([0, 1, 2, 3], [1, 2, 3, 0], -1, -4, 2, 4),
])
def test_levels_on_hand_made_ids(case):
    check_levels(*case)


@st.composite
def id_rows(draw):
    n = draw(st.integers(1, 10))
    c_cap = draw(st.integers(0, 20))
    jointed = draw(st.booleans())
    j_cap = draw(st.integers(0, 6)) if jointed else 0
    r = c_cap + j_cap
    # ids from a small pool, so that pairs repeat, with some out of range
    ids = st.integers(-2, n + 2)
    b1 = draw(st.lists(ids, min_size=r, max_size=r))
    b2 = [b if draw(st.booleans()) and draw(st.booleans()) else draw(ids)
          for b in b1]                      # about a quarter self pairs
    num = draw(st.integers(-1, c_cap + 2))
    numj = draw(st.integers(-1, j_cap + 2)) if jointed else None
    return b1, b2, num, numj, c_cap, n


@settings(max_examples=150, deadline=None)
@given(id_rows())
@example(([], [], 0, None, 0, 1))
@example(([2, 2, 2], [2, 2, 2], 3, None, 3, 3))
def test_levels_follow_the_recurrence(rows):
    check_levels(*rows)


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bit_equal(got, ref):
    """Body rows, accumulators and residual equal to the bit (-0.0 is not
    0.0); a NaN equals a NaN of any payload."""
    for name, a, b in zip(("body", "acc", "residual"), got, ref):
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), name
        assert torch.equal(bits(a)[~nan], bits(b)[~nan]), name


def static_frame(gated):
    """A hand-made frame: a static body (id 0) moving at -0.0 under 24
    contact rows of both normal directions, as a ground under a row of
    boxes, plus rows between the boxes and a self pair; numpy-made rows
    and warm impulses."""
    rng = np.random.default_rng(11)
    n, c_cap, num = 16, 40, 34
    body = np.zeros((n, 8), np.float32)
    body[:, 0:3] = rng.normal(0.0, 0.5, (n, 3))
    body[0, 0:3] = -0.0
    body[1:, 3] = rng.uniform(0.5, 2.0, n - 1)
    body[1:, 4] = rng.uniform(0.5, 2.0, n - 1)
    b1 = np.zeros(c_cap, np.int32)
    b2 = np.zeros(c_cap, np.int32)
    b2[:24] = rng.integers(1, n, 24)         # ground rows, boxes repeated
    b1[24:33] = rng.integers(1, n, 9)
    b2[24:33] = rng.integers(1, n, 9)
    b1[33] = b2[33] = 5                      # a self pair
    ang = rng.uniform(0.0, 2 * np.pi, c_cap)
    con = np.zeros((c_cap, 12), np.float32)
    con[:, 0], con[:, 1] = np.cos(ang), np.sin(ang)
    con[:, 2:6] = rng.normal(0.0, 0.5, (c_cap, 4))
    con[:, 6:8] = rng.uniform(0.2, 1.0, (c_cap, 2))
    con[:, 8] = rng.uniform(0.2, 0.8, c_cap)
    con[:, 9] = rng.uniform(0.0, 0.3, c_cap)
    con[:, 10] = rng.uniform(0.0, 0.05, c_cap)
    con[:, 11] = rng.normal(0.0, 0.1, c_cap)
    warm = np.zeros((c_cap, 2), np.float32)
    warm[:, 0] = rng.uniform(0.0, 0.3, c_cap)
    warm[:, 1] = rng.uniform(-0.05, 0.05, c_cap)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x).reshape(-1))
    return dict(body_flat=f(body), b1=torch.from_numpy(b1),
                b2=torch.from_numpy(b2), con_flat=f(con), warm_flat=f(warm),
                num_contacts=torch.tensor(num, dtype=torch.int32),
                vel_iters=10, pos_iters=6, num_joints=None, c_cap=c_cap,
                tols=torch.tensor([0.3, 0.05]) if gated else None)


def bridge_net(gated):
    """A jointed frame built by the port on the CPU, no settle: a plank
    bridge (revolute rows) loaded with boxes that overlap its planks
    (contact rows), with a net of boxes hung under it on distance rows;
    numpy-made warm impulses on every live row."""
    cfg = SimConfig(max_bodies=32, max_pairs=128, max_joints=32,
                    broadphase="sap_grid", sap_window=16,
                    solver_backend="pallas")
    sb = scenes.bridge(cfg, 8)
    planks = list(range(3, 11))
    for k, x in enumerate((-3.1, -0.4, 0.35, 2.7)):
        sb.add_box((x, 6.42 + 0.75 * (k == 2)), (0.4, 0.4), friction=0.4)
    prev = planks[1]
    for k, x in enumerate((-3.0, -1.4, 0.2, 1.8, 3.0)):
        node = sb.add_box((x, 4.2 - 0.3 * k), (0.25, 0.25), friction=0.3)
        sb.add_distance_joint(prev, node, (x, 6.0), (x, 4.2 - 0.3 * k))
        prev = node
    sb.add_distance_joint(prev, planks[-2], (3.0, 3.0), (3.0, 6.0))
    args = solve_inputs(sb.build("cpu"), cfg)
    rng = np.random.default_rng(5)
    c, num = args["c_cap"], int(args["num_contacts"])
    numj = int(args["num_joints"])
    warm = args["warm_flat"].reshape(-1, 2).clone()
    warm[:num, 0] = torch.from_numpy(rng.uniform(0.0, 0.3, num)
                                     .astype(np.float32))
    warm[:num, 1] = torch.from_numpy(rng.uniform(-0.05, 0.05, num)
                                     .astype(np.float32))
    warm[c:c + numj] = torch.from_numpy(rng.normal(0.0, 0.1, (numj, 2))
                                        .astype(np.float32))
    kinds = args["con_flat"].reshape(-1, 12)[c:c + numj, 11]
    assert num >= 4 and (kinds == 1.0).sum() == 9 and (kinds == 2.0).sum() == 6
    return dict(args, warm_flat=warm.reshape(-1),
                tols=torch.tensor([2e-3, 2e-3]) if gated else None)


FRAMES = {
    "pile": lambda gated: packed_inputs(1, gated),
    "bridge_net": bridge_net,
    "static_neg_zero": static_frame,
}


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_levels_solve_equals_serial_to_the_bit(frame, gated):
    args = FRAMES[frame](gated)
    ref = solve_contacts_streamed_plain(**args)
    got = solve_contacts_levels_plain(**args)
    assert_bit_equal(got, ref)
    n = args["body_flat"].numel() // 8
    lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                      args["num_joints"], args["c_cap"], n)
    # the schedule is shorter than the walk: some rows are independent
    assert 0 < lv["n_levels"] < lv["slots"].numel()
    if frame == "static_neg_zero":
        # the static body stays at rest; and the bits depend on the order of
        # the rows: the same rows walked in reverse give other bits
        assert torch.equal(ref[0].reshape(n, 8)[0, :3], torch.zeros(3))
        num = int(args["num_contacts"])
        rev = torch.arange(num - 1, -1, -1)
        flipped = dict(args, b1=args["b1"][rev], b2=args["b2"][rev],
                       con_flat=args["con_flat"].reshape(-1, 12)[rev]
                       .reshape(-1),
                       warm_flat=args["warm_flat"].reshape(-1, 2)[rev]
                       .reshape(-1), c_cap=num)
        other = solve_contacts_streamed_plain(**flipped)
        assert not torch.equal(bits(other[0]), bits(ref[0]))
    if gated:
        ungated = solve_contacts_streamed_plain(**dict(args, tols=None))
        assert not torch.equal(bits(ungated[0]), bits(ref[0]))  # a gate fired


def test_cpu_tensors_take_the_serial_plain_version():
    """On CPU tensors the wrapper runs the serial plain version and
    launches nothing; the pre-pass alone is the kernel's, CUDA only."""
    args = static_frame(False)
    before = solve_contacts_streamed.launches
    got = solve_contacts_streamed(**args)
    assert solve_contacts_streamed.launches == before
    assert_bit_equal(got, solve_contacts_streamed_plain(**args))
    with pytest.raises(ValueError, match="CUDA"):
        prepass(**args)
    with pytest.raises(ValueError, match="CUDA"):
        solve_in_device_memory(**args)


@pytest.mark.parametrize("n, smem_last, smem_cols", [
    (16_384, True, True),     # the 10k pile's cap
    (17_408, True, True),     # bench row E at 64 envs
    (19_285, True, True),     # the most bodies whose columns fit
    (19_286, True, False),
    (32_768, True, False),    # the 20k pile's cap
    (51_200, True, False),    # the most bodies whose last levels fit
    (51_201, False, False),
])
def test_placement_follows_one_block_of_shared_memory(n, smem_last,
                                                      smem_cols):
    """The kernel's per-body arrays go to shared memory where they fit one
    block's 227 KB (less 1 KB of its own for the columns): 4 N bytes of
    last levels, 12 N bytes of working columns."""
    assert placement(n) == dict(smem_last=smem_last, smem_cols=smem_cols)


# ---- free rows ------------------------------------------------------------

def ids(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("b1, b2, n, full, freed", [
    # eight boxes on one ground row (0): a chain of 8, then one level
    ([0] * 8, list(range(1, 9)), 9, 8, 1),
    # each box with two ground points, the ground second: 12, then 2
    (list(range(1, 7)) * 2, [0] * 12, 7, 12, 2),
    # two free rows (0 and 5) under one row of boxes, ground points first
    ([0, 0, 5, 5, 0, 5], [1, 2, 3, 4, 3, 2], 6, 3, 2),
    # ground points, then contacts between the boxes: the boxes' chain
    # stays, the ground adds nothing
    ([0, 0, 0, 0, 1, 2, 3], [1, 2, 3, 4, 2, 3, 4], 5, 5, 4),
])
def test_free_ground_row_levels(b1, b2, n, full, freed):
    """A row shared by every ground contact chains them all when it is a
    node; as a free row (row 0, and row 5 where n > 5 and it is visited) it
    adds nothing: the levels follow the recurrence with that row's last
    level 0 throughout."""
    r = len(b1)
    free = torch.zeros(n, dtype=torch.bool)
    free[[b for b in (0, 5) if b < n and b in b1 + b2]] = True
    lv = visit_levels(ids(b1), ids(b2), ids(r), None, r, n)
    assert lv["n_levels"] == full
    fl = visit_levels(ids(b1), ids(b2), ids(r), None, r, n, free)
    ref = serial_levels(b1, b2, r, None, r, n,
                        set(torch.nonzero(free).flatten().tolist()))
    assert fl["level"].tolist() == [v[3] for v in ref]
    assert fl["n_levels"] == freed
    # no two visits of a level share a row that is not free
    order, off = fl["order"].tolist(), fl["offsets"].tolist()
    for lvl in range(freed):
        rows = [b for q in order[off[lvl]:off[lvl + 1]]
                for b in {ref[q][1], ref[q][2]} if not free[b]]
        assert len(rows) == len(set(rows))


@functools.lru_cache(maxsize=None)
def _settled_pile():
    """K1's inputs at a settled 60-box pile on the CPU (60 frames of the
    colored solve, then the frame K1 would run, with the contact cache's
    warm impulses)."""
    cfg = SimConfig(max_bodies=128, max_pairs=512, broadphase="sap_grid",
                    sap_window=32)
    st = rollout(scenes.pile(cfg, 60, seed=0).build("cpu"), cfg, 60)
    return solve_inputs(st, cfg.replace(solver_backend="pallas"), "rows")


FREE_FRAMES = {
    "settled_pile": lambda: dict(_settled_pile()),
    "pile": lambda: packed_inputs(1, False),
    "bridge_net": lambda: bridge_net(False),
}


def walk_args(args, free):
    """``levels_walk``'s arguments for K1's inputs, the levels over
    ``free`` (None: the full graph)."""
    n = args["body_flat"].numel() // 8
    r = args["b1"].numel()
    c_cap = r if args["c_cap"] is None else args["c_cap"]
    lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                      args["num_joints"], c_cap, n, free)
    return (args["body_flat"].reshape(n, 8), args["con_flat"].reshape(r, 12),
            args["warm_flat"].reshape(r, 2), lv, lv["slots"] >= c_cap,
            args["vel_iters"], args["pos_iters"], args["tols"])


@pytest.mark.parametrize("frame", sorted(FREE_FRAMES))
def test_freed_walk_equals_serial_with_the_flag_clear(frame):
    """Over the levels with the table's free rows (the ground, a static
    at rest) the level walk flags no write and equals the serial walk to
    the bit, in fewer levels or as many."""
    args = FREE_FRAMES[frame]()
    free = free_rows(args["body_flat"])
    walk = walk_args(args, free)
    lv = walk[3]
    freed = int((free[lv["i"]] | free[lv["j"]]).sum())
    assert freed > 0
    *got, flagged = levels_walk(*walk)
    assert not bool(flagged)
    assert_bit_equal(got, solve_contacts_streamed_plain(**args))
    assert lv["n_levels"] <= walk_args(args, None)[3]["n_levels"]
    if frame == "settled_pile":
        assert lv["n_levels"] < walk_args(args, None)[3]["n_levels"]


def plant(args, value):
    """K1's inputs with ``value`` as the normal warm impulse of the first
    live contact on a free row."""
    free = free_rows(args["body_flat"])
    num = int(args["num_contacts"])
    n = args["body_flat"].numel() // 8
    on_free = (free[args["b1"][:num].long().clamp(0, n - 1)]
               | free[args["b2"][:num].long().clamp(0, n - 1)])
    slot = int(torch.nonzero(on_free)[0])
    warm = args["warm_flat"].clone()
    warm[2 * slot] = value
    return dict(args, warm_flat=warm)


@pytest.mark.parametrize("value", [float("inf"), float("-inf"),
                                   float("nan")], ids=["inf", "-inf", "nan"])
@pytest.mark.parametrize("frame", ["settled_pile", "pile"])
def test_planted_warm_impulse_falls_back(frame, value):
    """A warm impulse that is not finite on a ground contact writes NaN to
    the free ground row: the freed walk flags it, and the fallback (the
    walk again over the full graph) equals the serial walk to the bit."""
    args = plant(FREE_FRAMES[frame](), value)
    free = free_rows(args["body_flat"])
    assert bool(levels_walk(*walk_args(args, free))[3])
    *got, fell_back = freed_walk(*walk_args(args, free))
    assert fell_back
    ref = solve_contacts_streamed_plain(**args)
    assert bool(torch.isnan(ref[0]).any())
    assert_bit_equal(got, ref)
    assert_bit_equal(solve_contacts_levels_plain(**args), ref)


@pytest.mark.parametrize("col", range(8))
def test_negative_zero_keeps_a_static_row_a_node(col):
    """A static row with -0.0 in any column is no free row: its writes may
    change its bits, so it stays a node, the levels those of the full
    graph, and the level walk equals the serial walk to the bit."""
    args = _settled_pile()
    n = args["body_flat"].numel() // 8
    free = free_rows(args["body_flat"])
    lv = walk_args(args, free)[3]
    visited = torch.unique(torch.cat([lv["i"], lv["j"]]))
    static = visited[free[visited]]
    assert static.numel() >= 1
    table = args["body_flat"].reshape(n, 8).clone()
    table[static, col] = -0.0
    args = dict(args, body_flat=table.reshape(-1))
    free = free_rows(args["body_flat"])
    assert not bool(free[static].any())
    walk = walk_args(args, free)
    assert walk[3]["n_levels"] == walk_args(args, None)[3]["n_levels"]
    *got, flagged = levels_walk(*walk)
    assert not bool(flagged)
    assert_bit_equal(got, solve_contacts_streamed_plain(**args))
