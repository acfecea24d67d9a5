"""The level schedule of the tiled solves K3 and K5: their pre-pass as torch
operations (``slab_levels``) against the recurrence walked over the slab
walk in this file, the levels plain versions against the serial plain
versions to the bit (on a pile over three slabs, a jointed frame and a
hand-made frame whose zero rows start at -0.0), the free rows (the zero
blocks, halo and padding: all +0.0) as no nodes of the schedule, with the
fallback over the full graph, and the placement of the kernels' per-row
arrays by the table's rows."""

import functools

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from phyx_tpu_torch import scenes, tiling
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.convert import state_from_numpy
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    free_rows, freed_walk, levels_walk, placement)
from phyx_tpu_torch.kernels.contact_solver_tiled import (
    slab_levels, solve_contacts_tiled, solve_contacts_tiled2,
    solve_contacts_tiled2_levels_plain, solve_contacts_tiled2_plain,
    solve_contacts_tiled_levels_plain, solve_contacts_tiled_plain,
    MAX_SLABS, solve_tiled_placed, tiled_placements, tiled_prepass)
from phyx_tpu_torch.step import rollout, solve_inputs
from test_torch_levels import assert_bit_equal, bits
from test_torch_tiled import (JOINTED, TILED, gate_thresholds, jointed_state,
                              pile_state, with_warm)

torch.set_num_threads(1)


def serial_slab_levels(b12, n_slabs, stride, window, npad, cum=None,
                       counts=None, j_slots=0, free=()):
    """The slab walk, walked: slab by slab its contact slots, then its
    joint slots (K3: ``cum`` clamped into [0, S], each slab starting no
    earlier than the one before ended; K5: each count clamped into its
    budget), a slot's rows at s*stride + its local rows clamped into
    [0, window), and level = 1 + max(last[i], last[j]) over table rows, a
    free row's last level 0 throughout.  Returns [(slot, i, j, joint,
    level)]."""
    s = len(b12) // 2
    segments, end = [], 0
    for k in range(n_slabs):
        if cum is not None:
            lo = min(max(cum[k], 0), s)
            spans = [(lo, min(max(cum[k + 1], lo), s)), (0, 0)]
        else:
            per = s // n_slabs
            c0, j0 = k * per, k * per + per - j_slots
            spans = [(c0, c0 + min(max(counts[k], 0), per - j_slots)),
                     (j0, j0 + min(max(counts[n_slabs + k], 0), j_slots))]
        for h, (a, b) in enumerate(spans):
            a = max(a, end)
            b = max(b, a)
            segments.append((k, a, b, h == 1))
            end = b
    last = [0] * npad
    out = []
    for k, a, b, joint in segments:
        for slot in range(a, b):
            i, j = (k * stride + min(max(x, 0), window - 1)
                    for x in b12[2 * slot:2 * slot + 2])
            lvl = 1 + max(last[i], last[j])
            for b in (i, j):
                if b not in free:
                    last[b] = lvl
            out.append((slot, i, j, joint, lvl))
    return out


def layout_args(b12, n_slabs, stride, window, cum=None, counts=None,
                j_slots=0):
    """A wrapper's arguments for the layout (zero table and rows: the
    pre-pass reads only the layout)."""
    t = lambda x: torch.tensor(x, dtype=torch.int32)
    s = len(b12) // 2
    npad = (n_slabs - 1) * stride + window
    args = dict(body_flat=torch.zeros(npad * 8), b12=t(b12),
                cw=torch.zeros(s * 14), vel_iters=1, pos_iters=1,
                n_slabs=n_slabs, slab_stride=stride, window_rows=window)
    if cum is not None:
        return dict(args, cum=t(cum))
    return dict(args, slab_counts=t(counts), j_slots=j_slots)


def check_layout(b12, n_slabs, stride, window, cum=None, counts=None,
                 j_slots=0):
    npad = (n_slabs - 1) * stride + window
    ref = serial_slab_levels(b12, n_slabs, stride, window, npad, cum,
                             counts, j_slots)
    lv = slab_levels(layout_args(b12, n_slabs, stride, window, cum, counts,
                                 j_slots))
    assert lv["slots"].tolist() == [v[0] for v in ref]
    assert lv["i"].tolist() == [v[1] for v in ref]
    assert lv["j"].tolist() == [v[2] for v in ref]
    assert lv["joint"].tolist() == [v[3] for v in ref]
    level = lv["level"].tolist()
    assert level == [v[4] for v in ref]
    assert lv["n_levels"] == max(level, default=0)
    # no slot twice in a pass, and each level's visits on disjoint rows
    assert len(set(lv["slots"].tolist())) == len(ref)
    order, offsets = lv["order"].tolist(), lv["offsets"].tolist()
    for lvl in range(lv["n_levels"]):
        members = order[offsets[lvl]:offsets[lvl + 1]]
        assert members == sorted(members)
        rows = [r for q in members for r in {ref[q][1], ref[q][2]}]
        assert len(rows) == len(set(rows))
    return lv


@pytest.mark.parametrize("case", [
    # K3: two slabs of stride 4, window 6 (halo rows 4-5 of slab 0 are
    # slab 1's rows 0-1 in the table: one node each), local ids out of the
    # window on both sides
    dict(b12=[0, 5, 4, 5, 7, -1, 0, 1, 1, 4, 9, 2, 0, 0],
         n_slabs=2, stride=4, window=6, cum=[0, 3, 7]),
    # K3: cum past the slots, a negative start, an empty middle slab
    dict(b12=[1, 2, 3, 1, 0, 2, 2, 3, 1, 1, 0, 3],
         n_slabs=3, stride=2, window=4, cum=[-2, 2, 2, 40]),
    # K3: a cum that runs backwards: the third slab starts where the
    # second ended
    dict(b12=[0, 1, 1, 2, 2, 3, 0, 2, 1, 3, 0, 3],
         n_slabs=3, stride=2, window=4, cum=[0, 4, 1, 6]),
    # K5: budgets of 3 contact and 1 joint slot a slab, negative and
    # overflowing counts
    dict(b12=[0, 1, 1, 2, 2, 3, 0, 3, 3, 4, 4, 5, 5, 0, 1, 2],
         n_slabs=2, stride=3, window=6, counts=[5, -1, 1, 2], j_slots=1),
    # K5: no joint slots, every slab full
    dict(b12=[0, 1, 2, 3, 1, 2, 3, 0, 0, 2, 1, 3],
         n_slabs=3, stride=2, window=4, counts=[2, 2, 2, 0, 0, 0]),
])
def test_slab_levels_on_hand_made_layouts(case):
    check_layout(**case)


@st.composite
def slab_layouts(draw):
    n_slabs = draw(st.integers(1, 4))
    stride = draw(st.integers(1, 5))
    window = stride + draw(st.integers(0, 4))          # halo overlap
    routed = draw(st.booleans())
    if routed:
        j_slots = draw(st.integers(0, 2))
        per = j_slots + draw(st.integers(1, 4))
        s = n_slabs * per
    else:
        j_slots = 0
        s = draw(st.integers(0, 16))
    ids = st.integers(-2, window + 1)                  # out of the window
    b12 = draw(st.lists(ids, min_size=2 * s, max_size=2 * s))
    kw = dict(b12=b12, n_slabs=n_slabs, stride=stride, window=window)
    if routed:
        counts = draw(st.lists(st.integers(-2, per + 2), min_size=2 * n_slabs,
                               max_size=2 * n_slabs))
        return dict(kw, counts=counts, j_slots=j_slots)
    # a cumsum of counts (mostly), from a start that may be negative, that
    # may run past the slots, sometimes stepping back
    cum = [draw(st.integers(-2, 2))]
    for _ in range(n_slabs):
        cum.append(cum[-1] + draw(st.integers(-1, 6)))
    return dict(kw, cum=cum)


@settings(max_examples=150, deadline=None)
@given(slab_layouts())
@example(dict(b12=[], n_slabs=1, stride=1, window=1, cum=[0, 0]))
@example(dict(b12=[0, 0, 0, 0], n_slabs=2, stride=1, window=1,
              counts=[1, 1, 0, 0], j_slots=0))
def test_slab_levels_follow_the_recurrence(layout):
    check_layout(**layout)


# the 300-box pile over three slabs (128 bodies a slab, windows of 512
# rows; chip_smoke.py's small tiled frame)
THREE_SLABS = dict(TILED, max_bodies=512)


def pile_frame(path, gated):
    cfg = SimConfig(**THREE_SLABS)
    st = state_from_numpy(pile_state(THREE_SLABS, 300, 6), "cpu")
    return gate_thresholds(with_warm(solve_inputs(st, cfg, path), 6), gated)


def jointed_frame(gated):
    cfg = SimConfig(**JOINTED)
    st = state_from_numpy(jointed_state(JOINTED, seed=1), "cpu")
    return gate_thresholds(with_warm(solve_inputs(st, cfg, "tiled"), 1),
                           gated)


def zero_rows_frame(path, gated):
    """A hand-made two-slab table whose zero blocks' rows and a static row
    start at -0.0 (inverse masses 0), with numpy-made rows: slots hit the
    zero rows many times, both normal directions, and some local ids fall
    out of the window."""
    rng = np.random.default_rng(21)
    stride, window, n_slabs = 8, 12, 2
    npad = (n_slabs - 1) * stride + window
    body = np.zeros((npad, 8), np.float32)
    body[:, 0:3] = rng.normal(0.0, 0.5, (npad, 3))
    body[:, 3:5] = rng.uniform(0.5, 2.0, (npad, 2))
    zero = [0, 1, 8, 9, 5]                    # zero blocks, a static row
    body[zero, 0:5] = 0.0
    body[zero, 0:3] = -0.0
    per = 20
    s = n_slabs * per
    b12 = rng.integers(-1, window + 1, (s, 2)).astype(np.int32)
    b12[::3, 0] = rng.choice([0, 1], len(b12[::3]))
    ang = rng.uniform(0.0, 2 * np.pi, s)
    cw = np.zeros((s, 14), np.float32)
    cw[:, 0], cw[:, 1] = np.cos(ang), np.sin(ang)
    cw[:, 2:6] = rng.normal(0.0, 0.5, (s, 4))
    cw[:, 6:8] = rng.uniform(0.2, 1.0, (s, 2))
    cw[:, 8] = rng.uniform(0.2, 0.8, s)
    cw[:, 9] = rng.uniform(0.0, 0.3, s)
    cw[:, 10] = rng.uniform(0.0, 0.05, s)
    cw[:, 11] = rng.normal(0.0, 0.1, s)
    cw[:, 12] = rng.uniform(0.0, 0.3, s)
    cw[:, 13] = rng.uniform(-0.05, 0.05, s)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x).reshape(-1))
    args = dict(body_flat=f(body), b12=f(b12), cw=f(cw), vel_iters=6,
                pos_iters=3, n_slabs=n_slabs, slab_stride=stride,
                window_rows=window,
                tols=torch.tensor([0.3, 0.05]) if gated else None)
    if path == "tiled2":
        return dict(args, cum=torch.tensor([0, 17, 37], dtype=torch.int32))
    return dict(args, slab_counts=torch.tensor([20, 14, 0, 0],
                                               dtype=torch.int32))


FRAMES = {
    "pile_k3": lambda gated: pile_frame("tiled2", gated),
    "pile_k5": lambda gated: pile_frame("tiled", gated),
    "jointed_k5": jointed_frame,
    "zero_rows_k3": lambda gated: zero_rows_frame("tiled2", gated),
    "zero_rows_k5": lambda gated: zero_rows_frame("tiled", gated),
}


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_levels_plain_equals_serial_plain_to_the_bit(frame, gated):
    args = FRAMES[frame](gated)
    k3 = "cum" in args
    serial = solve_contacts_tiled2_plain if k3 else solve_contacts_tiled_plain
    levels = (solve_contacts_tiled2_levels_plain if k3
              else solve_contacts_tiled_levels_plain)
    ref = serial(**args)
    assert_bit_equal(levels(**args), ref)
    lv = slab_levels(args)
    # the schedule is shorter than the walk: some visits are independent
    assert 0 < lv["n_levels"] < lv["slots"].numel()
    if frame.startswith("pile"):
        # every slab holds visits, and slabs share halo rows
        slab = torch.div(lv["i"], args["slab_stride"], rounding_mode="floor")
        assert len(set(slab.tolist())) >= 3
    if frame == "jointed_k5":
        assert bool(lv["joint"].any()) and not bool(lv["joint"].all())
    if frame.startswith("zero_rows"):
        # the zero rows keep their -0.0 only in the serial order: the same
        # slots walked in reverse give other bits
        n = args["b12"].numel() // 2
        rev = torch.arange(n - 1, -1, -1)
        flipped = dict(args, b12=args["b12"].reshape(-1, 2)[rev].reshape(-1),
                       cw=args["cw"].reshape(-1, 14)[rev].reshape(-1))
        assert not torch.equal(bits(serial(**flipped)[0]), bits(ref[0]))
    if gated:
        ungated = serial(**dict(args, tols=None))
        assert not torch.equal(bits(ungated[0]), bits(ref[0]))  # a gate fired


def test_cpu_tensors_take_the_serial_plain_version():
    """On CPU tensors the wrappers run the serial plain versions and launch
    nothing; the forced placements and the pre-pass alone are the
    kernels', CUDA only."""
    for path, wrapper, serial in (
            ("tiled2", solve_contacts_tiled2, solve_contacts_tiled2_plain),
            ("tiled", solve_contacts_tiled, solve_contacts_tiled_plain)):
        args = zero_rows_frame(path, False)
        before = wrapper.launches
        assert_bit_equal(wrapper(**args), serial(**args))
        assert wrapper.launches == before
        with pytest.raises(ValueError, match="CUDA"):
            tiled_prepass(args)
        with pytest.raises(ValueError, match="CUDA"):
            solve_tiled_placed(args, smem_last=False, smem_cols=False)


def test_wrappers_refuse_more_slabs_than_the_map_holds():
    """The slab visit map's table (4 n_slabs + 1 ints) sits in the
    pre-pass's shared memory beside the last-level array: at most
    MAX_SLABS slabs."""
    n_slabs = MAX_SLABS + 1
    args = layout_args([0, 1] * n_slabs, n_slabs, 1, 2,
                       counts=[1] * n_slabs + [0] * n_slabs)
    with pytest.raises(ValueError, match="slabs"):
        solve_contacts_tiled(**args)
    args = layout_args([0, 1] * MAX_SLABS, MAX_SLABS, 1, 2,
                       counts=[1] * MAX_SLABS + [0] * MAX_SLABS)
    assert_bit_equal(solve_contacts_tiled(**args),
                     solve_contacts_tiled_plain(**args))


def _npad(max_bodies, **kw):
    cfg = SimConfig(max_bodies=max_bodies, **kw)
    return tiling.slab_dims(cfg, max_bodies)[5]


@pytest.mark.parametrize("what, npad, smem_last, smem_cols", [
    # chip_smoke.py's small tiled frames: both arrays in shared memory
    ("small", _npad(512, tile_stride=256, tile_halo=256), True, True),
    ("most columns", 19_285, True, True),
    ("columns past a block", 19_286, True, False),
    # the 20k pile (cap 32,768) and bench row E at 128 envs (cap 33,792):
    # 3 slabs, 51,200 rows, the last-level array just fits
    ("pile20k", _npad(32_768), True, False),
    ("envs128", _npad(33_792), True, False),
    ("most last levels", 51_200, True, False),
    ("last levels past a block", 51_201, False, False),
    # bench row E at 1024 envs (cap 264,192): 17 slabs, 280,576 rows
    ("envs1024", _npad(264_192), False, False),
])
def test_tiled_placement_by_the_table_rows(what, npad, smem_last,
                                           smem_cols):
    """The tiled kernels' last-level array (4 npad bytes) and working
    columns (12 npad bytes) go to shared memory where they fit one block,
    by K1's ``placement`` of the table's rows, else to device memory;
    every other placement the size allows is listed after the wrapper's,
    for checking on the card."""
    if what in ("pile20k", "envs128"):
        assert npad == 51_200
    if what == "envs1024":
        assert npad == 280_576
    first = dict(smem_last=smem_last, smem_cols=smem_cols)
    assert placement(npad) == first
    places = tiled_placements(npad)
    assert places[0] == first
    assert len(places) == len({tuple(p.items()) for p in places})
    assert {p["smem_last"] for p in places} == {False, smem_last}
    assert {p["smem_cols"] for p in places} == {False, smem_cols}


# ---- free rows ------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # two slabs of stride 4, window 6: each slab's zero row (0, 4) and
    # the padding (row 8, 9) free; slab 0 reaches row 4 as a halo row
    dict(b12=[0, 1, 0, 2, 0, 3, 1, 4, 0, 1, 0, 2, 0, 3, 5, 1],
         n_slabs=2, stride=4, window=6, cum=[0, 4, 8], free=[0, 4, 8, 9]),
    # every contact of slab 0 on its zero row: a chain of 6, then 1
    dict(b12=[0, 1, 2, 0, 0, 3, 4, 0, 0, 5, 0, 6],
         n_slabs=1, stride=8, window=8, cum=[0, 6], free=[0], levels=(6, 1)),
    # K5 with joint slots, a free row in each slab's window
    dict(b12=[0, 1, 0, 2, 1, 2, 2, 0, 0, 3, 3, 0, 1, 0, 2, 3],
         n_slabs=2, stride=3, window=4, counts=[3, 3, 1, 1], j_slots=1,
         free=[0, 3]),
])
def test_slab_levels_with_free_rows(case):
    """``slab_levels`` over free rows follows the slab walk's recurrence
    with those rows' last levels 0 throughout; visits of a level share no
    row that is not free."""
    case = dict(case)
    free_ids, want = case.pop("free"), case.pop("levels", None)
    npad = (case["n_slabs"] - 1) * case["stride"] + case["window"]
    free = torch.zeros(npad, dtype=torch.bool)
    free[free_ids] = True
    ref = serial_slab_levels(**case, npad=npad, free=set(free_ids))
    args = layout_args(**case)
    lv = slab_levels(args, free)
    assert lv["level"].tolist() == [v[4] for v in ref]
    full = slab_levels(args)["n_levels"]
    assert lv["n_levels"] <= full
    if want is not None:
        assert (full, lv["n_levels"]) == want
    order, off = lv["order"].tolist(), lv["offsets"].tolist()
    for lvl in range(lv["n_levels"]):
        rows = [r for q in order[off[lvl]:off[lvl + 1]]
                for r in {ref[q][1], ref[q][2]} if not free[r]]
        assert len(rows) == len(set(rows))


@functools.lru_cache(maxsize=None)
def _settled_state():
    """A 300-box pile over three slabs settled 40 frames on the CPU by the
    colored solve (the tiled solves' inputs then come with the contact
    cache's warm impulses)."""
    cfg = SimConfig(**THREE_SLABS)
    st = scenes.pile(cfg, 300, seed=0).build("cpu")
    return rollout(st, cfg.replace(solver_backend="xla"), 40)


def settled_frame(path):
    return solve_inputs(_settled_state(), SimConfig(**THREE_SLABS), path)


FREE_FRAMES = {
    "settled_k3": lambda: settled_frame("tiled2"),
    "settled_k5": lambda: settled_frame("tiled"),
    "jointed_k5": lambda: jointed_frame(False),
}


def tiled_walk(args, free):
    """``levels_walk``'s arguments for a tiled solve's inputs, the levels
    over ``free`` (None: the full graph)."""
    lv = slab_levels(args, free)
    rows = args["cw"].reshape(-1, 14)
    return (args["body_flat"].reshape(-1, 8), rows[:, :12], rows[:, 12:], lv,
            lv["joint"], args["vel_iters"], args["pos_iters"],
            args.get("tols"))


def serial_of(args):
    return (solve_contacts_tiled2_plain if "cum" in args
            else solve_contacts_tiled_plain)(**args)


@pytest.mark.parametrize("frame", sorted(FREE_FRAMES))
def test_freed_walk_equals_serial_with_the_flag_clear(frame):
    """Over the levels with the table's free rows (each slab's zero block,
    where statics at rest are remapped, the halo and the padding) the level
    walk flags no write and equals the serial walk to the bit."""
    args = FREE_FRAMES[frame]()
    free = free_rows(args["body_flat"])
    walk = tiled_walk(args, free)
    lv = walk[3]
    assert int((free[lv["i"]] | free[lv["j"]]).sum()) > 0
    *got, flagged = levels_walk(*walk)
    assert not bool(flagged)
    assert_bit_equal(got, serial_of(args))
    full = tiled_walk(args, None)[3]["n_levels"]
    assert lv["n_levels"] <= full
    if frame.startswith("settled"):
        assert lv["n_levels"] < full


@pytest.mark.parametrize("frame", ["settled_k3", "settled_k5"])
def test_planted_warm_impulse_falls_back(frame):
    """An infinite warm impulse on a contact with a zero-block row writes
    NaN to that free row: the freed walk flags it, and the fallback (the
    walk again over the full graph) equals the serial walk to the bit."""
    args = FREE_FRAMES[frame]()
    free = free_rows(args["body_flat"])
    lv = slab_levels(args, free)
    slot = int(lv["slots"][free[lv["i"]] | free[lv["j"]]][0])
    cw = args["cw"].reshape(-1, 14).clone()
    cw[slot, 12] = float("inf")
    args = dict(args, cw=cw.reshape(-1))
    assert bool(levels_walk(*tiled_walk(args, free))[3])
    *got, fell_back = freed_walk(*tiled_walk(args, free))
    assert fell_back
    ref = serial_of(args)
    assert bool(torch.isnan(ref[0]).any())
    assert_bit_equal(got, ref)


@pytest.mark.parametrize("col", [0, 2, 4, 7])
def test_negative_zero_keeps_zero_rows_nodes(col):
    """Zero-block rows with -0.0 in a column are no free rows: the levels
    are the full graph's and the level walk equals the serial walk."""
    args = settled_frame("tiled2")
    free = free_rows(args["body_flat"])
    lv = slab_levels(args, free)
    rows = torch.unique(torch.cat([lv["i"], lv["j"]]))
    rows = rows[free[rows]]
    table = args["body_flat"].reshape(-1, 8).clone()
    table[rows, col] = -0.0
    args = dict(args, body_flat=table.reshape(-1))
    free = free_rows(args["body_flat"])
    walk = tiled_walk(args, free)
    assert walk[3]["n_levels"] == tiled_walk(args, None)[3]["n_levels"]
    *got, flagged = levels_walk(*walk)
    assert not bool(flagged)
    assert_bit_equal(got, serial_of(args))
