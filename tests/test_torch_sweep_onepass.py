"""The one-pass emission sweeps' schedules on the CPU: K6's
(``sweep_emit_v2_onepass_plain``: tiles of 128 source rows against a
reached target chunk, 32-candidate batches, the sorted proof and its short walk,
slots from an exclusive scan over tiles and j-descending ranks) and K4's
(``sweep_emit_tiled_onepass_plain``: tiles of sweeps, their first slots
from an exclusive scan over tiles, the stage and the second walk of the
hits past it), each against the JAX package's kernel in interpret mode and
the port's plain version: the pair buffer, ``num`` and every counter
exact."""

import numpy as np
import pytest
import torch

from phyx_tpu.kernels.sweep import sweep_emit_v2 as jax_k6
from phyx_tpu_torch.broadphase import EMPTY
from phyx_tpu_torch.kernels.sweep import (CHUNK, sorted_chunks,
                                          sweep_emit_v2,
                                          sweep_emit_v2_onepass_plain,
                                          sweep_emit_v2_plain)
from phyx_tpu_torch.kernels.sweep_tiled import (
    STAGE_PAIRS, TILE_SWEEPS, sweep_emit_tiled_onepass_plain,
    sweep_emit_tiled_plain)
from test_torch_sweep import jax_sweep_emit, numpy_rows, port_sweep_args
from test_torch_sweep_emit import k6_args, run_jax, sweep_rows
from test_torch_sweep_warp import nan_rows

torch.set_num_threads(1)


def unsorted_rows(seed):
    """sweep_rows' multi-chunk pile with its active rows out of x order:
    a run of chunk 1 reversed and rows swapped across chunks 0 and 2, so
    some candidates that are not x-open come before hits."""
    aabb, order, dyn, na = sweep_rows(3072, 2500, seed, 120.0, True)
    order = order.copy()
    order[1100:1160] = order[1100:1160][::-1]
    rng = np.random.default_rng(seed)
    a = rng.choice(np.arange(1, 1000), 12, replace=False)
    b = rng.choice(np.arange(2100, 2500), 12, replace=False)
    order[a], order[b] = order[b], order[a].copy()
    return aabb, order, dyn, na


def nan_inside_rows(seed):
    """sweep_rows' pile with NaN in chunk 1's interior: a NaN lox (which
    closes no walk in the reference's chunked tests, so chunk 1 must be
    tested whole), a NaN hiy, and a NaN hix in chunk 2 (whose chunk bound
    is then NaN: source chunk 2 emits nothing)."""
    aabb, order, dyn, na = sweep_rows(3072, 2500, seed, 120.0, True)
    aabb = aabb.copy()
    for row, col in ((order[1500], 0), (order[1700], 3), (order[2200], 2)):
        aabb[row, col] = np.nan
    return aabb, order, dyn, na


# (rows, max_pairs, which chunks the proof must find sorted, overflows)
K6_CASES = {
    "sorted_ground": (lambda: sweep_rows(3072, 2500, 2, 120.0, True), 16384,
                      [True] * 3, False),
    "sorted_cut": (lambda: sweep_rows(3072, 2500, 2, 120.0, True), 256,
                   [True] * 3, True),
    "sorted_cut_one": (lambda: sweep_rows(2048, 1300, 3, 60.0, True), 1,
                       [True] * 2, True),
    "dense_one_chunk": (lambda: sweep_rows(1024, 400, 1, 12.0, False), 16384,
                        [True], False),
    "unsorted": (lambda: unsorted_rows(4), 32768, [False, False, False],
                 False),
    "unsorted_cut": (lambda: unsorted_rows(4), 1000, [False, False, False],
                     True),
    "nan_rows": (lambda: nan_rows(2048, 1900, 9), 32768, [False, True],
                 False),
    "nan_inside": (lambda: nan_inside_rows(5), 16384, [True, False, True],
                   False),
    "nact_0": (lambda: sweep_rows(2048, 0, 5, 60.0, True), 1024,
               [True, True], None),
}


def k6_tensors(args):
    aabb, order, dyn, na = args
    return ([torch.from_numpy(np.ascontiguousarray(x))
             for x in (aabb, order, dyn)]
            + [torch.tensor(na, dtype=torch.int32)])


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_schedule_matches_jax_and_plain(case):
    """K6's one-pass schedule writes the reference's buffer slot for slot
    (EMPTY from num on), with num and ovf exact, on sorted, unsorted and
    NaN rows and at cut budgets; its proof takes the short walk exactly on
    the chunks whose active rows are sorted and free of NaN lox."""
    make, max_pairs, proven, overflows = K6_CASES[case]
    args = k6_args(*make())
    ref = run_jax(jax_k6, args, max_pairs)
    tensors = k6_tensors(args)
    got = sweep_emit_v2_onepass_plain(*tensors, max_pairs)
    plain = sweep_emit_v2_plain(*tensors, max_pairs)
    for part, a, b, c in zip(("pi", "pj", "num", "ovf"), ref, got, plain):
        assert b.dtype == torch.int32, (part, b.dtype)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=part)
        np.testing.assert_array_equal(c.numpy(), b.numpy(), err_msg=part)
    assert got[4] == proven == sorted_chunks(tensors[0], tensors[3])
    num, ovf = int(ref[2]), int(ref[3])
    assert (ref[0][num:] == EMPTY).all()
    if overflows is None:
        assert num == ovf == 0
    else:
        assert (ovf > 0) == overflows and num > 0
        if overflows:
            assert num == max_pairs


def test_k6_short_walk_needs_the_proof():
    """On the unsorted rows some hits of a cell lie past its first
    candidate that is not x-open, so a walk stopped there without the
    proof would lose them."""
    aabb, order, dyn, na = unsorted_rows(4)
    box, d = aabb[order], dyn[order]
    lost = 0
    for k in range(na):
        for t in range(k // CHUNK, -(-na // CHUNK)):
            j = np.arange(max(t * CHUNK, k + 1), min((t + 1) * CHUNK, na))
            b = box[j]
            is_open = b[:, 0] <= box[k, 2]
            hit = (is_open & (b[:, 1] <= box[k, 3]) & (box[k, 1] <= b[:, 3])
                   & (d[j] + d[k] > 0))
            if (~is_open).any():
                lost += int(hit[int(np.argmax(~is_open)):].sum())
    assert lost > 0


def test_k6_wrapper_takes_plain_on_cpu():
    tensors = k6_tensors(k6_args(*sweep_rows(2048, 1300, 3, 60.0, True)))
    before = sweep_emit_v2.launches
    got = sweep_emit_v2(*tensors, 300)
    assert sweep_emit_v2.launches == before          # no kernel on the CPU
    for a, b in zip(got, sweep_emit_v2_plain(*tensors, 300)):
        assert torch.equal(a, b)
    assert tensors[1].numel() % CHUNK == 0


def dense_rows(seed, max_pairs):
    """One slab (K 1024, W 2048) whose first tile of sweeps is packed
    into 5 units of x with overlapping y: ~17,000 pairs in that tile, past
    its stage of ``STAGE_PAIRS``."""
    rng = np.random.default_rng(seed)
    K, W, nact, nfirst = 1024, 2048, 1100, TILE_SWEEPS
    xlo = np.sort(np.concatenate([rng.uniform(0.0, 5.0, nfirst),
                                  rng.uniform(5.0, 100.0, nact - nfirst)]))
    xhi = xlo + rng.uniform(0.5, 1.5, nact)
    ylo = rng.uniform(0.0, 2.0, nact)
    yhi = ylo + rng.uniform(1.0, 3.0, nact)
    pad = np.full(W - nact, np.inf)
    rows = np.stack([np.concatenate([c, pad]) for c in (xlo, ylo, xhi, yhi)])
    dyn = np.concatenate([(rng.random(nact) < 0.7), np.zeros(W - nact)])
    order = np.concatenate([rng.permutation(nact),
                            np.full(W - nact, np.iinfo(np.int32).max)])
    return dict(rows=torch.from_numpy(rows.astype(np.float32)),
                dyn=torch.from_numpy(dyn.astype(np.int32)),
                order=torch.from_numpy(order.astype(np.int32)),
                nact=torch.tensor(nact, dtype=torch.int32),
                max_pairs=max_pairs, n_slabs=1, slab_stride=K,
                window_rows=W, truex=None)


def env_args(name, exact_x):
    args = port_sweep_args(name)[0]
    return args if exact_x else dict(args, truex=None)


# (sweep arguments, stage size, what the case must show)
K4_CASES = {
    "flat": (lambda: env_args("flat", False), STAGE_PAIRS, "clean"),
    "banded_exact_x": (lambda: env_args("banded", True), STAGE_PAIRS,
                       "clean"),
    "banded_no_exact_x": (lambda: env_args("banded", False), STAGE_PAIRS,
                          "clean"),
    "segmented_exact_x": (lambda: env_args("segmented", True), STAGE_PAIRS,
                          "clean"),
    "ovf_window": (lambda: numpy_rows(7, 8192), STAGE_PAIRS, "ovf_window"),
    "ovf_drop": (lambda: numpy_rows(7, 1024), STAGE_PAIRS, "ovf_drop"),
    "small_stage": (lambda: numpy_rows(7, 8192), 64, "walks_again"),
    "small_stage_cut": (lambda: numpy_rows(7, 1024), 64, "walks_again"),
    "dense_tile": (lambda: dense_rows(3, 32768), STAGE_PAIRS, "walks_again"),
    "dense_tile_cut": (lambda: dense_rows(3, 9216), STAGE_PAIRS,
                       "walks_again"),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_schedule_matches_jax_and_plain(case):
    """K4's one-pass schedule: pairs on [0, num) and num, ovf_drop and
    ovf_window equal to the JAX interpret-mode kernel's and the plain
    version's (whose slots past num are EMPTY, as the schedule's), on the
    env scenes with and without the true-x accept, on rows that force
    ``ovf_window`` and ``ovf_drop``, and on tiles whose hits outgrow their
    stage (the kernel's 2,048 pairs, and a 64-pair stage)."""
    make, stage, shows = K4_CASES[case]
    args = make()
    ref = jax_sweep_emit(args)
    got = sweep_emit_tiled_onepass_plain(**args, stage=stage)
    plain = sweep_emit_tiled_plain(**args)
    num = int(ref[2])
    for part, a, b, c in zip(("pi", "pj"), ref, got, plain):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(a[:num], b[:num].numpy(), err_msg=part)
        assert torch.equal(b, c), part
    for part, a, b, c in zip(("num", "ovf_drop", "ovf_window"), ref[2:],
                             got[2:5], plain[2:]):
        assert int(a) == int(b) == int(c), (part, a, b, c)
    counts = dict(num=num, ovf_drop=int(ref[3]), ovf_window=int(ref[4]))
    again = got[5]
    if shows == "clean":
        assert counts["num"] > 300 and again == 0
        assert counts["ovf_drop"] == counts["ovf_window"] == 0
    elif shows == "walks_again":
        assert again > 0 and counts["num"] > stage
    else:
        assert counts[shows] > 0
    if args["truex"] is not None:
        assert case.endswith("exact_x")


def test_k4_tiles_scan_in_order():
    """The tiles' first slots are an exclusive scan over the tiles in
    sweep order: at any tile size the schedule gives the same buffer, and
    a budget cut inside a tile keeps the first pairs of the uncut
    buffer."""
    args = numpy_rows(7, 8192)
    full = sweep_emit_tiled_onepass_plain(**args)
    for tile in (32, 100, 1024):
        got = sweep_emit_tiled_onepass_plain(**args, tile=tile, stage=128)
        assert all(torch.equal(a, b) for a, b in zip(got[:5], full[:5]))
    total = int(full[2])
    for cut in (1, 1000, total - 1):
        got = sweep_emit_tiled_onepass_plain(**dict(args, max_pairs=cut),
                                             stage=128)
        assert int(got[2]) == cut and int(got[3]) == total - cut
        assert torch.equal(got[0], full[0][:cut])
        assert torch.equal(got[1], full[1][:cut])
