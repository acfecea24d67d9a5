"""The serial sweep emission K7's schedule on the CPU: the 32-lane batched
walk (``sweep_emit_warp_plain``: each row's candidates tested a batch at a
time, the x-open and hit masks, each hit's slot from its row's first slot
and its rank) against the walk's plain version (``sweep_emit_plain``) and
the JAX package's ``sweep_emit`` in interpret mode: the whole pair buffer,
``num`` and ``ovf`` exact."""

import numpy as np
import pytest
import torch

import phyx_tpu_torch.kernels.sweep as sweep_mod
from phyx_tpu.kernels.sweep import sweep_emit as jax_k7
from phyx_tpu_torch.broadphase import EMPTY
from phyx_tpu_torch.kernels.sweep import (LANES, sweep_emit,
                                          sweep_emit_plain,
                                          sweep_emit_warp_plain)
from test_torch_sweep_emit import k7_args, run_jax, run_port, sweep_rows

torch.set_num_threads(1)


def nan_rows(n, na, seed):
    """sweep_rows' pile with NaN in some rows' AABBs: a NaN hix closes the
    row's walk at once, a NaN lox closes the walks that reach it, a NaN y
    fails the hit test."""
    aabb, order, dyn, na = sweep_rows(n, na, seed, spread=20.0, ground=True)
    aabb = aabb.copy()
    for row, col in ((order[3], 2), (order[10], 0), (order[40], 1),
                     (order[41], 3), (order[0], 0)):
        aabb[row, col] = np.nan
    return aabb, order, dyn, na


# (rows, max_pairs, what the case must show)
CASES = {
    "pile": (lambda: sweep_rows(300, 250, 5, 25.0, True), 4096, "no_ovf"),
    "pile_cut": (lambda: sweep_rows(300, 250, 5, 25.0, True), 97, "ovf"),
    "pile_cut_one": (lambda: sweep_rows(256, 200, 4, 20.0, True), 1, "ovf"),
    "dense_many_batches": (lambda: sweep_rows(512, 500, 7, 6.0, True), 65536,
                           "long_runs"),
    "dense_cut": (lambda: sweep_rows(512, 500, 7, 6.0, True), 3000, "ovf"),
    "nan_aabbs": (lambda: nan_rows(300, 280, 9), 4096, "no_ovf"),
    "nact_0": (lambda: sweep_rows(300, 0, 5, 25.0, True), 4096, "empty"),
    "nact_1": (lambda: sweep_rows(300, 1, 5, 25.0, True), 4096, "empty"),
    "nact_n": (lambda: sweep_rows(300, 300, 5, 25.0, True), 4096, "no_ovf"),
}


def longest_run(aabb, order, na):
    """The most candidates any sorted row walks (x-open run, sj < na)."""
    box = aabb[order[:na]]
    runs = [int(np.searchsorted(box[:, 0], box[k, 2], side="right")) - k - 1
            for k in range(na)]
    return max(runs, default=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_walk_matches_plain_and_jax(case):
    make, max_pairs, shows = CASES[case]
    aabb, order, dyn, na = make()
    args = k7_args(aabb, order, dyn, na)
    ref = run_jax(jax_k7, args, max_pairs)
    tensors = [torch.from_numpy(np.ascontiguousarray(x)) for x in args[:3]]
    nact = torch.tensor(na, dtype=torch.int32)
    got = [x.numpy() for x in sweep_emit_warp_plain(*tensors, nact,
                                                    max_pairs)]
    plain = [x.numpy() for x in sweep_emit_plain(*tensors, nact, max_pairs)]
    for part, a, b, c in zip(("pi", "pj", "num", "ovf"), ref, got, plain):
        assert b.dtype == np.int32, (part, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=part)
        np.testing.assert_array_equal(c, b, err_msg=part)
    num, ovf = int(ref[2]), int(ref[3])
    assert (got[0][num:] == EMPTY).all() and (got[1][num:] == EMPTY).all()
    if shows == "ovf":
        assert ovf > 0 and num == max_pairs
    elif shows == "empty":
        assert num == 0 and ovf == 0
    else:
        assert ovf == 0 and num > 0
    if shows == "long_runs":
        # a row's open run spans several 32-lane batches
        assert longest_run(aabb, order, na) > 3 * LANES


def test_cut_keeps_the_first_pairs_in_row_order():
    """At a cut buffer the survivors are the first max_pairs emissions of
    the uncut buffer: (source row, candidate row) order; an empty buffer
    (which the JAX kernel does not take) counts every pair in ``ovf``."""
    aabb, order, dyn, na = sweep_rows(512, 500, 7, 6.0, True)
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in k7_args(aabb, order, dyn, na)[:3]]
    nact = torch.tensor(na, dtype=torch.int32)
    full = sweep_emit_warp_plain(*args, nact, 1 << 20)
    total = int(full[2])
    for cut in (0, 1, 31, 32, 33, total // 2, total - 1):
        pi, pj, num, ovf = sweep_emit_warp_plain(*args, nact, cut)
        assert int(num) == cut and int(ovf) == total - cut
        assert torch.equal(pi, full[0][:cut]) and torch.equal(pj, full[1][:cut])


def test_wrapper_takes_plain_on_cpu():
    args = k7_args(*sweep_rows(300, 250, 5, 25.0, True))
    before = sweep_emit.launches
    got = run_port(sweep_emit, args, 200)
    assert sweep_emit.launches == before          # no kernel on the CPU
    ref = run_port(sweep_emit_plain, args, 200)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # the one launch's counts: past 51,200 rows they need device scratch
    n = sweep_mod.WARP_COUNTS_SMEM // 4 + 1
    rows = torch.zeros(4 * n), torch.zeros(n, dtype=torch.int32)
    z = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit shared memory"):
        sweep_mod.warp_pass(rows[0], rows[1], rows[1], z, rows[1], rows[1],
                            z, z, 8)
