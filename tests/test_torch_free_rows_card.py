"""Free rows on the card: K1, K3 and K5, whose level schedule leaves the
rows that are all +0.0 (statics at rest, the tiled tier's zero blocks, halo
and padding) out of the level graph while every write to them is +0.0
(``csrc/levels.cuh``), against the serial walk to the bit, at a small pile,
the settled 10k pile, the 20k pile, the 20k avalanche's frame 360 and bench
row E at 1024 envs; the kernels' levels against ``levels_of`` with the
table's free rows; a planted warm impulse that is not finite, which makes
the kernels fall back to the full graph, equal too; and the counters.

At the small frames the kernels are held to the serial plain version
(``plain_walk``, a short solve: its scalar operations are launches); at the
full frames, on all passes, to the serial walk run level by level over the
full graph (``levels_walk`` with every row a node), which equals
``plain_walk`` to the bit (``tests/test_torch_levels.py``).  K2, which
keeps the full graph, is held at the small pile.

Run on a machine with a CUDA device (this file imports no JAX, so the
test directory's ``conftest.py``, which does, is left out):

    python -m pytest --noconftest -m card -q tests/test_torch_free_rows_card.py

Elsewhere each test skips."""

import functools

import pytest
import torch

from phyx_tpu_torch import bench, scenes, tracing
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.kernels.contact_solver import solve_contacts_fused
from phyx_tpu_torch.kernels.contact_solver_streamed import (
    COUNTERS, free_rows, levels_walk, prepass, solve_contacts_streamed,
    solve_contacts_streamed_plain, visit_levels)
from phyx_tpu_torch.kernels.contact_solver_tiled import (
    slab_levels, solve_contacts_tiled, solve_contacts_tiled2,
    solve_contacts_tiled2_plain, solve_contacts_tiled_plain, tiled_prepass)
from phyx_tpu_torch.step import release_graphs, rollout, solve_inputs

pytestmark = pytest.mark.card

KERNELS = dict(K1=solve_contacts_streamed, K3=solve_contacts_tiled2,
               K5=solve_contacts_tiled)


def _row(*flags):
    """A bench row built on the card as ``python -m phyx_tpu_torch.bench``
    builds it: (cfg, state)."""
    return bench.build_row(bench.parser().parse_args(list(flags)), "cuda")


def _small():
    """The 1k pile (bench row B') after 100 frames; a 300-box pile over
    three slabs of the tiled tier after 60."""
    cfg, st = _row("--scene", "pile", "--boxes", "1000")
    st = rollout(st, cfg, 100)
    tcfg = SimConfig(max_bodies=512, max_pairs=1024, broadphase="sap_grid",
                     sap_window=48, solver_backend="pallas_tiled",
                     tile_stride=256, tile_halo=256)
    tst = rollout(scenes.pile(tcfg, 300, seed=0).build("cuda"), tcfg, 60)
    return {"K1": solve_inputs(st, cfg, "rows"),
            "K3": solve_inputs(tst, tcfg, "tiled2"),
            "K5": solve_inputs(tst, tcfg, "tiled")}


def _pile10k():
    cfg, st = _row("--scene", "pile", "--boxes", "10000")
    return {"K1": solve_inputs(rollout(st, cfg, 200), cfg)}


def _pile20k():
    cfg, st = _row("--scene", "pile", "--boxes", "20000")
    st = rollout(st, cfg, 300)
    return {"K3": solve_inputs(st, cfg),
            "K5": solve_inputs(st, cfg.replace(tiled_routing=False))}


def _avalanche():
    """The 20k avalanche at frame 360: the autotuned settle of 300 frames
    in chunks of 10, then 60 frames (the benchmark's window)."""
    from phyx_tpu_torch.tune import rollout_autotuned
    cfg, st = _row("--scene", "avalanche", "--boxes", "20000")
    st, cfg = rollout_autotuned(st, cfg, 300, chunk=10)
    return {"K3": solve_inputs(rollout(st, cfg, 60), cfg)}


def _envs1024():
    from phyx_tpu_torch.demos.run_envs import build_envs
    cfg, st = build_envs(1024, 256)
    return {"K3": solve_inputs(rollout(st, cfg, 240), cfg)}


FRAMES = dict(small=_small, pile10k=_pile10k, pile20k=_pile20k,
              avalanche=_avalanche, envs1024=_envs1024)
CASES = [("small", "K1"), ("small", "K3"), ("small", "K5"),
         ("pile10k", "K1"), ("pile20k", "K3"), ("pile20k", "K5"),
         ("avalanche", "K3"), ("envs1024", "K3")]


@functools.lru_cache(maxsize=None)
def _frame(name):
    out = FRAMES[name]()
    torch.cuda.synchronize()
    release_graphs()
    return out


@pytest.fixture
def inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frame, kernel = request.param
    return frame, kernel, _frame(frame)[kernel]


def _levels(kernel, args, free):
    """The kernel's visits and their levels over ``free`` (None: the full
    graph), as torch operations."""
    if kernel == "K1":
        n = args["body_flat"].numel() // 8
        return visit_levels(args["b1"], args["b2"], args["num_contacts"],
                            args["num_joints"], args["c_cap"], n, free)
    return slab_levels(args, free)


def _serial(kernel, args):
    """The serial walk run level by level over the full graph."""
    lv = _levels(kernel, args, None)
    if kernel == "K1":
        con = args["con_flat"].reshape(-1, 12)
        warm = args["warm_flat"].reshape(-1, 2)
        joint = lv["slots"] >= args["c_cap"]
    else:
        cw = args["cw"].reshape(-1, 14)
        con, warm, joint = cw[:, :12], cw[:, 12:], lv["joint"]
    return levels_walk(args["body_flat"].reshape(-1, 8), con, warm, lv,
                       joint, args["vel_iters"], args["pos_iters"],
                       args.get("tols"))[:3]


def _plain(kernel, args):
    return dict(K1=solve_contacts_streamed_plain,
                K3=solve_contacts_tiled2_plain,
                K5=solve_contacts_tiled_plain)[kernel](**args)


def assert_bit_equal(got, ref, what):
    """Body rows, accumulators and residual equal to the bit; a NaN
    equals a NaN of any payload."""
    for name, a, b in zip(("body", "acc", "residual"), got, ref):
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{what}: {name}"
        assert torch.equal(a.view(torch.int32)[~nan],
                           b.view(torch.int32)[~nan]), f"{what}: {name}"


def _counters(kernel) -> dict:
    return dict(zip(COUNTERS, KERNELS[kernel].stats.tolist()))


@pytest.mark.parametrize("inputs", CASES, indirect=True,
                         ids=[f"{f}-{k}" for f, k in CASES])
def test_kernel_levels_are_levels_of_free_rows(inputs):
    """The kernel's pre-pass gives each visit the level ``levels_of`` gives
    it over the table's free rows; its counters read the levels, the
    visits and the visits with a free endpoint; fewer levels than the full
    graph's, or as many."""
    frame, kernel, args = inputs
    free = free_rows(args["body_flat"])
    lv = _levels(kernel, args, free)
    dev = prepass(**args) if kernel == "K1" else tiled_prepass(args)
    v, n_levels = lv["slots"].numel(), lv["n_levels"]
    assert int(dev["n_levels"][0]) == n_levels
    assert torch.equal(dev["level"][:v].long(), lv["level"])
    assert torch.equal(dev["offsets"][:n_levels + 1].long(), lv["offsets"])
    freed = int((free[lv["i"]] | free[lv["j"]]).sum())
    assert dev["stats"].tolist() == [n_levels, v, freed, 0]
    full = _levels(kernel, args, None)["n_levels"]
    assert n_levels <= full
    if frame != "small":
        assert freed > 0 and n_levels < full
    print(f"\n# {kernel} at {frame}: {v} visits, {freed} with a free "
          f"endpoint; {full} levels a pass with every row a node, "
          f"{n_levels} with free rows")


@pytest.mark.parametrize("inputs", CASES, indirect=True,
                         ids=[f"{f}-{k}" for f, k in CASES])
def test_kernel_equals_the_serial_walk(inputs):
    """The kernel on all the frame's passes, as gated as the frame is,
    equals the serial walk to the bit (at the small frames the serial plain
    version itself, on warm + 1 + 1 passes too), with no fallback; its
    counters, also read through ``tracing.solve_counters``, show the visits
    with a free endpoint."""
    frame, kernel, args = inputs
    wrapper = KERNELS[kernel]
    got = wrapper(**args)
    counters = _counters(kernel)
    assert tracing.solve_counters()[kernel] == counters
    assert counters["fallbacks"] == 0
    if frame != "small":
        assert counters["freed_visits"] > 0
    assert_bit_equal(got, _serial(kernel, args), f"{kernel} at {frame}")
    if frame == "small":
        short = dict(args, vel_iters=1, pos_iters=1)
        assert_bit_equal(wrapper(**short), _plain(kernel, short),
                         f"{kernel} at {frame}, short")


def _planted(kernel, args):
    """The inputs with an infinite normal warm impulse on the first visit
    with a free endpoint, on warm + 1 + 1 passes."""
    free = free_rows(args["body_flat"])
    lv = _levels(kernel, args, free)
    slot = int(lv["slots"][free[lv["i"]] | free[lv["j"]]][0])
    short = dict(args, vel_iters=1, pos_iters=1)
    if kernel == "K1":
        warm = args["warm_flat"].clone()
        warm[2 * slot] = float("inf")
        return dict(short, warm_flat=warm)
    cw = args["cw"].reshape(-1, 14).clone()
    cw[slot, 12] = float("inf")
    return dict(short, cw=cw.reshape(-1))


@pytest.mark.parametrize("inputs", CASES, indirect=True,
                         ids=[f"{f}-{k}" for f, k in CASES])
def test_forced_fallback_equals_the_serial_walk(inputs):
    """A planted infinite warm impulse on a contact with a free row: the
    kernel's level solve flags the NaN it would write there, the rerun
    over the full graph runs (the fallback counter reads 1), and the
    result equals the serial walk to the bit, NaNs included."""
    frame, kernel, args = inputs
    planted = _planted(kernel, args)
    got = KERNELS[kernel](**planted)
    assert _counters(kernel)["fallbacks"] == 1
    ref = (_plain if frame == "small" else _serial)(kernel, planted)
    assert bool(torch.isnan(ref[0]).any())
    assert_bit_equal(got, ref, f"{kernel} at {frame}, planted")


def test_k2_keeps_the_full_graph():
    """K2 (its own schedule, every row a node) at the small pile equals
    the serial plain version on warm + 1 + 1 passes and the serial walk on
    all passes, and K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _frame("small")["K1"]
    got = solve_contacts_fused(**args)
    assert_bit_equal(got, _serial("K1", args), "K2 at small")
    assert_bit_equal(got, solve_contacts_streamed(**args), "K2 vs K1")
    short = dict(args, vel_iters=1, pos_iters=1)
    assert_bit_equal(solve_contacts_fused(**short), _plain("K1", short),
                     "K2 at small, short")
