"""K4's counters (``kernels/sweep_tiled.py``): the wrapper keeps its latest
call's pairs written, ``ovf_drop`` and ``ovf_window`` at
``sweep_emit_tiled.stats``, and ``tracing.solve_counters()`` reads them
under K4's own names beside the solves'.

On the CPU the plain path's counters, at a full budget, a cut budget and a
cut window.  On the card (marker ``card``) a row-E frame (bench row E's
1,024 envs x 256 boxes): the counters read after a graph replay equal an
uncaptured step's, the replay makes no host sync and launches no
wrapper, and each hand-written kernel runs as often in the replayed frame
as in the uncaptured one, K4 once.  This file imports no JAX:

    python -m pytest --noconftest -m card -q tests/test_torch_sweep_counters.py
"""

import collections

import pytest
import torch

from phyx_tpu_torch import broadphase as bp
from phyx_tpu_torch import tracing
from phyx_tpu_torch.demos.run_envs import envs_scene
from phyx_tpu_torch.kernels import wrappers
from phyx_tpu_torch.kernels.sweep_tiled import (COUNTERS, sweep_emit_tiled,
                                                sweep_emit_tiled_plain)

torch.set_num_threads(1)


def _scene():
    """A CPU mega-scene of envs_layout: 64 envs x 16 boxes on 8 y-bands,
    banded keys, slabs of 1,024 rows (two of them).  (cfg, bodies)"""
    cfg, mega, _, _ = envs_scene(64, 16)
    cfg = cfg.replace(max_bodies=2048, max_pairs=4096,
                      solver_backend="pallas_tiled", tile_stride=1024,
                      tile_halo=1024)
    return cfg, mega.build("cpu").bodies


def _sweep_inputs(cfg, bodies):
    """K4's inputs at the scene, as ``broadphase_sap_tiled`` makes them."""
    lo, hi = bp.compute_aabbs(bodies)
    return bp._sap_tiled_sort_stage(bodies, cfg, lo, hi)[0]


CUTS = {
    "full": {},
    "budget": {"max_pairs": 64},
    "window": {"window_rows": 1024},
}


@pytest.mark.parametrize("cut", CUTS)
def test_plain_path_keeps_its_counters(cut):
    """The wrapper on CPU tensors leaves at ``stats`` the three counters
    it returns, (3,) int32, in ``COUNTERS``' order; the cuts make the
    counter they cut read above 0."""
    sweep = dict(_sweep_inputs(*_scene()), **CUTS[cut])
    pi, pj, num, drop, window = sweep_emit_tiled(**sweep)
    stats = sweep_emit_tiled.stats
    assert stats.dtype == torch.int32 and stats.shape == (3,)
    assert stats.tolist() == [int(num), int(drop), int(window)]
    assert COUNTERS == ("pairs", "ovf_drop", "ovf_window")
    assert int(num) > 0
    if cut == "budget":
        assert int(num) == 64 and int(drop) > 0
    if cut == "window":
        assert int(window) > 0
    ref = sweep_emit_tiled_plain(**sweep)
    assert [int(x) for x in ref[2:]] == stats.tolist()


def test_solve_counters_name_k4s_fields():
    """``tracing.solve_counters()`` reads K4's counters under its names,
    and every wrapper that keeps counters names them."""
    sweep = _sweep_inputs(*_scene())
    _, _, num, drop, window = sweep_emit_tiled(**sweep)
    got = tracing.solve_counters()["K4"]
    assert list(got) == list(COUNTERS)
    assert got == dict(pairs=int(num), ovf_drop=int(drop),
                       ovf_window=int(window))
    for name, wrapper in wrappers().items():
        if hasattr(wrapper, "stats"):
            assert len(wrapper.counter_names) >= 3, name


def test_broadphase_leaves_the_frames_counters():
    """``broadphase_sap_tiled`` leaves K4's counters of its own sweep."""
    cfg, bodies = _scene()
    pairs = bp.broadphase_sap_tiled(bodies, cfg)
    got = tracing.solve_counters()["K4"]
    ref = sweep_emit_tiled_plain(**_sweep_inputs(cfg, bodies))
    assert got == dict(zip(COUNTERS, [int(x) for x in ref[2:]]))
    assert got["ovf_drop"] == 0 and got["ovf_window"] == 0
    assert int(pairs.overflow) == 0


# --- on the card ---------------------------------------------------------

HAND = ("tiled_onepass", "visit_levels", "level_solve", "phyx_mark_")


@pytest.fixture(scope="module")
def row_e():
    """Bench row E's mega-scene (1,024 envs x 256 boxes, envs_layout's
    configuration) after 20 frames through ``rollout``, whose graph is
    then held."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phyx_tpu_torch.demos.run_envs import build_envs
    from phyx_tpu_torch.step import release_graphs, rollout
    cfg, st = build_envs(1024, 256)
    st = rollout(st, cfg, 20)
    torch.cuda.synchronize()
    yield cfg, st
    release_graphs()


def _hand_kernels(events) -> list:
    """The hand-written kernels among a profiler's device events, split at
    the sleep kernel: (before, after), each a Counter of names."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted(((e.time_range.start, e.name) for e in events
                  if e.device_type == cuda), key=lambda o: o[0])
    cut = next(t for t, name in ops if "spin" in name or "sleep" in name)
    parts = collections.Counter(), collections.Counter()
    for t, name in ops:
        for h in HAND:
            if h in name:
                key = name if h == "phyx_mark_" else h
                parts[t > cut][key] += 1
    return parts


@pytest.mark.card
def test_replayed_counters_equal_an_uncaptured_steps(row_e):
    """One replayed frame and one uncaptured step from the same state: K4's
    counters equal, read after each; the replay under the sync-debug mode
    "error" (a host sync raises) launches no wrapper; in one profiler
    session each hand-written kernel runs as often in the replayed frame as
    in the uncaptured one, K4 once."""
    from torch.profiler import ProfilerActivity, profile

    from phyx_tpu_torch.step import rollout, step
    cfg, st = row_e
    rollout(st, cfg, 1)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            rollout(st, cfg, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        replayed = tracing.solve_counters()["K4"]
        assert {k: w.launches for k, w in wrappers().items()} == launches
        torch.cuda._sleep(20_000_000)
        step(st, cfg)
        uncaptured = tracing.solve_counters()["K4"]
        torch.cuda.synchronize()
    assert sweep_emit_tiled.launches == launches["K4"] + 1
    assert replayed == uncaptured
    assert replayed["pairs"] > 0
    assert replayed["ovf_drop"] == 0 and replayed["ovf_window"] == 0
    before, after = _hand_kernels(prof.events())
    assert before["tiled_onepass"] == 1
    assert before == after
    print(f"\n# K4 at row E: {replayed}; hand-written kernels a frame "
          f"{dict(before)}")
