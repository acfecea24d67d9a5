"""Smoke run of the PyTorch/CUDA port (``phyx_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # device, build and the small checks
    python3 chip_smoke.py --parent DIR   # also time DIR's K4 and K6

Phases; any failure raises and the script exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — build the seven kernels from the five sources of
             ``phyx_tpu_torch/csrc``, one ``nvcc`` each, started together:
             K1, the streamed solve (state in device memory, run level by
             level over the visits' dependency graph), K2, the
             fused solve (one launch of one block: K1's pre-pass, then the
             level walk with its records streamed into a ring of shared
             memory by bulk copies), in one source K3 and
             K5, the slab-major and the routed tiled solves (the x-rank
             embedded body table, run level by level with K1's schedule),
             K4, the slab-windowed sweep (one launch: count, single-pass
             scan and write), and in one source K6 and K7, the chunked
             sweep emission (one launch over tiles, single-pass scan) and
             the serial one (one launch: a warp a sorted row).  With
             ``--parent DIR``, also DIR's K4 and K6 sources (an earlier
             commit of the port), for timing beside this tree's.
3. compare — each solve kernel against the plain torch version on the
             packed solve input of small frames on the card, gates off and
             on: K1 and K2 on a 200-box pile (contacts only), a loaded
             bridge (revolute rows and contacts) and a net (distance rows);
             K3 and K5 on a 300-box pile over three slabs and a 200-box
             pile with a moving static, K5 on a tiled loaded bridge and
             net, each against both its serial and its levels plain
             version, in every placement of its per-row arrays, and its
             pre-pass against ``slab_levels``.  Body rows, accumulators
             and residual must be equal
             (exact float32 equality), K1 must equal K2, and K2 its
             schedule's plain version (``fused_steps`` and
             ``ring_schedule``) on all passes; K2 also with its
             accumulators in device memory (the pile frame's row slots
             padded past their room in shared memory), on numpy-made
             rows whose levels are wider than its 128 solving threads,
             and with no live row (K1 == K2 on both).  K4 against
             its plain version on a two-slab banded 64-env mega-scene
             (true-x accept on and off) and at a budget cut to half its
             pairs, the same in the segmented layout, numpy-made rows that
             force ``ovf_window`` and, with a small budget, ``ovf_drop``,
             and rows whose first tile's pairs outgrow K4's stage (budget
             whole and cut): pairs equal on [0, num), counters equal; K4's
             device time on the first.  K6 and K7 against their plain
             versions on a 200-box pile frame (cap 1024), numpy-made rows
             over three chunks with a long static ground and inactive tail
             rows, and the same at a small budget, where both count
             ``ovf`` and keep different pairs; K6 also on those rows out of
             x order (whole and cut) and with NaN AABBs, where its proof
             must refuse the short walk: the whole buffer, ``num`` and
             ``ovf`` equal; K6's device time on the first.  Then the
             whole step on the card against the step on the CPU: a 60-box
             pile, a 20-link chain, a loaded bridge, a 150-box tiled pile
             through K3 and through K5, an 8-env banded mega-scene through
             K4 + K3 and through K4 + K5, a 200-box pile under
             ``sap_kernel`` at cap 512 through K7 + K2, and an 8-env
             mega-scene under ``sap`` at cap 1024 through K6 + K1.  On
             each of these scenes, its frame captured as a CUDA graph
             (``rollout``), then two replays of it against two uncaptured
             steps: every State tensor equal to the bit, the replays
             launching no wrapper; each of these frames (one a
             configuration) handed to the profiler's session.
4. pile10k — the 10k-box pile at the bench's settings (cap 16,384 bodies,
             32,256 pairs, sap_grid window 192 / 8 hits, 10+6 passes)
             through ``rollout``, a CUDA graph replay (one uncaptured
             frame, the capture, replays): a 200-frame settle (the bench's
             300, cut for the script's time) in which no step may wait for
             the device, a discarded warm-up window of n frames (in every
             scene), then frames timed by the slope t(2n) - t(n) over n
             (the settle's wrappers launch K1 once, in its warm-up frame,
             and no other kernel; the replays launch none, the graph runs
             their kernels, which the profiler's trace counts); in the
             scenes
             timed "both ways", then the same uncaptured, a loop of
             ``step``, and the host's ms a frame to queue each way; in
             every scene two replays against two uncaptured steps, every
             State tensor equal to the bit; finite state, contacts
             present, bench.py's quality bar met; the device time of the
             step's stages (CUDA events) and the device's idle share of
             each way's frame; K1
             against its plain version at the frame's shapes on fewer
             passes, gates off and on, and both timed; K1's pre-pass
             against ``visit_levels`` (levels, offsets, each level's rows),
             the levels a pass, their widths and the pre-pass timed alone,
             and the pre-pass with its last-level array in device memory
             against ``visit_levels`` too; K1 against
             ``solve_contacts_levels_plain`` on all passes; K1 with both
             per-body arrays in device memory (the placement above N =
             51,200, its solve's above 19,285) equal to K1 on all passes,
             and timed; at the settled frame
             ``broadphase="sap"`` (K6 at cap 16,384) gives the grid's lex
             buffer, ``num`` and zero counters, and K6 equals its plain
             version and is timed there.
5. chain   — the 1000-link revolute chain at bench row C's settings (cap
             1024 bodies, 2048 pairs, 1024 joints, the same broadphase and
             passes): 300-frame settle without host waits, slope timing
             both ways,
             each frame launching K2 once and no other kernel; bench.py's
             joint bar (overflow 0, residual <= 1e-2), finite state; stage
             times; K2 against the plain version at the frame's shapes on
             fewer passes, gates off and on; K1 == K2 on the full frame,
             and both timed there; K2's levels a pass, the share of narrow
             levels (one warp's), its pre-pass timed alone, ns a level and
             its place in shared memory (ring depth and bytes, where the
             accumulators sit).
6. pile1k  — the 1k pile (cap 1024, 3584 pairs): 400-frame settle, slope
             timing both ways, K2 once a frame, the 0.6 penetration bar;
             stage times; K2 against the plain version at the frame's
             shapes, gates off and on; K1 == K2 and K2's levels, as at the
             chain frame.
7. pile20k — the 20k pile (cap 32,768, 64,000 pairs: the tiled tier,
             3 slabs of the default 16,384-row stride): the bench's
             300-frame settle without host waits, slope timing, K3 once a
             frame and no other kernel; every overflow counter 0, the 0.6
             penetration bar, finite state; stage times; K3 against the
             serial plain version at the frame's shapes (warm + 1 velocity
             pass) and against the levels plain version on all passes,
             its pre-pass against ``slab_levels`` (last-level array in
             shared and in device memory), every placement of its per-row
             arrays equal to the wrapper's, the full solve and the
             pre-pass timed, levels a pass and ns a level; K1 timed on the
             same frame compacted; one frame through K3 and one through K5
             (``tiled_routing=False``) without host waits, K5 launched
             once, within 5e-3 of the K3 frame; K5 at that frame's routed
             shapes checked and timed as K3.
8. envs1024 — bench row E at the reference's 1024 envs x 256 boxes
             (bench.py's build_envs: band grid of 8 y-bands x 128 x-cells,
             banded keys, cap 264,192, 839,168 pairs, 17 slabs),
             ``broadphase="sap"`` and the pallas backend, which take K4
             and K3: ``SETTLE_E1024``-frame settle (bench.py's 240, cut
             for the script's time) without host waits, slope timing, K4
             and K3 once a frame each and no other kernel; every overflow
             counter 0, penetration ratio <= 0.2, finite state;
             env-steps/s beside the reference's per-env fingerprint; stage
             times; K4 against its plain version at the settled frame,
             both timed (K4's one launch on device behind a sleep kernel,
             and the wrapper's pace; with ``--parent``, DIR's K4 and this
             tree's in turns, parent, change, change, parent); K3 against
             its
             levels plain version on all passes there (the serial one
             would take ~10 minutes), its pre-pass and placements checked
             and timed as at the 20k frame.
9. envs64  — bench row E at bench.py's own default of 64 envs x 256 boxes (cap
             17,408, 52,736 pairs): ``"sap"`` within the reference's sweep
             budget takes K6, the capacity the streamed solve K1: 240-frame
             settle without host waits, slope timing both ways, K6 and K1 once
             a frame each and no other kernel; every overflow counter 0,
             penetration ratio <= 0.2, finite state; env-steps/s beside the
             1024-env scene's (the uncaptured rate null, with a line saying so,
             where its slope reads below the device stages' sum); stage times;
             K6 against its plain version at the settled frame and at its
             buffer cut to half the frame's pairs, and timed (device time
             behind a sleep kernel; with ``--parent``, DIR's K6 beside it as
             K4's); K1 against its plain version (warm + 1 + 1 passes) and
             timed on all passes, and its level checks and its placement in
             device memory as at the 10k frame.
10. pile500 — a 500-box pile under ``broadphase="sap"`` at bench.py's
             build() settings (cap 512, 2,048 pairs): K7, the capacity not
             in whole chunks, and K2: 400-frame settle, slope timing both
             ways, K7 and
             K2 once a frame, the 0.6 penetration bar; stage times; K7
             against its plain version at the settled frame and at a
             buffer cut to half its pairs (``ovf`` counted), with its
             per-row counts in device memory (the placement past 51,200
             rows), and timed; K2 as at the chain frame.
11. avalanche — bench row D (``--scene avalanche --autotune``) at 20,000
             boxes (cap 32,768, 160,256 pairs: the tiled tier, K3) with
             the bench's 300-frame settle, and at 100,000 (cap 131,072,
             800,256 pairs) with its settle cut to ``SETTLE_100K`` frames
             (the bench's 1,000 run as their own chip call:
             ``phase_avalanche``): ``rollout_autotuned`` in chunks of 10,
             each retune printed, every retune keeping the tier, K3 once a
             frame, the captured graph of each configuration left freed;
             slope timing both ways, bench.py's bar (penetration ratio <=
             2.0, every ``ovf_*`` 0), stage times, two replays against two
             steps, the policies' host time, and K3 at the settled frame
             against its levels plain version (warm + 1 velocity pass),
             its pre-pass, levels a pass, timed.
12. colored — the colored solve (``solver_backend="xla"``, torch ops, no
             kernel) with bench.py's build() policy otherwise: the 10k pile
             (the 200-frame settle of phase 4) and the 1000-link chain (the
             bench's 300), settled without host waits, slope timing both ways
             with no kernel of K1-K7 launched, the pile's penetration ratio
             read frame by frame from frame 201 to 330 (the card's input
             states of its peak frame and the two before it each stepped
             once on the card and once on the CPU: positions, velocities
             and the ratio within 1e-4), bench.py's bars (pile:
             penetration ratio <= 0.6, ovf 0; chain: residual <= 1e-2, read at
             bench row C's frame 600, run on to without host waits); the
             stages by CUDA events with no sleep ahead (a colored frame queues
             more kernels than the launch queue holds) and the host's enqueue;
             at the settled frame the colors on the card equal to the CPU's,
             ``check_coloring`` 0, the final class's share, the colored solve
             within ``COLORED_ATOL`` of the same solve on the CPU and, run
             twice, equal to the bit, the whole step twice equal to the bit
             (the pile frame also at 4 colors, a full final class); one
             colored-fallback ``"pallas"`` frame card vs CPU. Then one call
             each of K4, K6 and K7 at their settled frames in one
             torch.profiler session: each launches one CUDA kernel; the same
             session counts and times the kernels of each colored frame's
             three stages and of its solve's parts (coloring, warm start,
             velocity passes, displacement passes): device busy ms, idle
             share. The same session also counts and times one uncaptured
             step and three graph replays of every timed scene and of the
             step-parity frames: in the trace each replay runs each
             hand-written kernel as often as the step, whose wrappers'
             counts hold each kernel's name to its wrapper; the kernels
             line's launches are those of the replays; busy ms and idle
             share of a replayed frame from the same trace.
13. aux    — the auxiliaries, after the colored phase and before the
             profiler's session: row B' (the 1k pile, K2) settled 60
             frames, checkpointed, loaded onto the card, the saved and the
             loaded state each replaying 30 frames equal to the bit, the
             file loaded on the CPU equal to the card state's copy;
             ``metrics.snapshot`` of that state on the card against its
             CPU copy; ``debug.checked_rollout`` over 60 frames (a graph
             of its own) equal to ``rollout``'s to the bit, a NaN velocity
             raising from ``checked_step`` and the reference's overflow
             scene from ``checked_rollout``; ``profiling.profile_step``
             (20 chained frames) at the settled 10k pile (K1) and chain
             (K2, joint stages), the frame with its stage marks equal to
             ``step``'s to the bit, a 1 us sleep flagged host-paced by
             ``stage_times`` and refused by ``profile_step``; the demos ``run_scene`` (a 500-box pile: metrics,
             checkpoint, resume) and ``run_envs`` (16 envs x 64 boxes) in
             this process.  One ``{"aux": ...}`` line.
14. multi  — multi-device (M16) on the one card, after ``aux``: a sharded
             frame card vs CPU (the 8 stacks of tests/test_spatial.py and a
             200-box pile, 4 shards, "pallas" and "pallas_tiled": one halo
             exchange equal to the bit, ``halo_overflow`` included, one
             frame within 1e-4); row D's 100k avalanche (the avalanche
             phase's settled state) in 4 x-bands through
             ``spatial_rollout`` (a graph of whole 4-shard frames, K3 once a
             shard) in chunks of 10, rebalanced where a chunk overflows its
             halo, row D's bar and ``halo_overflow`` 0 on the last chunk,
             two replays equal to two uncaptured sharded frames to the bit,
             slope timing both ways, 20 sharded frames against 20
             unsharded (max |dpos|, beside the reference's 0.12 envelope);
             bench row E's 1024 envs as 4 stacked groups of 256
             (``concat_envs_grouped``, ``sharded_mega_step``: K4 and K3 a
             group) equal to the bit to each group's own ``rollout`` over 10
             frames, overflow 0, env-steps/s both ways; and 64 envs of 256
             boxes as a stacked batch (``sharded_env_step``) equal to the
             bit to each env's own 10 steps.  One ``{"multi": ...}`` line,
             printed after the profiler's session with the launches of a
             replayed frame of each.
15. bench  — the port's CLI in a process of its own, after ``multi``:
             ``python3 -m phyx_tpu_torch.bench --boxes 1000`` (row B' at
             bench.py's other defaults: 300-frame settle, n = 100), within
             ``BENCH_TIMEOUT_S``: exit code 0; its last line bench.py's
             JSON line with ``backend`` "cuda", ``solver_backend``
             "pallas", the quality verdict passing and ``pair_overflow``
             0; its stderr's launches K2 (its warm-up frame) and no other
             kernel.  One ``{"bench": ...}`` line.

Prints a JSON line per main-path phase (physics, rates, stage times), the
auxiliaries' line, a JSON line of the colored frames' breakdown, one of
every timed scene both ways (``frames``), one of the kernels, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations of one visit of each kind (csrc/solve_rows.cuh):
# contact warm, velocity, displacement; joint warm, velocity, displacement
OPS = dict(cw=24, cv=59, cp=40, jw=19, jv=42, jp=42)


def _sync():
    import torch
    torch.cuda.synchronize()


def _wrappers() -> dict:
    """Every kernel's wrapper, by name."""
    from phyx_tpu_torch.kernels import wrappers
    return wrappers()


def _plains() -> dict:
    """Every kernel's plain version, by name."""
    from phyx_tpu_torch.kernels.contact_solver_streamed import \
        solve_contacts_streamed_plain
    from phyx_tpu_torch.kernels.contact_solver_tiled import (
        solve_contacts_tiled2_plain, solve_contacts_tiled_plain)
    from phyx_tpu_torch.kernels.sweep import (sweep_emit_plain,
                                              sweep_emit_v2_plain)
    from phyx_tpu_torch.kernels.sweep_tiled import sweep_emit_tiled_plain
    return dict(K1=solve_contacts_streamed_plain,
                K2=solve_contacts_streamed_plain,
                K3=solve_contacts_tiled2_plain, K4=sweep_emit_tiled_plain,
                K5=solve_contacts_tiled_plain, K6=sweep_emit_v2_plain,
                K7=sweep_emit_plain)


# the parent tree's K4 and K6 wrappers (``--parent``), by name
_PARENT: dict = {}


def _parent_wrappers(tree: str) -> dict:
    """K4's and K6's wrappers from another tree of the port (its
    ``phyx_tpu_torch/kernels/sweep.py`` and ``sweep_tiled.py``, their
    sources built from its own ``csrc``), loaded beside this tree's
    package under other module names: for timing an earlier commit's
    kernels on the same frames in the same call.  The tree's modules
    import their helpers from this tree's package, its ``sweep_tiled``
    from its own ``sweep``."""
    import importlib.util
    import pathlib
    root = pathlib.Path(tree).resolve() / "phyx_tpu_torch"
    key = "phyx_tpu_torch.kernels.sweep"
    import phyx_tpu_torch.kernels.sweep  # noqa: F401
    own = sys.modules[key]
    mods = {}
    try:
        for name in ("sweep", "sweep_tiled"):
            spec = importlib.util.spec_from_file_location(
                f"parent_{name}", root / "kernels" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            mod.SOURCE = root / "csrc" / mod.SOURCE.name
            mods[name] = mod
            sys.modules[key] = mods["sweep"]
    finally:
        sys.modules[key] = own
    return dict(K6=mods["sweep"].sweep_emit_v2,
                K4=mods["sweep_tiled"].sweep_emit_tiled)


def _versus_parent(name: str, args, reps: int = 20) -> dict:
    """With ``--parent``: the parent's wrapper of kernel ``name`` and this
    tree's on the same ``args``, each call's device time behind a sleep
    kernel (``_split_device_ms``), in turns parent, change, change,
    parent; the parent's outputs must equal this tree's (K4: pairs on
    [0, num) and the counters; K6: all)."""
    if name not in _PARENT:
        return {}
    import torch
    old, new = _PARENT[name], _wrappers()[name]
    a, b = old(**args), new(**args)
    num = int(b[2])
    same = all(int(x) == int(y) for x, y in zip(a[2:], b[2:])) and all(
        torch.equal(x[:num] if name == "K4" else x,
                    y[:num] if name == "K4" else y)
        for x, y in zip(a[:2], b[:2]))
    if not same:
        raise AssertionError(f"the parent's {name} and this tree's differ")
    ms = [_split_device_ms((), fn, args, reps)["wrapper_device_ms"]
          for fn in (old, new, new, old)]
    print(f"# versus the parent: {name} a call, device ms, parent "
          f"{ms[0]:.4f} / {ms[3]:.4f}, change {ms[1]:.4f} / {ms[2]:.4f}",
          flush=True)
    return dict(parent_ms=[ms[0], ms[3]], change_ms=[ms[1], ms[2]])


def _reset_counts():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def phase_device() -> str:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing measured")
    # without the port beside this script, fail before printing anything
    import phyx_tpu_torch  # noqa: F401
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = out.stdout.strip().splitlines()[0]
    print(f"# device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}"
          f" | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    return card


def phase_build() -> None:
    import importlib
    from phyx_tpu_torch.kernels import nvcc
    # one module (and one source) may hold several kernels: K3 and K5, K6
    # and K7
    modules = list({w.__module__: importlib.import_module(w.__module__)
                    for w in _wrappers().values()}.values())
    t0 = time.perf_counter()
    reports = nvcc.compile_all([m.SOURCE for m in modules])
    for m in modules:
        m.build()
    print(f"# build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(m.SOURCE.name for m in modules)}, in parallel",
          flush=True)
    # the parent tree's sweeps (--parent), for timing beside them
    parents = list({w.__module__: sys.modules[w.__module__]
                    for w in _PARENT.values()}.values())
    nvcc.compile_all([m.SOURCE for m in parents])
    for m in parents:
        m.build()
    for name, report in reports.items():
        for line in report.splitlines():
            print(f"#   nvcc {name}: {line}")


def _equal(name, got, ref) -> float:
    """Max abs difference of two (body, acc, residual) triples, raising
    unless every output is finite and equal."""
    import torch
    err = 0.0
    for part, a, b in zip(("body", "acc", "residual"), got, ref):
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"{name} {part} has non-finite values")
        d = (a - b).abs().max().item()
        err = max(err, d)
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {part} differs: max abs diff {d}")
    return err


def _compare(wrapper, args) -> tuple:
    """Kernel vs plain version on the same CUDA tensors; returns (max abs
    difference, plain version's ms), raising unless every output is
    equal."""
    name = next(k for k, w in _wrappers().items() if w is wrapper)
    got = wrapper(**args)
    _sync()
    t0 = time.perf_counter()
    ref = _plains()[name](**args)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return _equal(f"{wrapper.__name__} vs plain", got, ref), plain_ms


def _k1_equals_k2(args) -> float:
    w = _wrappers()
    return _equal("K1 vs K2", w["K1"](**args), w["K2"](**args))


def _small_frame(kind):
    """A small frame on the card: (state, cfg, description)."""
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.step import rollout
    if kind == "pile":
        cfg = SimConfig(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
                        sap_window=64, solver_backend="pallas")
        return (rollout(scenes.pile(cfg, 200, seed=0).build(), cfg, 40), cfg,
                "200-box pile")
    cfg = SimConfig(max_bodies=32, max_pairs=128, max_joints=32,
                    broadphase="sap_grid", sap_window=16,
                    solver_backend="pallas")
    if kind == "bridge":
        sb, frames = scenes.bridge(cfg, 8, load_boxes=3), 50
    else:
        sb, frames = scenes.net(cfg, 6), 20
    return rollout(sb.build(), cfg, frames), cfg, f"{kind} frame"


def _wide_rows() -> dict:
    """tests/test_torch_fused_levels.py's wide frame on the card: levels
    of 320, 20 (five), 40 and 10 contact rows, so wide levels (three steps
    of the 128 solving threads, then one) follow narrow ones and narrow
    follow wide; numpy-made rows and warm impulses."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    b1 = list(range(1, 301))                       # level 1: 300 pairs
    b2 = list(range(301, 601))
    for c in range(20):                            # 20 chains of 6 rows
        b1 += [601 + c] * 6
        b2 += list(range(621 + 6 * c, 627 + 6 * c))
    b1 += [601 + c for c in range(20)] + [626 + 6 * c for c in range(20)]
    b2 += list(range(741, 761)) + list(range(761, 781))   # level 7: 40
    b1 += [601 + c for c in range(10)]             # level 8: 10
    b2 += list(range(781, 791))
    n, c_cap = 800, len(b1)
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
    warm = np.stack([rng.uniform(0.0, 0.3, c_cap),
                     rng.uniform(-0.05, 0.05, c_cap)], 1).astype(np.float32)

    def card(x, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(x).reshape(-1), dtype=dtype,
                            device="cuda")

    return dict(body_flat=card(body), b1=card(b1, torch.int32),
                b2=card(b2, torch.int32), con_flat=card(con),
                warm_flat=card(warm),
                num_contacts=torch.tensor(c_cap, dtype=torch.int32,
                                          device="cuda"),
                vel_iters=10, pos_iters=6, num_joints=None, c_cap=c_cap,
                tols=None)


def _k2_wide_and_empty() -> float:
    """K2's wide steps and its empty solve on the card: the wide frame
    (``_wide_rows``) and the same rows with ``num`` 0, each against the
    plain version and K1, ungated and gated.  Returns the max abs
    difference."""
    import torch
    w = _wrappers()
    err = 0.0
    wide = _wide_rows()
    empty = dict(wide, num_contacts=torch.zeros((), dtype=torch.int32,
                                                device="cuda"))
    for what, args in (("the wide frame (levels of 320, 20 x 5, 40 and "
                        "10 rows)", wide), ("the same rows with num 0",
                                            empty)):
        for tols in (None, torch.tensor([0.05, 0.02], device="cuda")):
            a = dict(args, tols=tols)
            err = max(err, _compare(w["K2"], a)[0], _k1_equals_k2(a))
        print(f"# compare: K2 == plain, K1 == K2 at {what}, gates off and "
              f"on; max abs diff {err}", flush=True)
    return err


def _k2_acc_in_device_memory(args) -> float:
    """K2 with its accumulators in device memory: the contact frame
    ``args`` with its row slots padded (zero rows, not visited) to the most
    the tier rule lets K2 take beside its bodies, where the accumulators no
    longer fit beside the ring (``fused_layout``).  Against the plain
    version, ungated and gated; returns the max abs difference."""
    import torch
    from phyx_tpu_torch.kernels.contact_solver import (SMEM_LIMIT, fits,
                                                       fused_layout)
    n, r = args["body_flat"].numel() // 8, args["b1"].numel()
    pad = (SMEM_LIMIT // 4 - 8 * n) // 4 - r
    big = r + pad
    if not (fits(n, big) and not fused_layout(n, big)["acc_smem"]):
        raise AssertionError(f"{n} bodies, {big} rows: not the placement "
                             "of the accumulators in device memory")

    def padded(t, width):
        return torch.cat([t, t.new_zeros(pad * width)])

    out = dict(args, b1=padded(args["b1"], 1), b2=padded(args["b2"], 1),
               con_flat=padded(args["con_flat"], 12),
               warm_flat=padded(args["warm_flat"], 2), c_cap=big)
    err = _compare(_wrappers()["K2"], out)[0]
    skip = torch.full((2,), 1e30, dtype=torch.float32, device="cuda")
    err = max(err, _compare(_wrappers()["K2"], dict(
        out, vel_iters=2, pos_iters=2, tols=skip))[0])
    print(f"# compare: K2 == plain with its accumulators in device memory "
          f"({n} bodies, {big} row slots), gates off and on; max abs diff "
          f"{err}", flush=True)
    return err


def phase_compare() -> dict:
    """K1 and K2 against the plain version, and K1 against K2, on small
    frames, gates off and on.  Returns the max abs differences."""
    from phyx_tpu_torch.kernels.contact_solver import \
        solve_contacts_fused_levels_plain
    from phyx_tpu_torch.step import solve_inputs, stats_dict
    w = _wrappers()
    errs = dict(K1=0.0, K2=0.0)
    errs["K2"] = _k2_wide_and_empty()
    for kind in ("pile", "bridge", "net"):
        st, cfg, what = _small_frame(kind)
        stats = stats_dict(st.stats)
        if kind == "pile" and stats["num_contacts"] < 200:
            raise AssertionError(f"small pile has only "
                                 f"{stats['num_contacts']} contacts")
        if kind == "bridge" and stats["num_contacts"] < 2:
            raise AssertionError("no contacts on the loaded bridge")
        gated = cfg.replace(velocity_rel_tol=1e-2, position_rel_tol=1e-2)
        for c in (cfg, gated):
            args = solve_inputs(st, c)
            for name in ("K1", "K2"):
                errs[name] = max(errs[name], _compare(w[name], args)[0])
            _k1_equals_k2(args)
            errs["K2"] = max(errs["K2"], _equal(
                "K2 vs its schedule's plain version", w["K2"](**args),
                solve_contacts_fused_levels_plain(**args)))
        if kind == "pile":
            errs["K2"] = max(errs["K2"], _k2_acc_in_device_memory(args))
        rows = args["b1"].numel()
        numj = 0 if args["num_joints"] is None else int(args["num_joints"])
        print(f"# compare: K1 == plain, K2 == plain, K1 == K2, K2 == its "
              f"schedule's plain version on a {what} "
              f"({stats['num_contacts']} contacts, {numj} joints, {rows} "
              f"slots), gates off and on; max abs diff {errs}", flush=True)
    return errs


# small multi-slab frames: 128 bodies a slab (stride 256 less the zero
# block), windows of 512 rows, 4 + 2 passes
TILED_SMALL = dict(max_bodies=512, max_pairs=1024, broadphase="sap_grid",
                   sap_window=48, solver_backend="pallas_tiled",
                   tile_stride=256, tile_halo=256, velocity_iterations=4,
                   position_iterations=2)


def _tiled_frames():
    """Small tiled frames on the card: (state, cfg, description, kernels)."""
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.step import rollout
    cfg = SimConfig(**TILED_SMALL)
    yield (rollout(scenes.pile(cfg, 300, seed=0).build(), cfg, 30), cfg,
           "300-box pile over 3 slabs", ("K3", "K5"))
    sb = scenes.pile(cfg, 200, seed=1)
    # tests/test_tiled_solver.py's belt: a kinematic static, which keeps
    # its own embedded row
    sb.add_box((60.0, 0.25), (3.0, 0.25), static=True, friction=0.9,
               velocity=(2.0, 0.0))
    sb.add_box((60.0, 1.0), (0.4, 0.4), friction=0.9)
    yield (rollout(sb.build(), cfg, 30), cfg,
           "200-box pile with a moving static", ("K3", "K5"))
    jcfg = SimConfig(**dict(TILED_SMALL, max_bodies=32, max_joints=32))
    yield (rollout(scenes.bridge(jcfg, 8, load_boxes=3).build(), jcfg, 50),
           jcfg, "loaded bridge", ("K5",))
    yield (rollout(scenes.net(jcfg, 6).build(), jcfg, 20), jcfg, "net",
           ("K5",))


def phase_compare_tiled() -> dict:
    """K3 and K5 on small tiled frames, gates off and on: against both
    plain versions (serial and levels), their pre-pass against
    ``slab_levels``, and every placement of their per-row arrays against
    the wrapper's.  Returns, per kernel, the max abs difference and, on the
    first frame (ungated), its time, the plain version's and the bound."""
    from phyx_tpu_torch.step import solve_inputs
    wrappers = _wrappers()
    out = {name: dict(max_abs_err=0.0) for name in ("K3", "K5")}
    for st, cfg, what, names in _tiled_frames():
        gated = cfg.replace(velocity_rel_tol=1e-2, position_rel_tol=1e-2)
        for name in names:
            rec = out[name]
            for c in (cfg, gated):
                args = solve_inputs(st, c, "tiled2" if name == "K3"
                                    else "tiled")
                err, plain_ms = _compare(wrappers[name], args)
                lev = _equals_levels_plain(name, args, f"a {what}")
                placed = _tiled_placed(name, args, f"a {what}")
                rec["max_abs_err"] = max(
                    rec["max_abs_err"], err, lev["max_abs_err_levels_plain"],
                    placed["max_abs_err_placements"])
                if "ms" not in rec:
                    walked = _walked(name, args)
                    rec.update(ms=_kernel_ms(wrappers[name], args, reps=5),
                               plain_ms=plain_ms, frame=what,
                               walked_slots=walked,
                               **_bound_slabs(args, walked))
            levels = _tiled_levels(name, args, f"a {what}")["levels"]
            print(f"# compare: {name} == serial plain == levels plain on a "
                  f"{what}, gates off and on, in every placement; pre-pass "
                  f"== slab_levels ({levels} levels a pass)", flush=True)
        # K5 is compared last on every frame: its per-slab counts
        n_slabs = args["n_slabs"]
        counts = args["slab_counts"].tolist()
        used = sum(x > 0 for x in counts[:n_slabs])
        if what.startswith("300") and used < 3:
            raise AssertionError(f"{what}: contacts in {used} slabs")
        print(f"# compare: {' and '.join(names)} on a {what} ({used} of "
              f"{n_slabs} slabs with contacts, {sum(counts[n_slabs:])} joint "
              f"rows); max abs diff "
              f"{ {k: v['max_abs_err'] for k, v in out.items()} }",
              flush=True)
    return out


# tests/test_torch_sweep.py's band grid: 4 y-bands 120 apart, x cells 40
# apart; 64 envs of 24 boxes fill two sweep slabs (K 1024)
ENVS_SMALL = dict(max_bodies=2048, max_pairs=8192, broadphase="sap_tiled",
                  solver_backend="pallas_tiled", tile_stride=1024,
                  tile_halo=1024, sweep_band_h=120.0, sweep_band_y0=-60.0,
                  sweep_band_span=1024.0)


def _jittered_envs(segmented: bool):
    """64 envs x 24 boxes on the band grid, with numpy-made rotations and
    position noise (so boxes overlap), on the card: (cfg, bodies)."""
    import numpy as np
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
    from phyx_tpu_torch.parallel.envs import concat_envs
    cfg = SimConfig(**ENVS_SMALL, **(dict(
        sweep_band_rows=25, sweep_band_n=4, sweep_band_cols=16)
        if segmented else {}))
    mega, _, _ = concat_envs(
        [scenes.pile(cfg, 24, seed=s, ground_half=8.0) for s in range(64)],
        cfg, band_width=40.0, y_bands=4, band_height=120.0)
    st = state_to_numpy(mega.build("cpu"))
    rng = np.random.default_rng(9)
    b = st.bodies
    box = (b.inv_mass > 0) & b.active
    b.pos[box] += rng.normal(0.0, 0.06, (box.sum(), 2)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, box.sum())
    b.rot[box] = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return cfg, state_from_numpy(st, "cuda").bodies


def _numpy_rows(seed: int, max_pairs: int) -> dict:
    """tests/test_torch_sweep.py's rows on the card: sorted over two slabs
    (K 1024, W 2048), narrow intervals and five wide ones near the first
    slab's end, whose walks reach the window end."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    K, W, n_slabs = 1024, 2048, 2
    npad, nact = (n_slabs - 1) * K + W, 2900
    xlo = np.sort(rng.uniform(0.0, 1000.0, nact))
    xhi = xlo + rng.uniform(0.0, 1.5, nact)
    xhi[rng.choice(np.arange(990, 1024), 5, replace=False)] = 5000.0
    ylo = rng.uniform(0.0, 10.0, nact)
    yhi = ylo + rng.uniform(0.5, 3.0, nact)
    pad = np.full(npad - nact, np.inf)
    rows = np.stack([np.concatenate([c, pad]) for c in (xlo, ylo, xhi, yhi)])
    dyn = np.concatenate([(rng.random(nact) < 0.7), np.zeros(npad - nact)])
    order = np.concatenate([rng.permutation(nact),
                            np.full(npad - nact, np.iinfo(np.int32).max)])

    def card(x, dtype):
        return torch.from_numpy(x.astype(dtype)).cuda()

    return dict(rows=card(rows, np.float32), dyn=card(dyn, np.int32),
                order=card(order, np.int32),
                nact=torch.full((), nact, dtype=torch.int32, device="cuda"),
                max_pairs=max_pairs, n_slabs=n_slabs, slab_stride=K,
                window_rows=W, truex=None)


def _dense_rows(seed: int, max_pairs: int) -> dict:
    """tests/test_torch_sweep_onepass.py's rows on the card: one slab (K
    1024, W 2048) whose first tile of 256 sweeps is packed into 5 units of
    x with overlapping y, ~17,000 pairs in that tile, past its stage of
    2,048 pairs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    K, W, nact, nfirst = 1024, 2048, 1100, 256
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

    def card(x, dtype):
        return torch.from_numpy(x.astype(dtype)).cuda()

    return dict(rows=card(rows, np.float32), dyn=card(dyn, np.int32),
                order=card(order, np.int32),
                nact=torch.full((), nact, dtype=torch.int32, device="cuda"),
                max_pairs=max_pairs, n_slabs=1, slab_stride=K,
                window_rows=W, truex=None)


def _compare_sweep(args) -> tuple:
    """K4 against its plain version on the same CUDA tensors: the pairs on
    [0, num) and the three counters.  Returns (mismatches, the plain
    version's counters, its ms), raising on any mismatch."""
    got = _wrappers()["K4"](**args)
    _sync()
    t0 = time.perf_counter()
    ref = _plains()["K4"](**args)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(zip(("num", "ovf_drop", "ovf_window"),
                      (int(x) for x in ref[2:])))
    bad = sum(int(g) != c for g, c in zip(got[2:], counts.values()))
    num = counts["num"]
    bad += sum(int((g[:num] != r[:num]).sum()) for g, r in zip(got[:2],
                                                                 ref[:2]))
    if bad:
        raise AssertionError(f"K4 differs from its plain version: {bad} "
                             f"mismatches (plain {counts}, kernel "
                             f"{[int(x) for x in got[2:]]})")
    return bad, counts, plain_ms


def phase_compare_sweep() -> dict:
    """K4 against its plain version on small inputs on the card: the
    two-slab banded env mega-scene (true-x accept on and off, and its
    budget cut to half its pairs), the same in the segmented layout,
    numpy-made rows that force ``ovf_window`` and, with a small budget,
    ``ovf_drop``, and rows whose first tile's pairs outgrow the kernel's
    stage (the budget whole and cut), where the tile walks again (the
    schedule's plain version counts such tiles).  Returns the max mismatch
    count, the kernels one call launches and, on the first input, K4's
    device time, its plain version's and the bound."""
    from phyx_tpu_torch.broadphase import _sap_tiled_sort_stage, compute_aabbs
    from phyx_tpu_torch.kernels.sweep_tiled import \
        sweep_emit_tiled_onepass_plain
    cases = []
    for layout in ("banded", "segmented"):
        cfg, bodies = _jittered_envs(layout == "segmented")
        lo, hi = compute_aabbs(bodies)
        args = _sap_tiled_sort_stage(bodies, cfg, lo, hi)[0]
        cases += [(f"64-env {layout} mega-scene, true-x accept", args, None),
                  (f"64-env {layout} mega-scene, true-x off",
                   dict(args, truex=None), None)]
    half = int(_plains()["K4"](**cases[0][1])[2]) // 2
    cases += [("64-env banded mega-scene, budget cut to half its pairs",
               dict(cases[0][1], max_pairs=half), "ovf_drop")]
    cases += [(f"numpy rows, budget {mp}", _numpy_rows(7, mp), counter)
              for mp, counter in ((8192, "ovf_window"), (1024, "ovf_drop"))]
    cases += [(f"rows past a tile's stage, budget {mp}", _dense_rows(3, mp),
               counter) for mp, counter in ((32768, "stage"),
                                            (9216, "ovf_drop"))]
    worst, out = 0, {}
    for what, args, counter in cases:
        err, counts, plain_ms = _compare_sweep(args)
        worst = max(worst, err)
        if not out:
            _PROBES["K4"] = (what, lambda a=args: _wrappers()["K4"](**a))
            out = dict(ms=_sweep_device_ms(args, reps=20)["device_ms"],
                       plain_ms=plain_ms,
                       bound_ms=_bound_sweep(args, counts["num"])["bound_ms"])
        again = sweep_emit_tiled_onepass_plain(**args)[5]
        if counter is None and not (counts["num"] > 300
                                    and counts["ovf_drop"] == 0
                                    and counts["ovf_window"] == 0):
            raise AssertionError(f"K4 on the {what}: {counts}")
        if counter == "stage" and not again:
            raise AssertionError(f"K4 on the {what}: no tile outgrew its "
                                 "stage")
        if counter not in (None, "stage") and counts[counter] <= 0:
            raise AssertionError(f"K4 on the {what}: no {counter}: {counts}")
        print(f"# compare: K4 == plain on the {what} ({args['n_slabs']} "
              f"slabs of {args['slab_stride']}, window "
              f"{args['window_rows']}): {counts}, {again} tiles walked "
              "again", flush=True)
    return dict(out, max_abs_err=worst)


def _emit_rows(n: int, na: int, seed: int, max_pairs: int,
               perturb: str = "") -> dict:
    """tests/test_torch_sweep_emit.py's rows on the card: ``na`` of ``n``
    active, a long static ground across every chunk (row 0), inactive tail
    rows sorted last with their real AABBs.  ``perturb``: "unsorted" puts
    the active rows out of x order (a run reversed, rows swapped across
    chunks), "nan" puts NaN in a lox inside chunk 1, a hiy and a hix of
    chunk 2 (tests/test_torch_sweep_onepass.py's cases).  Returns (K6's
    arguments, K7's arguments)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    spread = 120.0
    lox = rng.uniform(0.0, spread, n)
    loy = rng.uniform(0.0, spread / 3.0, n)
    w = rng.uniform(0.2, 2.0, (n, 2))
    dyn = (rng.random(n) < 0.8).astype(np.int32)
    lox[0], loy[0], w[0], dyn[0] = -1.0, -0.5, (spread + 2.0, 1.5), 0
    aabb = np.stack([lox, loy, lox + w[:, 0], loy + w[:, 1]],
                    1).astype(np.float32)
    keys = np.where(np.arange(n) < na, aabb[:, 0], np.inf)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    if perturb == "unsorted":
        order[1100:1160] = order[1100:1160][::-1]
        a = rng.choice(np.arange(1, 1000), 12, replace=False)
        b = rng.choice(np.arange(2100, na), 12, replace=False)
        order[a], order[b] = order[b], order[a].copy()
    elif perturb == "nan":
        for row, col in ((order[1500], 0), (order[1700], 3),
                         (order[2200], 2)):
            aabb[row, col] = np.nan

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    common = dict(order=card(order), max_pairs=max_pairs,
                  nact=torch.full((), na, dtype=torch.int32, device="cuda"))
    return (dict(common, aabb_flat=card(aabb[order].reshape(-1)),
                 dyn=card(dyn[order])),
            dict(common, aabb_flat=card(aabb.reshape(-1)), dyn=card(dyn)))


def _compare_emit(name: str, args) -> tuple:
    """K6 or K7 against its plain version on the same CUDA tensors: the
    whole pair buffer (EMPTY from num on), ``num`` and ``ovf``.  Returns
    (mismatches, the plain version's counters, its ms, the kept pairs),
    raising on any mismatch."""
    got = _wrappers()[name](**args)
    _sync()
    t0 = time.perf_counter()
    ref = _plains()[name](**args)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(num=int(ref[2]), ovf=int(ref[3]))
    bad = sum(int(g) != c for g, c in zip(got[2:], counts.values()))
    bad += sum(int((g != r).sum()) for g, r in zip(got[:2], ref[:2]))
    if bad:
        raise AssertionError(f"{name} differs from its plain version: {bad} "
                             f"mismatches (plain {counts}, kernel "
                             f"{[int(x) for x in got[2:]]})")
    num = counts["num"]
    kept = set(zip(ref[0][:num].tolist(), ref[1][:num].tolist()))
    return bad, counts, plain_ms, kept


def _bound_emit(args, num: int, chunked: bool) -> dict:
    """The least time for K6 or K7 on ``args``: the ``nact`` rows the sweep
    touches read once (16 B of AABB, 4 of dyn, 4 of order), ``nact`` read,
    the ``num`` kept pairs (8 B each) and the two counters written once,
    over HBM's rate; against the float operations of the serial sweep's
    candidate tests on these rows (per active row one x test per walked
    candidate and the closing one; per walked candidate two y compares and
    the dyn sum and its test) over the card's float32 peak.  The larger
    bounds it."""
    import torch
    nact = int(args["nact"])
    aabb = args["aabb_flat"].view(-1, 4)
    if not chunked:
        aabb = aabb[args["order"][:nact].long()]
    lox, hix = aabb[:nact, 0], aabb[:nact, 2]
    # rows walked: those after the row whose lox <= its hix (sorted lox)
    ends = torch.searchsorted(lox.contiguous(), hix.contiguous(),
                              right=True)
    idx = torch.arange(nact, device=lox.device)
    walked = int(torch.clamp(ends - idx - 1, min=0).sum())
    nbytes = nact * 24 + 4 + num * 8 + 8
    ops = nact + walked * 5
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, rows_read=nact, walked=walked)


def _split_device_ms(stages, wrapper, args, reps: int) -> dict:
    """A sweep's device time alone: its launch (``stages``, (name,
    callable) on buffers made beforehand; none to time only the wrapper)
    timed on CUDA events, then the whole wrapper on ``args``, each
    ``reps`` times, all queued behind a ~100 ms sleep kernel so that the
    events time device work, not the host's pace (``device_only`` says
    whether the host's enqueue did finish inside the sleep).  Returns ms
    per call: ``<name>_ms`` per stage, their sum ``device_ms`` and
    ``wrapper_device_ms``."""
    import torch
    for _, fn in stages:
        fn()
    wrapper(**args)             # warm-up
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(stages)
                                                              + 1)]
          for _ in range(reps)]
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    _sync()
    sleep = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for e in ev:
        e[0].record()
        for i, (_, fn) in enumerate(stages):
            fn()
            e[i + 1].record()
    whole[0].record()
    for _ in range(reps):
        wrapper(**args)
    whole[1].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    _sync()
    split = {f"{name}_ms": sum(e[i].elapsed_time(e[i + 1]) for e in ev) / reps
             for i, (name, _) in enumerate(stages)}
    return dict(split, device_ms=sum(split.values()),
                wrapper_device_ms=whole[0].elapsed_time(whole[1]) / reps,
                device_only=host_ms < sleep.elapsed_time(ev[0][0]))


def _emit_device_ms(name: str, args, reps: int) -> dict:
    """K6's or K7's device time alone (``_split_device_ms``): its one
    launch on buffers made beforehand, and the whole wrapper; also the
    wrapper's pace back to back, which the host sets when it exceeds the
    device time."""
    import torch
    from phyx_tpu_torch.kernels.sweep import (WARP_COUNTS_SMEM, chunked_pass,
                                              warp_pass)
    a = tuple(args[k] for k in ("aabb_flat", "order", "dyn", "nact"))
    dev = args["aabb_flat"].device
    i32 = dict(dtype=torch.int32, device=dev)
    n = args["order"].numel()
    pi, pj = (torch.empty((args["max_pairs"],), **i32) for _ in range(2))
    wrapper = _wrappers()[name]
    if name == "K6":
        counters = torch.empty((2,), **i32)
        stages = (("kernel", lambda: chunked_pass(
            *a, pi, pj, counters, args["max_pairs"])),)
    else:
        num, ovf = (torch.empty((), **i32) for _ in range(2))
        scratch = None if 4 * n <= WARP_COUNTS_SMEM else torch.empty(
            (n,), **i32)
        stages = (("kernel", lambda: warp_pass(
            *a, pi, pj, num, ovf, args["max_pairs"], scratch)),)
    out = _split_device_ms(stages, wrapper, args, reps)
    return dict(out, wrapper_ms=_kernel_ms(wrapper, args, reps=reps))


# kernels whose launches a call are counted, by name: (where, one call)
_PROBES: dict = {}
# stages of frames whose CUDA kernels the same session counts and times:
# name -> (where, function)
_FRAMES: dict = {}
# the sleep kernel ahead of each profiled call (~10 ms on the H100): the
# host queues the call while it runs, so the call's device span shows the
# device's own pace (``device_only`` says whether the host did finish)
PROFILE_SLEEP_CYCLES = 20_000_000
# the CUDA kernels of ``phyx_tpu_torch/csrc`` (K1, K3 and K5 each launch
# the pre-pass visit_levels over their visit map with free rows, its last
# template argument true, then level_solve, then the two of the rerun over
# the full graph, which return at once unless the first set the fallback
# flag; K2, K4, K6 and K7 one kernel each), and the kernel that marks one
# launch of each wrapper: every name part must be in the kernel's name
HAND_KERNELS = ("visit_levels", "level_solve", "contact_solve_fused",
                "tiled_onepass", "chunked_onepass", "warp_sweep")
LAUNCH_MARKS = dict(K1=("visit_levels", "RowsMap", "true>("),
                    K2=("contact_solve_fused",),
                    K3=("visit_levels", "CumSlots", "true>("),
                    K4=("tiled_onepass",),
                    K5=("visit_levels", "BudgetSlots", "true>("),
                    K6=("chunked_onepass",), K7=("warp_sweep",))


# the profiler session's device events and the profiler's warnings
_SESSION: dict = {}


def _profiled_calls(calls: dict, launched: dict, host_ms: dict):
    """One torch.profiler session of every call in ``calls``, each queued
    behind a sleep kernel; fills each call's wrapper launches and host ms
    to queue it.  Returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the first launches after the session starts can go unrecorded
        # (a fast host reaches them before the collection does): a
        # preamble of kernels that no marker counts, then a pause
        warm = torch.zeros((1,), device="cuda")
        for _ in range(8):
            warm.add_(1.0)
        _sync()
        time.sleep(0.2)
        for name, (_, fn) in calls.items():
            torch.cuda._sleep(PROFILE_SLEEP_CYCLES)
            _reset_counts()
            t0 = time.perf_counter()
            fn()
            host_ms[name] = (time.perf_counter() - t0) * 1e3
            launched[name] = _counts()
        _sync()
    return prof


def _kernels_a_call() -> dict:
    """The names of the CUDA kernels one call of each probe in ``_PROBES``
    launches, and, for one call of each entry of ``_FRAMES``: the count,
    summed device time and device span (first start to last end) of the
    CUDA kernels it launches, the hand-written ones by name
    (``HAND_KERNELS``), the wrappers' launch counts in the call and the
    host's ms to queue it, from torch.profiler's device events, all in one
    profiler session (a second session in a process has returned no
    device events on the card).  CUPTI records the kernels a CUDA graph
    replay runs as it records any other.  Each call is queued behind a
    sleep kernel, which marks where its kernels start.  Raises unless
    each probe launches exactly one kernel and each frame entry at least
    one."""
    import collections
    import tempfile

    import torch
    calls = {**_PROBES, **_FRAMES}
    for _, fn in calls.values():
        fn()                  # warm-up: builds, caches and captures outside
    _sync()
    launched, host_ms = {}, {}
    # the profiler's own warnings (CUPTI's dropped records among them) go
    # to the process's stderr: kept for the session's record, then passed on
    sys.stderr.flush()
    saved_fd, log = os.dup(2), tempfile.TemporaryFile()
    os.dup2(log.fileno(), 2)
    try:
        prof = _profiled_calls(calls, launched, host_ms)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
    finally:
        sys.stderr.flush()
        os.dup2(saved_fd, 2)
        os.close(saved_fd)
        log.seek(0)
        text = log.read().decode(errors="replace")
        log.close()
        sys.stderr.write(text)
    warnings = [line.strip() for line in text.splitlines()
                if any(w in line.lower() for w in ("drop", "cupti", "lost"))]
    _SESSION.update(device_events=len(events), calls=len(calls),
                    profiler_warnings=warnings[:20],
                    profiler_warning_lines=len(warnings))
    print(f"# profiler session: {len(events)} device events for "
          f"{len(calls)} calls; {len(warnings)} lines of the profiler's "
          f"warnings name drops, CUPTI or losses: {warnings[:5]}",
          flush=True)
    marks = [e for e in events
             if "spin_kernel" in e.name or "sleep" in e.name.lower()]
    if len(marks) != len(calls):
        raise AssertionError(f"the trace holds {len(marks)} sleep kernels "
                             f"for {len(calls)} calls ({len(events)} device "
                             f"events; the profiler warned {warnings[:5]}): "
                             "it lost or gained some")
    names, seen, sleep_ms, current = iter(calls), {}, {}, None
    for e in events:
        if "spin_kernel" in e.name or "sleep" in e.name.lower():
            current = seen[next(names)] = []
            sleep_ms[list(seen)[-1]] = e.time_range.elapsed_us() / 1e3
        elif current is not None:
            current.append(e)
    out = {}
    for name, (where, _) in _PROBES.items():
        kernels = [e.name for e in seen.get(name, [])]
        if name not in seen or len(kernels) != 1:
            raise AssertionError(f"one {name} call at {where} launched "
                                 f"{len(kernels)} kernels: {kernels[:8]}")
        print(f"# kernels a call: one {name} call at {where} launches "
              f"{kernels}", flush=True)
        out[name] = kernels
    for name, (where, _) in _FRAMES.items():
        kernels = seen.get(name)
        if not kernels:
            raise AssertionError(f"one call of {name} at {where} showed "
                                 "no CUDA kernel")
        out[name] = dict(
            kernels=len(kernels),
            busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            span_ms=(max(e.time_range.end for e in kernels)
                     - min(e.time_range.start for e in kernels)) / 1e3,
            hand=dict(collections.Counter(
                e.name for e in kernels
                if any(h in e.name for h in HAND_KERNELS))),
            launched=launched[name], host_ms=host_ms[name],
            device_only=host_ms[name] < sleep_ms[name])
        print(f"# kernels a call: {name} at {where} launches "
              f"{out[name]['kernels']} CUDA kernels, "
              f"{out[name]['busy_ms']:.3f} ms of them on the device",
              flush=True)
    return out


def _emit_at(name: str, args, what: str, chunked: bool) -> dict:
    """The kernel ``name`` against its plain version on ``args``, timed,
    with its bound."""
    err, counts, plain_ms, _ = _compare_emit(name, args)
    out = dict(max_abs_err=err, plain_ms=plain_ms, emitted=counts["num"],
               ovf=counts["ovf"], **_emit_device_ms(name, args, reps=20),
               **_bound_emit(args, counts["num"], chunked))
    out["ms"] = out.pop("device_ms")
    split = f"kernel {out['kernel_ms']:.4f}"
    print(f"# compare: {name} == plain at {what} ({out['rows_read']} active "
          f"of {args['order'].numel()} rows, {out['walked']} candidates "
          f"walked): {counts}; device {out['ms']:.4f} ms a call ({split}; "
          f"the wrapper {out['wrapper_device_ms']:.4f}), bound "
          f"{out['bound_ms']:.6f} ms", flush=True)
    return out


def phase_compare_emit() -> dict:
    """K6 and K7 against their plain versions on small inputs on the card:
    a 200-box pile frame at cap 1024, numpy-made rows over three chunks
    with a long static ground and inactive tail rows, and the same at a
    small budget, where both count ``ovf`` and keep different pairs; K6
    also on those rows out of x order (whole and at a cut budget) and with
    NaN AABBs, where its proof must refuse the short walk.  Returns, per
    kernel, the max mismatch count and, on the pile frame, its device
    time, its plain version's and the bound, and K6's kernels a call."""
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.broadphase import sap_kernel_inputs
    from phyx_tpu_torch.kernels.sweep import sorted_chunks
    from phyx_tpu_torch.step import integrate_velocities, rollout
    cfg = SimConfig(max_bodies=1024, max_pairs=2048, broadphase="sap_grid",
                    sap_window=64, solver_backend="pallas")
    st = rollout(scenes.pile(cfg, 200, seed=0).build(), cfg, 40)
    bodies = integrate_velocities(st.bodies, cfg)
    out = {name: _emit_at(name, sap_kernel_inputs(
        bodies, cfg.max_pairs, name == "K6"), "the 200-box pile frame",
        name == "K6") for name in ("K6", "K7")}
    k6_args = sap_kernel_inputs(bodies, cfg.max_pairs, True)
    _PROBES["K6"] = ("the 200-box pile frame",
                     lambda: _wrappers()["K6"](**k6_args))
    for budget in (16384, 256):
        k6, k7 = _emit_rows(3072, 2500, 2, budget)
        kept = {}
        for name, args in (("K6", k6), ("K7", k7)):
            err, counts, _, kept[name] = _compare_emit(name, args)
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            if (counts["ovf"] > 0) != (budget == 256) or counts["num"] < 256:
                raise AssertionError(f"{name} on the numpy rows, budget "
                                     f"{budget}: {counts}")
        which = "different" if kept["K6"] != kept["K7"] else "the same"
        # both keep every pair below the budget; past it, their orders
        # keep different ones
        if (which == "different") != (budget == 256):
            raise AssertionError(f"K6 and K7 kept {which} pairs at budget "
                                 f"{budget}")
        print(f"# compare: K6 == plain, K7 == plain on numpy rows over 3 "
              f"chunks (2500 active, a static ground, inactive tail), "
              f"budget {budget}: {counts}; K6 and K7 keep {which} pairs",
              flush=True)
    # K6 on rows out of x order and on NaN rows: its proof must refuse the
    # short walk there (the schedule's plain version shows which chunks it
    # proves)
    for perturb, budget in (("unsorted", 65536), ("nan", 16384),
                            ("unsorted", 1000)):
        k6 = _emit_rows(3072, 2500, 4, budget, perturb)[0]
        err, counts, _, _ = _compare_emit("K6", k6)
        out["K6"]["max_abs_err"] = max(out["K6"]["max_abs_err"], err)
        proof = sorted_chunks(k6["aabb_flat"], k6["nact"])
        if all(proof) or counts["num"] < 256:
            raise AssertionError(f"K6 on the {perturb} rows, budget "
                                 f"{budget}: {counts}, proof {proof}")
        print(f"# compare: K6 == plain on numpy rows over 3 chunks, "
              f"{perturb}, budget {budget}: {counts}; chunks proven sorted "
              f"{proof}", flush=True)
    return out


def _close(host, card, what: str) -> float:
    """Every State tensor of ``card`` against ``host`` (the same frame on
    the CPU): integers equal, floats within 1e-4.  Returns the max float
    diff."""
    import dataclasses

    import numpy as np
    worst = 0.0
    for rec in ("bodies", "joints", "cache", "stats"):
        for f in dataclasses.fields(getattr(host, rec)):
            a = getattr(getattr(host, rec), f.name).numpy()
            b = getattr(getattr(card, rec), f.name).cpu().numpy()
            if a.dtype.kind in "biu":
                if not np.array_equal(a, b):
                    raise AssertionError(f"{what}: {rec}.{f.name} differs "
                                         "between the card and the CPU")
            elif a.size:
                d = float(np.abs(a.astype(np.float64) - b).max())
                worst = max(worst, d)
                if not d <= 1e-4:
                    raise AssertionError(f"{what}: {rec}.{f.name} off by "
                                         f"{d}")
    return worst


def phase_step_parity() -> float:
    """The whole step on the card against the same step on the CPU (whose
    stages the CPU tests hold to the JAX package), re-synced every frame:
    integers exact, floats within 1e-4.  Returns the max float diff."""
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
    from phyx_tpu_torch.parallel.envs import concat_envs
    from phyx_tpu_torch.step import release_graphs, rollout, step
    pile = SimConfig(max_bodies=64, max_pairs=256, broadphase="sap_grid",
                     sap_window=32, solver_backend="pallas")
    jointed = SimConfig(max_bodies=32, max_pairs=128, max_joints=32,
                        broadphase="sap_grid", sap_window=16,
                        solver_backend="pallas")
    tiled = SimConfig(**dict(TILED_SMALL, max_bodies=256))
    routed = tiled.replace(tiled_routing=False)
    tiled_pile = rollout(scenes.pile(tiled, 150, seed=0).build("cpu"),
                         tiled, 6)
    # tests/test_torch_envs.py's 8-env band grid through "sap" (K4)
    envs = SimConfig(**dict(TILED_SMALL, max_bodies=256, broadphase="sap",
                            sap_long_k=4, sweep_band_h=120.0,
                            sweep_band_y0=-60.0, sweep_band_span=256.0))
    mega, _, _ = concat_envs(
        [scenes.pile(envs, 24, seed=s, ground_half=8.0) for s in range(8)],
        envs, band_width=40.0, y_bands=4, band_height=120.0)
    env_state = rollout(mega.build("cpu"), envs, 4)
    # the emission kernels' steps: tests/test_torch_sweep_emit.py's pile at
    # cap 512 (K7 + K2), and the 8-env scene under "sap" at cap 1024 with
    # 16,384 contact slots, past the fused kernel's shared memory (K6 + K1)
    fast = dict(solver_backend="pallas", velocity_iterations=4,
                position_iterations=2)
    k7_pile = SimConfig(max_bodies=512, max_pairs=1024,
                        broadphase="sap_kernel", **fast)
    k6_envs = SimConfig(max_bodies=1024, max_pairs=8192, broadphase="sap",
                        sweep_band_h=120.0, sweep_band_y0=-60.0,
                        sweep_band_span=256.0, **fast)
    mega6, _, _ = concat_envs(
        [scenes.pile(k6_envs, 24, seed=s, ground_half=8.0) for s in range(8)],
        k6_envs, band_width=40.0, y_bands=4, band_height=120.0)
    # (what, config, state, the kernels a card step launches once each)
    cases = (
        ("60-box pile", pile, scenes.pile(pile, 60, seed=1).build("cpu"),
         ("K2",)),
        ("20-link chain", jointed,
         scenes.chain(jointed, 20).build("cpu"), ("K2",)),
        ("loaded bridge", jointed, rollout(scenes.bridge(
            jointed, 8, load_boxes=3).build("cpu"), jointed, 50), ("K2",)),
        ("150-box tiled pile (K3)", tiled, tiled_pile, ("K3",)),
        ("150-box tiled pile, routed (K5)", routed, tiled_pile, ("K5",)),
        ("8-env mega-scene (K4 + K3)", envs, env_state, ("K3", "K4")),
        ("8-env mega-scene, routed (K4 + K5)",
         envs.replace(tiled_routing=False), env_state, ("K4", "K5")),
        ("200-box pile, sap_kernel (K7 + K2)", k7_pile, rollout(
            scenes.pile(k7_pile, 200, seed=0).build("cpu"), k7_pile, 4),
         ("K2", "K7")),
        ("8-env mega-scene, sap (K6 + K1)", k6_envs,
         rollout(mega6.build("cpu"), k6_envs, 4), ("K1", "K6")),
    )
    worst, traced = 0.0, []
    for what, cfg, st, kernels in cases:
        for frame in range(10):
            _reset_counts()
            card = step(_moved(st, "cuda"), cfg)
            launches = _counts()
            if launches != {k: int(k in kernels) for k in launches}:
                raise AssertionError(f"{what} frame {frame}: launches "
                                     f"{launches}")
            st = step(st, cfg)
            worst = max(worst, _close(st, card, f"{what} frame {frame}"))
        print(f"# step parity: {what}, 10 frames, card vs CPU: integers "
              f"equal, max float diff so far {worst}", flush=True)
        # the frame captured (a warm-up frame and 2 replays), then two
        # replays of it against two uncaptured steps; the frame's replays
        # traced by the profiler (one scene a configuration: the loaded
        # bridge shares the chain's)
        card = rollout(state_from_numpy(state_to_numpy(st), "cuda"), cfg, 3)
        _replay_equals_steps(card, cfg, what)
        if all(c != cfg for _, c, _ in traced):
            _trace(what, card, cfg, kernels)
            traced.append((what, cfg, card))
        release_graphs()
    return worst


def _bits(t):
    """A tensor's bits: float32 as int32, so that -0.0 and NaN compare
    as what they are."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _replay_equals_steps(st, cfg, what: str) -> dict:
    """Two graph replays of ``cfg``'s captured frame (``rollout``, which
    must hold it already: the call replays both frames and no wrapper
    launches) against two uncaptured steps from the same state: every
    State tensor equal to the bit.  Returns the graph's pool bytes
    (``graph_info``)."""
    import dataclasses
    import torch
    from phyx_tpu_torch.step import _GRAPHS, graph_info, rollout, step
    if (cfg, st.bodies.pos.device) not in _GRAPHS:
        raise AssertionError(f"{what}: no captured frame to replay")
    _reset_counts()
    replayed = rollout(st, cfg, 2)
    if any(_counts().values()):
        raise AssertionError(f"{what}: two replays launched {_counts()} "
                             "outside the graph")
    stepped = step(step(st, cfg), cfg)
    for rec in dataclasses.fields(stepped):
        a, b = getattr(replayed, rec.name), getattr(stepped, rec.name)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if not torch.equal(_bits(x), _bits(y)):
                raise AssertionError(f"{what}: {rec.name}.{f.name} after two "
                                     "replays differs from two steps")
    info = next(g for g in graph_info()
                if g["cfg"] == cfg and g["frame"] == "step")
    print(f"# graph replay: {what}: two replays == two uncaptured steps, "
          f"every State tensor to the bit; the graph's pool "
          f"{info['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    return dict(pool_bytes=info["pool_bytes"])


def _kernel_ms(wrapper, args, reps: int) -> float:
    import torch
    wrapper(**args)          # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        wrapper(**args)
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _bound(args) -> dict:
    """The least time the card could take for the solve on ``args``
    (ungated passes): each input byte read once and each output byte
    written once over HBM's rate, against the visits' float32 operations
    over the card's peak; the larger bounds it."""
    n = args["body_flat"].numel() // 8
    r = args["b1"].numel()
    num = int(args["num_contacts"])
    numj = 0 if args["num_joints"] is None else int(args["num_joints"])
    v, p = args["vel_iters"], args["pos_iters"]
    # body in and out; each live row's 12 f32, 2 warm f32 and 2 ids read
    # once; the accumulators (all slots) and the residual written once
    nbytes = 2 * n * 32 + (num + numj) * (48 + 8 + 8) + r * 16 + 4
    ops = (num * (OPS["cw"] + v * OPS["cv"] + p * OPS["cp"])
           + numj * (OPS["jw"] + v * OPS["jv"] + p * OPS["jp"]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops,
                visits=(1 + v + p) * (num + numj))


def _walked(name, args) -> int:
    """Slots the tiled kernel ``name`` walks each pass on ``args``."""
    if name == "K3":
        return int(args["cum"][-1])
    n_slabs, j_slots = args["n_slabs"], args["j_slots"]
    c_slots = args["b12"].numel() // 2 // n_slabs - j_slots
    counts = args["slab_counts"].tolist()
    return (sum(min(x, c_slots) for x in counts[:n_slabs])
            + sum(min(x, j_slots) for x in counts[n_slabs:]))


def _bound_slabs(args, walked: int) -> dict:
    """``_bound`` for the tiled kernels: the embedded table in and out,
    each walked slot's 14 f32 and 2 int32 read once, the accumulators (all
    slots) and the residual written once; float operations as contact
    visits (the slots of joint rows are few beside them)."""
    npad = args["body_flat"].numel() // 8
    s = args["b12"].numel() // 2
    v, p = args["vel_iters"], args["pos_iters"]
    nbytes = 2 * npad * 32 + walked * 64 + s * 16 + 4
    ops = walked * (OPS["cw"] + v * OPS["cv"] + p * OPS["cp"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, visits=(1 + v + p) * walked)


def _stage_ms(st, cfg, frames: int, sleep_ms: float = 100.0):
    """Device ms of the step's three parts (``contact_stage``,
    ``solve_stage``, ``finish_stage``), averaged over ``frames`` chained
    frames, from the library's stage timer (``profiling.stage_times``):
    each frame is queued behind a sleep kernel of ``sleep_ms``, so the
    host has queued the stages before the device reaches them and the
    events time device work alone (``device_only`` says whether the
    host's enqueue did finish inside the sleep).  Returns (state after
    the frames, dict of ms)."""
    from phyx_tpu_torch.profiling import stage_times
    st, t = stage_times(st, cfg, frames, sleep_ms)
    extra = ("sleep", "host_enqueue", "device_only")
    stages = [k for k in t if k not in extra]
    out = dict(contact_stage=sum(t[k] for k in
                                 stages[:stages.index("solve")]),
               solve_stage=t["solve"], finish_stage=t["build_cache"])
    out.update((k, t[k]) for k in extra)
    return st, out


def _checked_rate(out: dict, stages: dict, null_below: bool = False
                  ) -> None:
    """The device stages' sum and the host's enqueue of an uncaptured
    frame (``_stage_ms``) beside the slopes.  With ``null_below`` (E-64):
    the uncaptured frame takes at least its device stages' time; where its
    slope reads less it is no rate: that is printed on its own line and
    its steps/s recorded as null (``rate_ok`` False).  (E-64's uncaptured
    frame is host-bound, and its slope read below its device stages in
    earlier runs; a device-bound scene's slope and its stage sum differ
    either way by the two timings' own spread.  A replayed frame runs the
    same kernels from a graph, with less device time between them than
    launches on a stream leave, so it may read below the stages' sum and
    is not nulled.)"""
    device = sum(stages[k] for k in ("contact_stage", "solve_stage",
                                     "finish_stage"))
    out.update(device_stages_ms=device,
               host_enqueue_ms=stages["host_enqueue"])
    if not null_below:
        return
    out["rate_ok"] = out["frame_ms_uncaptured"] >= device
    if not out["rate_ok"]:
        print(f"# {out['scene']} ({out['boxes']} boxes): the uncaptured "
              f"slope reads {out['frame_ms_uncaptured']:.3f} ms a frame, "
              f"below its {device:.3f} ms of device stages: no rate "
              "recorded", flush=True)
        out["steps_per_s_uncaptured"] = None


def _per_env(out: dict, envs: int):
    """env-steps/s, null where the scene's rate is."""
    rate = out["steps_per_s"]
    return None if rate is None else rate * envs


def _bench_row(scene: str, boxes: int, *flags):
    """Bench row ``scene`` at ``boxes`` boxes, built on the card as
    ``python -m phyx_tpu_torch.bench --scene scene --boxes boxes *flags``
    builds it (``bench.build_row``: bench.py's configuration policy and
    CLI defaults): (cfg, state)."""
    from phyx_tpu_torch import bench
    args = bench.parser().parse_args(
        ["--scene", scene, "--boxes", str(boxes), *flags])
    return bench.build_row(args, "cuda")


def _drive(scene: str, boxes: int, settle: int, kernels: tuple, card: str,
           built=None, both_ways: bool = False, after_settle=None):
    """Builds the scene on the card (``built`` = (cfg, state), else
    bench.py's build() of ``scene``), frees every captured frame of the
    scenes before, settles it through ``rollout`` (a graph replay: one
    uncaptured frame, the capture, replays) with every synchronising call
    an error and the launch counts zeroed just before and read just after:
    the warm-up frame launches each kernel of ``kernels`` once, and the
    replays no wrapper (their launches are read from the profiler's trace,
    ``_replays_traced``); calls ``after_settle(state, cfg)`` where given
    (its result goes into the record as ``after_settle``), then times
    frames (``_timed``).  Returns (state, cfg, dict of the run's
    numbers)."""
    import torch
    from phyx_tpu_torch.step import release_graphs, rollout
    release_graphs()
    cfg, st = _bench_row(scene, boxes) if built is None else built
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    # a step must not wait for the device: any synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = rollout(st, cfg, settle)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _sync()
    settle_s = time.perf_counter() - t0
    launched = _counts()
    if launched != {k: int(k in kernels) for k in launched}:
        raise AssertionError(f"{scene} settle: launches {launched}, expected "
                             f"{kernels} once (the warm-up frame)")
    extra = {} if after_settle is None else dict(
        after_settle=after_settle(st, cfg))
    st, out = _timed(st, cfg, kernels, both_ways)
    out = dict(scene=scene, boxes=boxes, **out, settle_s=settle_s,
               frames_settled=settle, card=card, **extra)
    out["frames_total"] += settle
    return st, cfg, out


def _step_loop(st, cfg, n: int):
    """``n`` uncaptured frames: a loop of ``step``."""
    from phyx_tpu_torch.step import step
    for _ in range(n):
        st = step(st, cfg)
    return st


def _slope(run, st, cfg, n: int, kernels: tuple, what: str,
           warmup: int = 0, times: int = 1) -> tuple:
    """Frames timed by the slope t(2n) - t(n) of ``run(st, cfg, frames)``
    after a discarded warm-up window (``warmup`` frames, n by default: the
    first window after the probe can carry a one-off cost, which would
    lower the slope), the launch counts zeroed just before and read just
    after: each kernel named in ``kernels`` must launch ``times`` times a
    frame (once a shard or a group), every other never (replays pass none:
    they launch from the graph, past every wrapper).  Returns (state, ms a
    frame, dict of the windows' seconds and the counted launches)."""
    st = run(st, cfg, warmup or n)
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    st = run(st, cfg, n)
    _sync()
    t1 = time.perf_counter()
    st = run(st, cfg, 2 * n)
    _sync()
    t2 = time.perf_counter()
    launches = _counts()
    if launches != {k: 3 * n * times if k in kernels else 0
                    for k in launches}:
        raise AssertionError(f"{what}: launches {launches} in {3 * n} "
                             f"frames, expected {kernels} {times} x a frame "
                             "and no other kernel")
    per_frame = ((t2 - t1) - (t1 - t0)) / n
    if not per_frame > 0.0:
        raise AssertionError(f"{what}: slope timing not positive: "
                             f"t(n)={t1 - t0}, t(2n)={t2 - t1}")
    return st, per_frame * 1e3, dict(t_n_s=t1 - t0, t_2n_s=t2 - t1,
                                     launches_counted=launches)


# seconds of the 3n frames a slope times
WINDOW_S = 4.0


def _probe(run, st, cfg) -> tuple:
    """Two frames of ``run``: (state, n for about ``WINDOW_S`` of 3n
    frames, 4 <= n <= 100)."""
    t0 = time.perf_counter()
    st = run(st, cfg, 2)
    _sync()
    frame_s = (time.perf_counter() - t0) / 2
    return st, max(4, min(100, int(WINDOW_S / max(frame_s, 1e-3) / 3)))


def _host_ms_replayed(st, cfg, frames: int = 5, run=None) -> float:
    """The host's ms a replayed frame: the wall clock of ``rollout`` (or
    ``run(st, cfg, frames)``) queuing ``frames`` replays (and the copies of
    the state in and out) from an idle device, over ``frames``."""
    from phyx_tpu_torch.step import rollout
    _sync()
    t0 = time.perf_counter()
    (run or rollout)(st, cfg, frames)
    host = time.perf_counter() - t0
    _sync()
    return host * 1e3 / frames


def _timed(st, cfg, kernels: tuple, both_ways: bool = False,
           steps: int = 0, run=None, frame=None, times: int = 1):
    """Frames of a settled scene timed through ``rollout`` (graph replays;
    a frame not captured yet is captured in the first window) by
    ``_slope``, n from a two-frame probe, or with ``steps`` as bench.py
    times an ``--autotune`` row: n = ``steps`` after two windows of
    ``steps`` and 2 ``steps``.  With ``both_ways``, from the same state,
    then uncaptured (a loop of ``step``) in the same way, n from its own
    probe (``steps`` where given: then both ways time the same frames).
    The host's ms a replayed frame (``_host_ms_replayed``).  A stacked
    state (shards, groups, envs) passes ``run(state, frames)`` for its
    replays and ``frame(state)`` for one uncaptured frame, which launches
    each kernel of ``kernels`` ``times`` times, and ``steps``; its record
    adds the wall clock of queuing one uncaptured frame from an idle
    device and leaves the stats to the caller.  Checks the replayed state
    finite and returns it: (state, dict of the numbers and its stats)."""
    import torch
    from phyx_tpu_torch.step import rollout, stats_dict
    replay = rollout if run is None else (lambda s, _, k: run(s, k))

    def loop(s, c, k):
        if frame is None:
            return _step_loop(s, c, k)
        for _ in range(k):
            s = frame(s)
        return s

    st0, probe = st, 0
    if steps:
        n, warmup = steps, 3 * steps
    else:
        st, n = _probe(replay, st, cfg)
        probe, warmup = 2, n
    st, ms, rec = _slope(replay, st, cfg, n, (), "replayed", warmup)
    out = dict(steps_per_s=1e3 / ms, frame_ms=ms,
               host_ms_replayed=_host_ms_replayed(st, cfg, run=replay),
               frames_timed=3 * n, frames_total=probe + warmup + 3 * n,
               **rec)
    if both_ways:
        if steps:
            st_u = st0
        else:
            st_u, n = _probe(loop, st0, cfg)
        _, ms, rec = _slope(loop, st_u, cfg, n, kernels, "uncaptured",
                            3 * n if steps else n, times)
        out.update(steps_per_s_uncaptured=1e3 / ms, frame_ms_uncaptured=ms,
                   frames_timed_uncaptured=3 * n,
                   **{f"{k}_uncaptured": v for k, v in rec.items()})
        if frame is not None:
            _sync()
            t0 = time.perf_counter()
            frame(st)
            out["host_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
            _sync()
        print(f"# both ways: {1e3 / out['frame_ms']:.2f} steps/s replayed "
              f"({out['frame_ms']:.3f} ms a frame, host "
              f"{out['host_ms_replayed']:.3f} ms a frame to queue), "
              f"{1e3 / ms:.2f} uncaptured ({ms:.3f} ms)", flush=True)
    if not (torch.isfinite(st.bodies.pos).all().item()
            and torch.isfinite(st.bodies.vel).all().item()):
        raise AssertionError("non-finite body state")
    if run is None:
        out.update(max_bodies=cfg.max_bodies, max_pairs=cfg.max_pairs,
                   max_joints=cfg.max_joints, **stats_dict(st.stats))
    return st, out


# each timed scene's record by label (``_frames_summary``)
_TIMED: dict = {}
# each timed scene's settled (state, cfg) by label (``phase_aux``)
_SETTLED: dict = {}
# each traced scene by label: (the kernels its frame launches once each,
# the entries of ``_FRAMES`` that make up one uncaptured frame, the entry
# of its replays)
_TRACED: dict = {}
# graph replays of each traced scene in the profiler's session
TRACED_REPLAYS = 3


def _trace(label: str, st, cfg, kernels: tuple, stages: tuple = (),
           frame=None, run=None, times: int = 1) -> None:
    """Hands the profiler's session (``_FRAMES``) one uncaptured ``step``
    of ``st`` (or ``frame(st)``; or, where ``stages`` names entries of
    ``_FRAMES`` that make up its frame, those) and one ``rollout`` (or
    ``run(st, frames)``) of ``TRACED_REPLAYS`` graph replays from ``st``,
    for ``_replays_traced``, which holds the uncaptured frame to launching
    each kernel of ``kernels`` ``times`` times (once a shard or a
    group)."""
    from phyx_tpu_torch.step import rollout, step
    if not stages:
        stages = (f"{label}: step",)
        _FRAMES[stages[0]] = (f"the settled {label}", lambda: (
            frame or (lambda s: step(s, cfg)))(st))
    _FRAMES[f"{label}: replays"] = (
        f"the settled {label}, {TRACED_REPLAYS} graph replays",
        lambda: (run or (lambda s, k: rollout(s, cfg, k)))(
            st, TRACED_REPLAYS))
    _TRACED[label] = (kernels, stages, f"{label}: replays", times)


def _register(label: str, out: dict, st, cfg, kernels: tuple,
              stages: tuple = (), **trace) -> None:
    """Keeps the record ``out`` of a timed scene under ``label`` and
    traces its frame (``_trace``, with its keywords ``trace``)."""
    _trace(label, st, cfg, kernels, stages, **trace)
    _TIMED[label] = out
    _SETTLED[label] = (st, cfg)


def _marks(hand: dict) -> dict:
    """The wrappers' launches in a trace: the count of each wrapper's
    mark kernel (``LAUNCH_MARKS``) among ``hand``'s kernel counts."""
    return {k: sum(c for name, c in hand.items()
                   if all(part in name for part in parts))
            for k, parts in LAUNCH_MARKS.items()}


def _replays_traced(a_call: dict) -> dict:
    """For each traced scene, from the profiler's one session: its
    uncaptured frame launches each kernel of its path once by the
    wrappers' counts and by the trace (which holds the mark kernels'
    names to the counts); the graph replays launch no wrapper, and the
    trace shows each hand-written CUDA kernel ``TRACED_REPLAYS`` times as
    often as in the uncaptured frame.  Returns, by scene, the kernels'
    launches in the replays (from the trace), and the replayed frame's
    device busy ms, span ms and idle share (1 - busy / span) over the
    rollout call (its copies of the state in and out included)."""
    out = {}
    for label, (kernels, stages, replays, times) in _TRACED.items():
        launched, hand = dict.fromkeys(LAUNCH_MARKS, 0), {}
        for key in stages:
            for k, c in a_call[key]["launched"].items():
                launched[k] += c
            for name, c in a_call[key]["hand"].items():
                hand[name] = hand.get(name, 0) + c
        rec = a_call[replays]
        marks = _marks(rec["hand"])
        if launched != {k: times * int(k in kernels) for k in launched}:
            raise AssertionError(f"{label}: an uncaptured frame launched "
                                 f"{launched}, expected {kernels} {times} "
                                 "x each")
        if _marks(hand) != launched:
            raise AssertionError(f"{label}: the trace of an uncaptured frame "
                                 f"shows {_marks(hand)}, the wrappers "
                                 f"counted {launched}: {hand}")
        if any(rec["launched"].values()):
            raise AssertionError(f"{label}: graph replays launched "
                                 f"{rec['launched']} by wrappers")
        if rec["hand"] != {n: TRACED_REPLAYS * c for n, c in hand.items()}:
            raise AssertionError(
                f"{label}: {TRACED_REPLAYS} graph replays ran {rec['hand']}, "
                f"an uncaptured frame {hand}")
        out[label] = dict(
            launches=marks, replays=TRACED_REPLAYS,
            device_busy_ms=rec["busy_ms"] / TRACED_REPLAYS,
            device_span_ms=rec["span_ms"] / TRACED_REPLAYS,
            idle_share=1.0 - rec["busy_ms"] / rec["span_ms"],
            kernels_a_frame=rec["kernels"] / TRACED_REPLAYS,
            device_only=rec["device_only"])
        print(f"# traced replays: {label}: {TRACED_REPLAYS} replays ran "
              f"{ {k: v for k, v in marks.items() if v} } (each hand-written "
              f"kernel {TRACED_REPLAYS} x an uncaptured frame's); "
              f"{out[label]['device_busy_ms']:.3f} ms busy in "
              f"{out[label]['device_span_ms']:.3f} ms a frame, idle share "
              f"{out[label]['idle_share']:.4f}", flush=True)
    return out


def _frames_summary(a_call: dict, traced: dict) -> dict:
    """Each timed scene's frame both ways: steps/s and ms a frame
    replayed and uncaptured (the slopes), the host's ms a frame
    (replayed: queuing replays; uncaptured: queuing a frame behind a
    sleep kernel, or for the colored frames with none ahead); replayed,
    from the profiler's trace of graph replays (``_replays_traced``): the
    CUDA kernels, device busy ms, device span ms and idle share of a
    frame; uncaptured: the CUDA kernels and device busy ms of one profiled
    step against the uncaptured slope's frame, idle share 1 - busy /
    frame."""
    out = {}
    for label, rec in _TIMED.items():
        keys = _TRACED[label][1]
        busy = sum(a_call[k]["busy_ms"] for k in keys)
        t = traced[label]
        row = dict(steps_per_s=rec["steps_per_s"], frame_ms=rec["frame_ms"],
                   host_ms_replayed=rec["host_ms_replayed"],
                   kernels_a_frame=t["kernels_a_frame"],
                   device_busy_ms=t["device_busy_ms"],
                   device_span_ms=t["device_span_ms"],
                   idle_share=t["idle_share"],
                   device_only=t["device_only"])
        if "frame_ms_uncaptured" in rec:
            row.update(
                steps_per_s_uncaptured=rec["steps_per_s_uncaptured"],
                frame_ms_uncaptured=rec["frame_ms_uncaptured"],
                host_ms_uncaptured=rec["host_enqueue_ms"],
                kernels_a_frame_uncaptured=sum(a_call[k]["kernels"]
                                               for k in keys),
                device_busy_ms_uncaptured=busy,
                idle_share_uncaptured=1.0 - busy
                / rec["frame_ms_uncaptured"])
        out[label] = row
    return out


def _kernel_at_frame(st, cfg, wrapper, name) -> dict:
    """The kernel against the plain version at the frame's shapes on warm
    + 1 + 1 passes (the plain version runs one device launch per scalar
    operation): ungated, and gated with thresholds that skip every second
    pass (2 + 2 passes run as 1 + 1).  Then the kernel timed on those
    passes and on all of them, with its bound for each."""
    import torch
    from phyx_tpu_torch.step import solve_inputs
    args = solve_inputs(st, cfg)
    short = dict(args, vel_iters=1, pos_iters=1)
    err, plain_ms = _compare(wrapper, short)
    skip = torch.full((2,), 1e30, dtype=torch.float32, device="cuda")
    err = max(err, _compare(wrapper, dict(args, vel_iters=2, pos_iters=2,
                                          tols=skip))[0])
    live = int(args["num_contacts"])
    numj = 0 if args["num_joints"] is None else int(args["num_joints"])
    print(f"# compare: {name} == plain at the {cfg.max_bodies}-cap frame "
          f"({live} contacts, {numj} joints, {args['b1'].numel()} slots), "
          f"warm + 1 + 1 passes, gates off and on; max abs diff {err}",
          flush=True)
    ms_short = _kernel_ms(wrapper, short, reps=5)
    ms_full = _kernel_ms(wrapper, args, reps=5)
    full = _bound(args)
    return dict(args=args, max_abs_err=err, plain_ms=plain_ms, ms=ms_short,
                **_bound(short), ms_full_solve=ms_full,
                bound_ms_full_solve=full["bound_ms"],
                ns_per_visit=ms_full * 1e6 / full["visits"],
                visits_full_solve=full["visits"], contacts=live,
                joints=numj)


def _check_prepass(dev: dict, lv: dict, r: int) -> bool:
    """A kernel's pre-pass output ``dev`` (``prepass`` or ``tiled_prepass``)
    against the torch pre-pass ``lv`` (``visit_levels`` or
    ``slab_levels``): each visit's level, the level offsets, and each
    level's records a permutation of its rows (``r``: the row slots)."""
    import torch
    v, n_levels = lv["slots"].numel(), lv["n_levels"]
    off = lv["offsets"]
    if not (int(dev["n_levels"][0]) == n_levels
            and torch.equal(dev["level"][:v].long(), lv["level"])
            and torch.equal(dev["offsets"][:n_levels + 1].long(), off)):
        return False
    # (level, slot) of every record, sorted, against the plain buckets
    pos_level = torch.repeat_interleave(
        torch.arange(n_levels, device=off.device), off.diff())
    got = torch.sort(pos_level * r + dev["slots"][:v].long()).values
    ref = torch.sort(pos_level * r + lv["slots"][lv["order"]]).values
    return torch.equal(got, ref)


def _level_widths(lv: dict) -> dict:
    import torch
    widths = lv["offsets"].diff().double()
    if not widths.numel():
        return dict(width_p50=0.0, width_p90=0.0, width_p99=0.0, width_max=0)
    q = torch.quantile(widths, torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=widths.device))
    return dict(width_p50=float(q[0]), width_p90=float(q[1]),
                width_p99=float(q[2]), width_max=int(widths.max()))


def _k1_levels(args, what: str) -> dict:
    """K1's level schedule at a frame: the kernel's pre-pass against
    ``visit_levels`` with the table's free rows (``_check_prepass``), with
    its last-level array as the wrapper places it and in device memory, the
    levels per pass and their widths, the pre-pass timed alone (CUDA events
    over repeated launches).  Not a launch of K1's wrapper."""
    from phyx_tpu_torch.kernels.contact_solver_streamed import (
        free_rows, prepass, visit_levels)
    n = args["body_flat"].numel() // 8
    lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                      args["num_joints"], args["c_cap"], n,
                      free_rows(args["body_flat"]))
    # the wrapper's placement of the last-level array, then device memory
    for smem_last in (None, False):
        dev = prepass(**args, smem_last=smem_last)
        _sync()
        if not _check_prepass(dev, lv, args["b1"].numel()):
            raise AssertionError(f"K1's pre-pass (smem_last {smem_last}) "
                                 f"differs from visit_levels at {what}")
    out = dict(levels=lv["n_levels"], visits=lv["slots"].numel(),
               **_level_widths(lv),
               prepass_ms=_kernel_ms(prepass, args, reps=20))
    print(f"# K1 levels at {what}: {out['levels']} levels a pass over "
          f"{out['visits']} visits, widths p50 {out['width_p50']} p90 "
          f"{out['width_p90']} p99 {out['width_p99']} max "
          f"{out['width_max']}; pre-pass {out['prepass_ms']:.4f} ms; equal "
          "to visit_levels, the last-level array in shared and in device "
          "memory", flush=True)
    return out


def _equals_levels_plain(name: str, args, what: str) -> dict:
    """K1, K3 or K5 against its levels plain version on all the frame's
    passes, as gated as the frame is: equal to the bit.  Returns the max
    abs difference and the plain version's ms."""
    from phyx_tpu_torch.kernels.contact_solver_streamed import \
        solve_contacts_levels_plain
    from phyx_tpu_torch.kernels.contact_solver_tiled import (
        solve_contacts_tiled2_levels_plain, solve_contacts_tiled_levels_plain)
    plain = dict(K1=solve_contacts_levels_plain,
                 K3=solve_contacts_tiled2_levels_plain,
                 K5=solve_contacts_tiled_levels_plain)[name]
    got = _wrappers()[name](**args)
    _sync()
    t0 = time.perf_counter()
    ref = plain(**args)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _equal(f"{name} vs its levels plain version at {what}", got, ref)
    print(f"# compare: {name} == {plain.__name__} at {what}, all "
          f"{1 + args['vel_iters'] + args['pos_iters']} passes; max abs "
          f"diff {err}; the plain version {plain_ms:.0f} ms", flush=True)
    return dict(max_abs_err_levels_plain=err, levels_plain_ms=plain_ms)


def _k1_level_checks(k: dict, what: str) -> dict:
    """At a main-path frame of K1 (``k`` from ``_kernel_at_frame``): its
    levels, K1 == the levels plain version on all passes, and K1 with its
    per-body arrays in device memory.  Returns the numbers for K1's row."""
    args = k["args"]
    lv = _k1_levels(args, what)
    return dict(levels=lv["levels"], prepass_ms=lv["prepass_ms"],
                ns_per_level=(k["ms_full_solve"] - lv["prepass_ms"]) * 1e6
                / max(1, lv["levels"] * (1 + args["vel_iters"]
                                         + args["pos_iters"])),
                level_widths={key: lv[key] for key in (
                    "width_p50", "width_p90", "width_p99", "width_max")},
                **_equals_levels_plain("K1", args, what),
                **_k1_in_device_memory(args, what))


def _k1_in_device_memory(args, what: str) -> dict:
    """K1 with its last-level array and working columns in device memory
    (the placement of frames above N = 51,200; the columns' alone above
    19,285, as at the 20k frame) against K1 as the wrapper places them, on
    all passes, gated (as the frame is, or where its gates are off with
    thresholds that skip every pass after the first) and ungated: equal to
    the bit.  Then timed.  These launches of the wrapper are comparisons,
    made after the main path's counts were read."""
    import torch
    from phyx_tpu_torch.kernels.contact_solver_streamed import \
        solve_in_device_memory
    k1 = _wrappers()["K1"]
    gates = args.get("tols")
    if gates is None:
        gates = torch.full((2,), 1e30, dtype=torch.float32, device="cuda")
    err = 0.0
    for tols in (gates, None):
        ref = k1(**dict(args, tols=tols))
        got = solve_in_device_memory(**dict(args, tols=tols))
        _sync()
        err = max(err, _equal("K1 in device memory vs K1", got, ref))
    ms = _kernel_ms(solve_in_device_memory, args, reps=5)
    print(f"# compare: K1 with its per-body arrays in device memory == K1 "
          f"at {what}, all passes, gated and ungated; max abs diff {err}; "
          f"{ms:.4f} ms a full solve", flush=True)
    return dict(max_abs_err_device_memory=err, ms_full_solve_device_memory=ms)


def _tiled_levels(name: str, args, what: str) -> dict:
    """K3's or K5's level schedule at a frame: the kernel's pre-pass
    against ``slab_levels`` with the table's free rows (``_check_prepass``),
    its last-level array in shared memory where the table's rows allow and
    in device memory, the levels a pass and their widths, the pre-pass
    timed alone.  Not a launch of the wrapper."""
    from phyx_tpu_torch.kernels.contact_solver_streamed import (free_rows,
                                                                placement)
    from phyx_tpu_torch.kernels.contact_solver_tiled import (slab_levels,
                                                             tiled_prepass)
    lv = slab_levels(args, free_rows(args["body_flat"]))
    npad = args["body_flat"].numel() // 8
    for smem_last in {placement(npad)["smem_last"], False}:
        dev = tiled_prepass(args, smem_last=smem_last)
        _sync()
        if not _check_prepass(dev, lv, args["b12"].numel() // 2):
            raise AssertionError(f"{name}'s pre-pass (smem_last "
                                 f"{smem_last}) differs from slab_levels at "
                                 f"{what}")
    return dict(levels=lv["n_levels"], visits=lv["slots"].numel(),
                **_level_widths(lv),
                prepass_ms=_kernel_ms(lambda **a: tiled_prepass(a), args,
                                      reps=10))


def _place_key(place: dict) -> str:
    """A placement of the tiled kernels' per-row arrays, as a name."""
    where = {True: "shared", False: "device"}
    return (f"{where[place['smem_last']]}_last_"
            f"{where[place['smem_cols']]}_cols")


def _tiled_placed(name: str, args, what: str) -> dict:
    """K3 or K5 in every placement the table's rows allow
    (``tiled_placements``) against the wrapper's own, on all passes, gated
    as the frame is and ungated: equal to the bit.  Then each timed.  These
    launches are comparisons, made after the main path's counts were
    read."""
    from phyx_tpu_torch.kernels.contact_solver_tiled import (
        solve_tiled_placed, tiled_placements)
    places = tiled_placements(args["body_flat"].numel() // 8)
    err = 0.0
    for tols in (args.get("tols"), None):
        ref = _wrappers()[name](**dict(args, tols=tols))
        for place in places[1:]:
            got = solve_tiled_placed(dict(args, tols=tols), **place)
            _sync()
            err = max(err, _equal(f"{name} placed {place} vs the wrapper at "
                                  f"{what}", got, ref))
    ms = {_place_key(p): _kernel_ms(lambda **a: solve_tiled_placed(a, **p),
                                    args, reps=3)
          for p in places}
    return dict(placement=places[0], max_abs_err_placements=err,
                ms_full_solve_placements=ms)


def _tiled_full(name: str, args, what: str) -> dict:
    """At a frame of K3 or K5 on all its passes: the kernel against its
    levels plain version (``_equals_levels_plain``), its pre-pass against
    ``slab_levels``, every
    placement against the wrapper's; the full solve timed, with its bound,
    the pre-pass timed alone, levels a pass and ns a level =
    (ms - pre-pass) / (passes x levels).  Prints one line of it."""
    wrapper = _wrappers()[name]
    walked = _walked(name, args)
    out = dict(walked_slots=walked, **_equals_levels_plain(name, args, what))
    lv = _tiled_levels(name, args, what)
    out.update(_tiled_placed(name, args, what))
    ms = _kernel_ms(wrapper, args, reps=3)
    full = _bound_slabs(args, walked)
    passes = 1 + args["vel_iters"] + args["pos_iters"]
    out.update(
        ms_full_solve=ms, bound_ms_full_solve=full["bound_ms"],
        ns_per_visit=ms * 1e6 / full["visits"], levels=lv["levels"],
        prepass_ms=lv["prepass_ms"],
        ns_per_level=(ms - lv["prepass_ms"]) * 1e6
        / max(1, passes * lv["levels"]),
        level_widths={k: lv[k] for k in ("width_p50", "width_p90",
                                         "width_p99", "width_max")})
    print(f"# {name} at {what}: {walked} slots in {lv['levels']} levels a "
          f"pass (widths p50 {lv['width_p50']}, max {lv['width_max']}); "
          f"full solve {ms:.4f} ms, pre-pass {lv['prepass_ms']:.4f} ms, "
          f"{out['ns_per_level']:.1f} ns a level; pre-pass == slab_levels, "
          f"every placement == the wrapper's ({out['placement']}); ms by "
          f"placement {out['ms_full_solve_placements']}", flush=True)
    return out


def _sap_equals_grid(st, cfg) -> dict:
    """At the frame ``step(st, cfg)`` would run (``cfg`` the grid's), the
    grid's pairs, whose counters must read 0, against
    ``broadphase="sap"``'s (K6 at this capacity, launched once): the same
    lex buffer and ``num``, zero counters.  Then K6 against its plain
    version on that frame, and timed."""
    import torch
    from phyx_tpu_torch.broadphase import broadphase, sap_kernel_inputs
    from phyx_tpu_torch.step import integrate_velocities
    names = ("overflow", "ovf_window", "ovf_slots", "ovf_drop", "ovf_band",
             "ovf_slab")
    bodies = integrate_velocities(st.bodies, cfg)
    grid = broadphase(bodies, cfg)
    _reset_counts()
    sap = broadphase(bodies, cfg.replace(broadphase="sap"))
    launches = _counts()
    if launches != {k: int(k == "K6") for k in launches}:
        raise AssertionError(f"broadphase 'sap' launches {launches}")
    counters = {which: {k: int(getattr(p, k)) for k in names}
                for which, p in (("grid", grid), ("sap", sap))}
    same = (torch.equal(grid.pi, sap.pi) and torch.equal(grid.pj, sap.pj)
            and int(grid.num) == int(sap.num))
    if not same or any(v for c in counters.values() for v in c.values()):
        raise AssertionError(f"'sap' (K6) against the grid at the settled "
                             f"frame: buffers equal {same}, counters "
                             f"{counters}")
    print(f"# compare: broadphase 'sap' (K6) == the grid at the settled "
          f"{cfg.max_bodies}-cap frame: {int(sap.num)} pairs, every counter "
          f"0", flush=True)
    k6 = _emit_at("K6", sap_kernel_inputs(bodies, cfg.max_pairs, True),
                  f"the settled {cfg.max_bodies}-cap frame", True)
    return dict(k6, sap_launches=launches["K6"])


def phase_pile10k(card: str) -> dict:
    """The settled 10k pile through K1, the path of the first slice; at the
    settled frame K6 through ``broadphase="sap"`` against the grid."""
    w = _wrappers()
    # settle cut from the bench's 300 frames to keep the script in time
    st, cfg, out = _drive("pile", 10_000, 200, ("K1",), card)
    if out["num_contacts"] <= 0:
        raise AssertionError("no contacts in the 10k pile")
    # bench.py's quality bar for piles: no overflow, penetration <= 0.6
    # of the box half (0.5)
    pen_ratio = out["max_penetration"] / 0.5
    if out["pair_overflow"] != 0 or not pen_ratio <= 0.6:
        raise AssertionError(f"quality bar missed: overflow "
                             f"{out['pair_overflow']}, penetration ratio "
                             f"{pen_ratio}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, "the settled 10k pile")
    _register("pile 10000", out, st, cfg, ("K1",))
    k = _kernel_at_frame(st, cfg, w["K1"], "K1")
    lv = _k1_level_checks(k, "the settled 10k frame")
    k6 = _sap_equals_grid(st, cfg)
    out.update(metric="steps/s @ 10000-box pile (port, H100 path)",
               penetration_ratio=pen_ratio, stage_device_ms=stages,
               graph_replay=replay,
               solve_ms_full=k["ms_full_solve"],
               solve_share_of_frame=k["ms_full_solve"] / out["frame_ms"],
               k1_levels=lv, k6_device_ms_sap=k6["ms"],
               k6_pairs_sap=k6["emitted"])
    print(json.dumps(out), flush=True)
    return dict(k, k6=k6, **lv)


def _k2_at_frame(st, cfg, what: str) -> dict:
    """K2 at a main-path frame: against the plain version
    (``_kernel_at_frame``); K1 == K2 on all passes, K1 timed there; K2's
    schedule: the levels a pass (``visit_levels``, the levels of its
    pre-pass), the share of narrow levels (at most ``NARROW`` visits: one
    warp's) and of the visits in them, the pre-pass alone and the full
    solve timed behind a sleep kernel (device time), ns a level, and its
    place in shared memory (``fused_layout``)."""
    from phyx_tpu_torch.kernels.contact_solver import (NARROW, fused_layout,
                                                       fused_prepass)
    from phyx_tpu_torch.kernels.contact_solver_streamed import visit_levels
    w = _wrappers()
    k = _kernel_at_frame(st, cfg, w["K2"], "K2")
    args = k["args"]
    k1_err = _k1_equals_k2(args)
    k1_ms = _kernel_ms(w["K1"], args, reps=5)
    n, r = args["body_flat"].numel() // 8, args["b1"].numel()
    lv = visit_levels(args["b1"], args["b2"], args["num_contacts"],
                      args["num_joints"], args["c_cap"], n)
    widths = lv["offsets"].diff()
    levels, visits = lv["n_levels"], lv["slots"].numel()
    narrow = widths <= NARROW
    dev = _split_device_ms(
        (("prepass", lambda: fused_prepass(**args)),), w["K2"], args,
        reps=10)
    passes = 1 + args["vel_iters"] + args["pos_iters"]
    place = fused_layout(n, r)
    out = dict(levels=levels, visits_a_pass=visits,
               narrow_level_share=int(narrow.sum()) / max(1, levels),
               narrow_visit_share=int(widths[narrow].sum()) / max(1, visits),
               prepass_ms=dev["prepass_ms"],
               ms_full_solve_device=dev["wrapper_device_ms"],
               ns_per_level=(dev["wrapper_device_ms"] - dev["prepass_ms"])
               * 1e6 / max(1, levels * passes),
               level_widths=_level_widths(lv),
               layout=place, max_abs_err_k1=k1_err, k1_ms_full_solve=k1_ms)
    print(f"# K2 at {what}: K1 == K2 on all {passes} passes (max abs diff "
          f"{k1_err}); {levels} levels a pass over {visits} visits, "
          f"{out['narrow_level_share']:.3f} of them narrow (one warp's, "
          f"{out['narrow_visit_share']:.3f} of the visits); pre-pass "
          f"{out['prepass_ms']:.4f} ms, full solve {k['ms_full_solve']:.4f} "
          f"ms ({out['ms_full_solve_device']:.4f} device), "
          f"{out['ns_per_level']:.1f} ns a level; K1 {k1_ms:.4f} ms; ring "
          f"{place['stages']} stages ({place['ring_bytes']} B), "
          f"accumulators in {'shared' if place['acc_smem'] else 'device'} "
          f"memory, {place['smem_bytes']} B of shared memory", flush=True)
    return dict(k, **out)


def phase_chain(card: str) -> dict:
    """Bench row C: the 1000-link chain, through K2; K1 on the same input
    must equal it."""
    st, cfg, out = _drive("chain", 1000, 300, ("K2",), card,
                          both_ways=True)
    # bench.py's joint bar: no overflow, joint residual <= 1e-2
    if out["pair_overflow"] != 0 or not out["residual"] <= 1e-2:
        raise AssertionError(f"chain bar missed: overflow "
                             f"{out['pair_overflow']}, residual "
                             f"{out['residual']}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, "the settled chain")
    _register("chain 1000", out, st, cfg, ("K2",))
    k = _k2_at_frame(st, cfg, "the chain frame")
    k1_ms = k["k1_ms_full_solve"]
    out.update(metric="steps/s @ 1000-link chain (port, H100 path)",
               stage_device_ms=stages, graph_replay=replay,
               solve_ms_full=k["ms_full_solve"],
               k1_ms_full_solve=k1_ms,
               k2_ns_per_visit=k["ns_per_visit"],
               k1_ns_per_visit=k1_ms * 1e6 / k["visits_full_solve"],
               k2_levels=k["levels"], k2_prepass_ms=k["prepass_ms"],
               solve_share_of_frame=k["ms_full_solve"] / out["frame_ms"])
    print(json.dumps(out), flush=True)
    return k


def phase_pile1k(card: str) -> dict:
    """Bench row B': the 1k pile, settled 400 frames, through K2."""
    st, cfg, out = _drive("pile", 1000, 400, ("K2",), card,
                          both_ways=True)
    pen_ratio = out["max_penetration"] / 0.5
    if (out["num_contacts"] <= 0 or out["pair_overflow"] != 0
            or not pen_ratio <= 0.6):
        raise AssertionError(f"1k pile bar missed: contacts "
                             f"{out['num_contacts']}, overflow "
                             f"{out['pair_overflow']}, penetration ratio "
                             f"{pen_ratio}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, "the settled 1k pile")
    _register("pile 1000", out, st, cfg, ("K2",))
    k = _k2_at_frame(st, cfg, "the 1k pile frame")
    out.update(metric="steps/s @ 1000-box pile (port, H100 path)",
               penetration_ratio=pen_ratio, stage_device_ms=stages,
               graph_replay=replay,
               solve_ms_full=k["ms_full_solve"],
               k1_ms_full_solve=k["k1_ms_full_solve"],
               k2_ns_per_visit=k["ns_per_visit"],
               k2_levels=k["levels"], k2_prepass_ms=k["prepass_ms"],
               solve_share_of_frame=k["ms_full_solve"] / out["frame_ms"])
    print(json.dumps(out), flush=True)
    return k


# the reference's 20k slab-major run (BENCH_QUEUE_r5.log:149, TPU v5e): a
# sanity band for the physics, not a bit target
REF_20K = dict(num_contacts=83869, num_pairs=58134, penetration_ratio=0.494)


def phase_pile20k(card: str) -> dict:
    """Bench row C': the 20k pile, whose body capacity puts it in the tiled
    tier, through K3 once a frame; then K3 against both plain versions,
    its pre-pass and placements checked and timed (``_tiled_full``), K1
    timed on the same frame compacted, and one frame through K5
    (``tiled_routing=False``), K5 checked likewise at its routed rows."""
    import torch
    from phyx_tpu_torch.step import solve_inputs, step
    wrappers = _wrappers()
    st, cfg, out = _drive("pile", 20_000, 300, ("K3",), card)
    pen_ratio = out["max_penetration"] / 0.5
    ovf = {k: out[k] for k in ("pair_overflow", "ovf_window", "ovf_slots",
                               "ovf_drop", "ovf_band", "ovf_slab")}
    if (out["num_contacts"] <= 0 or any(ovf.values())
            or not pen_ratio <= 0.6):
        raise AssertionError(f"20k pile bar missed: contacts "
                             f"{out['num_contacts']}, overflow {ovf}, "
                             f"penetration ratio {pen_ratio}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, "the settled 20k pile")
    _register("pile 20000", out, st, cfg, ("K3",))

    # K3 against the serial plain version at the frame's shapes: the warm
    # pass and one velocity pass (it launches one op per scalar operation)
    args = solve_inputs(st, cfg)
    if "cum" not in args:
        raise AssertionError("the 20k pile did not take the slab-major path")
    walked = _walked("K3", args)
    short = dict(args, vel_iters=1, pos_iters=0)
    err, plain_ms = _compare(wrappers["K3"], short)
    print(f"# compare: K3 == serial plain at the 20k frame ({walked} slots "
          f"in {args['n_slabs']} slabs, {out['num_contacts']} live "
          f"contacts), warm + 1 velocity pass; max abs diff {err}",
          flush=True)
    ms_short = _kernel_ms(wrappers["K3"], short, reps=5)
    k3 = _tiled_full("K3", args, "the 20k frame")

    # K1 on the same frame, live rows compacted first (timed only: its
    # placement, the working columns in device memory, is held to the
    # wrapper's at the 10k and 64-env frames by _k1_in_device_memory)
    rows = solve_inputs(st, cfg, "rows")
    k1_ms = _kernel_ms(wrappers["K1"], rows, reps=3)
    k1_visits = _bound(rows)["visits"]

    # one frame through K5, the reference's round-4 path, beside K3's; no
    # step of either path may wait for the device
    routed = cfg.replace(tiled_routing=False)
    _sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        via_k3 = step(st, cfg)
        _reset_counts()
        via_k5 = step(st, routed)
        k5_launches = _counts()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _sync()
    if k5_launches != {k: int(k == "K5") for k in k5_launches}:
        raise AssertionError(f"K5 frame launches {k5_launches}")
    k5_diff = (via_k3.bodies.pos - via_k5.bodies.pos).abs().max().item()
    if not (torch.isfinite(via_k5.bodies.pos).all().item()
            and k5_diff <= 5e-3):
        raise AssertionError(f"K5 frame off the K3 frame by {k5_diff}")
    print(f"# K5 frame: positions within {k5_diff} of the K3 frame (bar "
          "5e-3), neither frame waiting for the device", flush=True)

    # K5 against the serial plain version at that frame's shapes, as K3
    k5_args = solve_inputs(st, routed)
    k5_walked = _walked("K5", k5_args)
    k5_short = dict(k5_args, vel_iters=1, pos_iters=0)
    k5_err, k5_plain_ms = _compare(wrappers["K5"], k5_short)
    print(f"# compare: K5 == serial plain at the 20k frame's routed rows "
          f"({k5_walked} live slots in {k5_args['n_slabs']} slab budgets of "
          f"{k5_args['b12'].numel() // 2 // k5_args['n_slabs']} slots), "
          f"warm + 1 velocity pass; max abs diff {k5_err}", flush=True)
    k5_ms_short = _kernel_ms(wrappers["K5"], k5_short, reps=5)
    k5 = _tiled_full("K5", k5_args, "the 20k frame's routed rows")

    out.update(metric="steps/s @ 20000-box pile (port, H100 path)",
               penetration_ratio=pen_ratio, stage_device_ms=stages,
               graph_replay=replay,
               solve_ms_full=k3["ms_full_solve"],
               solve_share_of_frame=k3["ms_full_solve"] / out["frame_ms"],
               k3_walked_slots=walked, k3_levels=k3["levels"],
               k3_prepass_ms=k3["prepass_ms"],
               k3_ns_per_level=k3["ns_per_level"],
               k1_ms_full_solve_same_frame=k1_ms,
               k1_ns_per_visit=k1_ms * 1e6 / k1_visits,
               k5_ms_full_solve=k5["ms_full_solve"], k5_levels=k5["levels"],
               k5_prepass_ms=k5["prepass_ms"],
               k5_frame_max_pos_diff=k5_diff,
               reference_fingerprint=REF_20K)
    print(json.dumps(out), flush=True)
    return dict(
        k3=dict(k3, max_abs_err=err,
                plain_ms=plain_ms, ms=ms_short, **_bound_slabs(short, walked),
                contacts=out["num_contacts"], joints=0),
        k5=dict(k5, launches=k5_launches["K5"], max_abs_err=k5_err,
                plain_ms=k5_plain_ms, ms=k5_ms_short,
                **_bound_slabs(k5_short, k5_walked)))


def _bound_sweep(args, num: int) -> dict:
    """The least time for K4 on ``args``: the rows its sweeps touch, those
    below ``nact`` (every padded row in the segmented layout, where nact =
    npad), read once (16 B of AABB, 4 of dyn, 4 of order, 8 of true x
    where given), ``nact`` read and the ``num`` pairs and three counters
    written once, over HBM's rate.  Its compares are a few a row visit, far
    below the bytes' time.  Also counts the sweeps (starter rows)."""
    nact = int(args["nact"])
    K = args["slab_stride"]
    row = 16 + 4 + 4 + (8 if args["truex"] is not None else 0)
    nbytes = nact * row + 4 + 2 * num * 4 + 3 * 4
    sweeps = sum(max(0, min(K, nact - s * K)) for s in range(args["n_slabs"]))
    return dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=nbytes, rows_read=nact, sweeps=sweeps)


def _sweep_device_ms(args, reps: int) -> dict:
    """K4's device time alone (``_split_device_ms``): its one launch on
    buffers made beforehand, and the whole wrapper."""
    import torch
    from phyx_tpu_torch.kernels.sweep_tiled import tiled_pass
    a = tuple(args[k] for k in ("rows", "dyn", "order", "nact", "max_pairs",
                                "n_slabs", "slab_stride", "window_rows",
                                "truex"))
    i32 = dict(dtype=torch.int32, device=args["rows"].device)
    pi, pj = (torch.empty((args["max_pairs"],), **i32) for _ in range(2))
    counters = torch.empty((3,), **i32)
    return _split_device_ms(
        (("kernel", lambda: tiled_pass(*a, pi, pj, counters)),),
        _wrappers()["K4"], args, reps)


# the reference's settled 1024-env row E (BASELINE.md:26 and :94, TPU v5e):
# a sanity band for the per-env physics, not a target
REF_E = dict(contacts_per_env=823080 / 1024, penetration_ratio=0.025)
ENVS = 1024
# E-1024's settle in this script: bench.py settles 240 frames; the cut
# (~53 s at ~0.28 s a frame) makes room for the multi phase within the
# script's time (PERF.md §4)
SETTLE_E1024 = 50


def phase_envs1024(card: str) -> dict:
    """Bench row E at the reference's 1024 envs x 256 boxes:
    ``broadphase="sap"`` above the reference's sweep budget takes K4, the
    capacity the tiled tier and K3, once a frame each; then K4 against its
    plain version at the settled frame, and timed, and K3 against its
    levels plain version on all passes there, its pre-pass and placements
    checked, and timed (``_tiled_full``; the serial plain version would
    take ~10 minutes at this frame)."""
    from phyx_tpu_torch.broadphase import _sap_tiled_sort_stage, compute_aabbs
    from phyx_tpu_torch.demos.run_envs import build_envs
    from phyx_tpu_torch.step import solve_inputs
    st, cfg, out = _drive("envs", ENVS * 256, SETTLE_E1024, ("K3", "K4"),
                          card,
                          built=build_envs(ENVS, 256))
    pen_ratio = _envs_bar(out, ENVS)
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, f"the settled {ENVS}-env frame")
    _register(f"envs {ENVS}", out, st, cfg, ("K3", "K4"))
    lo, hi = compute_aabbs(st.bodies)
    args = _sap_tiled_sort_stage(st.bodies, cfg, lo, hi)[0]
    err, counts, plain_ms = _compare_sweep(args)
    bound = _bound_sweep(args, counts["num"])
    print(f"# compare: K4 == plain at the settled {ENVS}-env frame "
          f"({bound['sweeps']} sweeps over {bound['rows_read']} of "
          f"{args['rows'].shape[1]} rows, {args['n_slabs']} slabs of "
          f"{args['slab_stride']}, window {args['window_rows']}, budget "
          f"{args['max_pairs']}): {counts}", flush=True)
    # the kernel's device time, and the wrapper's pace as the frame calls it
    device = _sweep_device_ms(args, reps=20)
    wrapper_ms = _kernel_ms(_wrappers()["K4"], args, reps=20)
    parent = _versus_parent("K4", args)
    _PROBES["K4"] = (f"the settled {ENVS}-env frame",
                     lambda: _wrappers()["K4"](**args))
    k3_args = solve_inputs(st, cfg)
    if "cum" not in k3_args:
        raise AssertionError(f"the {ENVS}-env frame did not take the "
                             "slab-major path")
    k3 = _tiled_full("K3", k3_args, f"the settled {ENVS}-env frame")
    out.update(metric=f"env-steps/s @ {ENVS} envs x 256 boxes (port, H100 "
               "path)", env_steps_per_s=out["steps_per_s"] * ENVS,
               envs=ENVS, contacts_per_env=out["num_contacts"] / ENVS,
               penetration_ratio=pen_ratio, stage_device_ms=stages,
               graph_replay=replay,
               k4_device_ms=device["device_ms"], k4_wrapper_ms=wrapper_ms,
               k4_emitted=counts["num"], solve_ms_full=k3["ms_full_solve"],
               solve_share_of_frame=k3["ms_full_solve"] / out["frame_ms"],
               k3_walked_slots=k3["walked_slots"], k3_levels=k3["levels"],
               k3_prepass_ms=k3["prepass_ms"],
               k3_ns_per_level=k3["ns_per_level"],
               reference_fingerprint=REF_E)
    print(json.dumps(out), flush=True)
    return dict(max_abs_err=err,
                env_steps_per_s=out["env_steps_per_s"],
                ms=device["device_ms"], plain_ms=plain_ms,
                emitted=counts["num"], wrapper_ms=wrapper_ms,
                **{k: device[k] for k in ("kernel_ms", "wrapper_device_ms",
                                          "device_only")},
                **{f"{k}_versus_parent": v for k, v in parent.items()},
                **bound,
                k3={f"{key}_envs1024": v for key, v in k3.items()})


def _envs_bar(out: dict, envs: int) -> float:
    """bench.py's bar for envs: contacts, no overflow of any cause,
    penetration <= 0.2 of the box half.  Returns the penetration ratio."""
    pen_ratio = out["max_penetration"] / 0.5
    ovf = {k: out[k] for k in ("pair_overflow", "ovf_window", "ovf_slots",
                               "ovf_drop", "ovf_band", "ovf_slab")}
    if (out["num_contacts"] <= 0 or any(ovf.values())
            or not pen_ratio <= 0.2):
        raise AssertionError(f"{envs}-env bar missed: contacts "
                             f"{out['num_contacts']}, overflow {ovf}, "
                             f"penetration ratio {pen_ratio}")
    return pen_ratio


def phase_envs64(card: str, envs1024: dict) -> dict:
    """Bench row E at bench.py's default of 64 envs x 256 boxes:
    ``broadphase="sap"`` within the reference's sweep budget takes K6, the
    capacity the streamed solve K1, once a frame each; then K6 against its
    plain version at the settled frame and timed, and K1 against its
    plain version there, and timed."""
    from phyx_tpu_torch.broadphase import sap_kernel_inputs
    from phyx_tpu_torch.demos.run_envs import build_envs
    from phyx_tpu_torch.step import integrate_velocities, solve_inputs
    n_envs = 64
    st, cfg, out = _drive("envs", n_envs * 256, 240, ("K1", "K6"), card,
                          built=build_envs(n_envs, 256), both_ways=True)
    pen_ratio = _envs_bar(out, n_envs)
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages, null_below=True)
    replay = _replay_equals_steps(st, cfg, f"the settled {n_envs}-env frame")
    _register(f"envs {n_envs}", out, st, cfg, ("K1", "K6"))
    k6_args = sap_kernel_inputs(integrate_velocities(st.bodies, cfg),
                                cfg.max_pairs, True)
    k6 = _emit_at("K6", k6_args, f"the settled {n_envs}-env frame", True)
    # the buffer cut to half the frame's pairs: which pairs survive
    cut = dict(k6_args, max_pairs=max(1, k6["emitted"] // 2))
    cut_err, cut_counts, _, _ = _compare_emit("K6", cut)
    if cut_counts["ovf"] <= 0:
        raise AssertionError(f"K6 at a cut buffer counted no overflow: "
                             f"{cut_counts}")
    print(f"# compare: K6 == plain at the settled {n_envs}-env frame with "
          f"the buffer cut to {cut['max_pairs']} pairs: {cut_counts}",
          flush=True)
    parent = _versus_parent("K6", k6_args)
    _PROBES["K6"] = (f"the settled {n_envs}-env frame",
                     lambda: _wrappers()["K6"](**k6_args))
    # K1 at this frame's shapes, against the plain version on warm + 1 + 1
    # passes, then timed on those and on all passes
    k1 = _wrappers()["K1"]
    k1_args = solve_inputs(st, cfg)
    k1_short = dict(k1_args, vel_iters=1, pos_iters=1)
    k1_err, k1_plain_ms = _compare(k1, k1_short)
    print(f"# compare: K1 == plain at the settled {n_envs}-env frame "
          f"({int(k1_args['num_contacts'])} contacts, "
          f"{k1_args['b1'].numel()} slots), warm + 1 + 1 passes; max abs "
          f"diff {k1_err}", flush=True)
    k1_ms_short = _kernel_ms(k1, k1_short, reps=5)
    k1_ms = _kernel_ms(k1, k1_args, reps=3)
    k1_visits = _bound(k1_args)["visits"]
    lv = _k1_level_checks(dict(args=k1_args, ms_full_solve=k1_ms),
                          f"the settled {n_envs}-env frame")
    out.update(metric=f"env-steps/s @ {n_envs} envs x 256 boxes (port, H100 "
               "path)", env_steps_per_s=_per_env(out, n_envs),
               env_steps_per_s_uncaptured=_per_env(
                   dict(steps_per_s=out["steps_per_s_uncaptured"]), n_envs),
               env_steps_per_s_1024_envs=envs1024["env_steps_per_s"],
               graph_replay=replay,
               envs=n_envs, contacts_per_env=out["num_contacts"] / n_envs,
               penetration_ratio=pen_ratio, stage_device_ms=stages,
               k6_device_ms=k6["ms"], k6_wrapper_ms=k6["wrapper_ms"],
               k6_emitted=k6["emitted"], solve_ms_full=k1_ms,
               solve_share_of_frame=k1_ms / out["frame_ms"],
               k1_ns_per_visit=k1_ms * 1e6 / k1_visits, k1_levels=lv,
               reference_fingerprint=REF_E, cut="none (bench.py's default)")
    print(json.dumps(out), flush=True)
    return dict(k6, max_abs_err_cut=cut_err,
                ovf_cut=cut_counts["ovf"], max_pairs_cut=cut["max_pairs"],
                **{f"{k}_versus_parent": v for k, v in parent.items()}, k1={
        "max_abs_err_envs64": k1_err, "ms_envs64": k1_ms_short,
        "plain_ms_envs64": k1_plain_ms,
        "bound_ms_envs64": _bound(k1_short)["bound_ms"],
        "ms_full_solve_envs64": k1_ms,
        "ns_per_visit_envs64": k1_ms * 1e6 / k1_visits,
        "contacts_envs64": int(k1_args["num_contacts"]),
        **{f"{key}_envs64": v for key, v in lv.items()}})


def _k7_counts_in_device_memory(args) -> int:
    """K7's one launch with its per-row counts in device memory (the
    placement past 51,200 rows) against the plain version on ``args``: the
    whole buffer, ``num`` and ``ovf``.  Returns the mismatches (0), raising
    on any.  Not a launch of the wrapper."""
    import torch
    from phyx_tpu_torch.kernels.sweep import warp_pass
    dev = args["aabb_flat"].device
    i32 = dict(dtype=torch.int32, device=dev)
    got = [torch.empty((args["max_pairs"],), **i32) for _ in range(2)]
    got += [torch.empty((), **i32) for _ in range(2)]
    warp_pass(args["aabb_flat"], args["order"], args["dyn"], args["nact"],
              *got, args["max_pairs"],
              counts=torch.empty((args["order"].numel(),), **i32))
    ref = _plains()["K7"](**args)
    bad = sum(int((g != r).sum()) for g, r in zip(got, ref))
    if bad:
        raise AssertionError(f"K7 with its counts in device memory: {bad} "
                             "mismatches against the plain version")
    return bad


def phase_pile500(card: str) -> dict:
    """A 500-box pile under ``broadphase="sap"`` (bench.py's build()
    settings: cap 512, 2,048 pairs): K7, since 512 rows are no whole chunk,
    and K2 once a frame; then K7 against its plain version at the settled
    frame, and timed, and K2 against its plain version there, and
    timed."""
    from phyx_tpu_torch.broadphase import sap_kernel_inputs
    from phyx_tpu_torch.step import integrate_velocities
    st, cfg, out = _drive("pile", 500, 400, ("K2", "K7"), card,
                          built=_bench_row("pile", 500, "--broadphase",
                                           "sap"), both_ways=True)
    pen_ratio = out["max_penetration"] / 0.5
    if (out["num_contacts"] <= 0 or out["pair_overflow"] != 0
            or not pen_ratio <= 0.6):
        raise AssertionError(f"500-box pile bar missed: contacts "
                             f"{out['num_contacts']}, overflow "
                             f"{out['pair_overflow']}, penetration ratio "
                             f"{pen_ratio}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    replay = _replay_equals_steps(st, cfg, "the settled 500-box pile")
    _register("pile 500 sap", out, st, cfg, ("K2", "K7"))
    k7_args = sap_kernel_inputs(integrate_velocities(st.bodies, cfg),
                                cfg.max_pairs, False)
    k7 = _emit_at("K7", k7_args, "the settled 500-box frame", False)
    # the buffer cut to half the frame's pairs: which pairs survive
    cut = dict(k7_args, max_pairs=max(1, k7["emitted"] // 2))
    cut_err, cut_counts, _, _ = _compare_emit("K7", cut)
    if cut_counts["ovf"] <= 0:
        raise AssertionError(f"K7 at a cut buffer counted no overflow: "
                             f"{cut_counts}")
    _PROBES["K7"] = ("the settled 500-box frame",
                     lambda: _wrappers()["K7"](**k7_args))
    dev_err = _k7_counts_in_device_memory(k7_args)
    print(f"# compare: K7 == plain at the settled 500-box frame with the "
          f"buffer cut to {cut['max_pairs']} pairs: {cut_counts}; with its "
          f"per-row counts in device memory, max abs diff {dev_err}",
          flush=True)
    k2 = _k2_at_frame(st, cfg, "the 500-box frame")
    out.update(metric="steps/s @ 500-box pile, broadphase sap (port, H100 "
               "path)", penetration_ratio=pen_ratio, stage_device_ms=stages,
               graph_replay=replay, k7_device_ms=k7["ms"],
               k7_wrapper_ms=k7["wrapper_ms"],
               k7_emitted=k7["emitted"], solve_ms_full=k2["ms_full_solve"],
               k1_ms_full_solve=k2["k1_ms_full_solve"],
               k2_levels=k2["levels"], k2_prepass_ms=k2["prepass_ms"])
    print(json.dumps(out), flush=True)
    return dict(k7, max_abs_err_cut=cut_err, ovf_cut=cut_counts["ovf"],
                max_abs_err_counts_device_memory=dev_err,
                max_pairs_cut=cut["max_pairs"],
                k2={f"{key}_pile500": k2[key] for key in _K2_KEYS})


# bench row D's sizes by bench.py's build() (8 pairs a box, rounded up to
# 512): boxes -> (cap, max_pairs)
ROW_D = {20_000: (32_768, 160_256), 100_000: (131_072, 800_256)}
# the reference's 20k row D on the TPU v5e (BASELINE.md:24): a sanity
# band for the physics, not a target
REF_D20K = dict(steps_per_s_tpu=9.24, sap_window=272, penetration_ratio=0.825)
# the 100k avalanche's settle inside this script (bench row D settles
# 1000 frames; the script's time limit allows this many: PERF.md §4)
SETTLE_100K = 150
# bench row D's --steps: the timed windows are 10 and 20 frames, after
# two of 10 and 20 (bench.py:376-380, 397-405)
ROW_D_STEPS = 10


def phase_avalanche(card: str, boxes: int, settle: int,
                    plain_check: bool = True) -> dict:
    """Bench row D: ``--scene avalanche --boxes N --settle S --autotune``
    by bench.py's build() policy (8 pairs a box, ``sap_grid`` window 192 /
    8 hits, cap above 23,680: the tiled tier, K3) and its autotuned settle
    (bench.py:358-375: ``rollout_autotuned`` in chunks of 10, each retune
    printed as bench.py prints it; on the card each configuration is a
    captured graph, the one left freed).  Every retune keeps the contact
    slots in whole 1024-slot blocks, so the tier stays; the settle's
    wrappers launch K3 once a configuration (its warm-up frame) and no
    other kernel, the rest of its frames being replays (whose launches the
    profiler's trace reads, ``_replays_traced``).  Then frames timed both
    ways on the final configuration (``_timed``), bench.py's
    quality bar (penetration ratio <= 2.0, every ``ovf_*`` 0), stage times,
    two replays against two steps, the policies' host time at the settled
    state, and K3 at the settled frame: against its levels plain version
    on warm + 1 velocity pass (where ``plain_check``: at 100k the plain
    version's ~1 ms a level takes minutes), its pre-pass against
    ``slab_levels``, levels a pass, timed on those passes and on all of
    them.  bench.py's timing (``_timed`` with ``steps``) reads the bar at
    the frame bench.py reads it, 60 frames after the settle."""
    from phyx_tpu_torch import tiling
    from phyx_tpu_torch.broadphase import suggest_sap_hits, suggest_sap_window
    from phyx_tpu_torch.step import graph_info, release_graphs, solve_inputs
    from phyx_tpu_torch.tune import rollout_autotuned, tune_config
    release_graphs()
    cfg, st = _bench_row("avalanche", boxes)
    if (cfg.max_bodies, cfg.max_pairs) != ROW_D.get(boxes, ()):
        raise AssertionError(f"avalanche {boxes}: cap {cfg.max_bodies}, "
                             f"{cfg.max_pairs} pairs, not bench.py's")
    chunk = 10 if boxes >= 50_000 else min(10, 50)   # bench.py, --steps 10
    retunes, pools = [], []

    def on_retune(a, b, done):
        slots = 2 * b.max_pairs
        if not (slots % 1024 == 0 and tiling.resolve_tiled(
                b, b.max_bodies, slots)):
            raise AssertionError(f"retune at {done} left the tiled tier: "
                                 f"{slots} contact slots")
        pools.extend(g["pool_bytes"] for g in graph_info() if g["cfg"] == a)
        retunes.append(dict(frame=done, window=b.sap_window, hits=b.sap_hits,
                            pairs=b.max_pairs, tile_halo=b.tile_halo,
                            seconds=time.perf_counter() - t0))
        print(f"# retune@{done}: window {a.sap_window}->{b.sap_window} hits "
              f"{a.sap_hits}->{b.sap_hits} pairs {a.max_pairs}->"
              f"{b.max_pairs} tile_halo {a.tile_halo}->{b.tile_halo}",
              flush=True)

    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    st, cfg = rollout_autotuned(st, cfg, settle, chunk=chunk,
                                on_retune=on_retune)
    _sync()
    settle_s = time.perf_counter() - t0
    launches = _counts()
    configs = 1 + len(retunes)
    if launches != {k: configs if k == "K3" else 0 for k in launches}:
        raise AssertionError(f"avalanche {boxes} settle: launches "
                             f"{launches}, expected K3 once for each of "
                             f"{configs} configurations")
    if len(graph_info()) > 1:
        raise AssertionError(f"graphs of left configurations kept: "
                             f"{graph_info()}")
    print(f"# avalanche {boxes}: {settle}-frame autotuned settle in "
          f"{settle_s:.1f} s, {len(retunes)} retunes, K3 launched by its "
          f"wrapper once a configuration", flush=True)
    # the policies' host time at the settled state (suggest_sap_hits is a
    # loop over the rows in Python, as in the reference)
    t1 = time.perf_counter()
    window = suggest_sap_window(st.bodies, cfg=cfg)
    t2 = time.perf_counter()
    hits = suggest_sap_hits(st.bodies, cfg=cfg)
    t3 = time.perf_counter()
    tune_config(st, cfg)
    t4 = time.perf_counter()
    policy = dict(suggest_sap_window=window, suggest_sap_window_s=t2 - t1,
                  suggest_sap_hits=hits, suggest_sap_hits_s=t3 - t2,
                  tune_config_s=t4 - t3)

    st, out = _timed(st, cfg, ("K3",), both_ways=True, steps=ROW_D_STEPS)
    out = dict(scene="avalanche", boxes=boxes, **out)
    pen_ratio = out["max_penetration"] / 0.5
    ovf = {k: out[k] for k in ("pair_overflow", "ovf_window", "ovf_slots",
                               "ovf_drop", "ovf_band", "ovf_slab")}
    verdict = dict(penetration_ratio=pen_ratio, bar=2.0,
                   passed=not any(ovf.values()) and pen_ratio <= 2.0)
    print(f"# avalanche {boxes}: quality {verdict}, overflow {ovf}, "
          f"frame {settle + out['frames_total']}", flush=True)
    if out["num_contacts"] <= 0 or not verdict["passed"]:
        raise AssertionError(f"avalanche {boxes} bar missed: contacts "
                             f"{out['num_contacts']}, overflow {ovf}, "
                             f"penetration ratio {pen_ratio}")
    st, stages = _stage_ms(st, cfg, frames=3)
    _checked_rate(out, stages)
    what = f"the settled {boxes // 1000}k avalanche"
    replay = _replay_equals_steps(st, cfg, what)
    _register(f"avalanche {boxes}", out, st, cfg, ("K3",))

    # K3 at the settled frame: its levels plain version on warm + 1
    # velocity pass, its level schedule, timed on those and on all passes
    args = solve_inputs(st, cfg)
    if "cum" not in args:
        raise AssertionError(f"{what} did not take the slab-major path")
    k3 = _wrappers()["K3"]
    walked = _walked("K3", args)
    short = dict(args, vel_iters=1, pos_iters=0)
    lp = _equals_levels_plain("K3", short, what) if plain_check else {}
    lv = _tiled_levels("K3", args, what)
    ms_short = _kernel_ms(k3, short, reps=5)
    ms_full = _kernel_ms(k3, args, reps=3)
    passes = 1 + args["vel_iters"] + args["pos_iters"]
    full = _bound_slabs(args, walked)
    k = dict(**({} if not lp else dict(
                 max_abs_err=lp["max_abs_err_levels_plain"],
                 plain_ms=lp["levels_plain_ms"])), ms=ms_short,
             **_bound_slabs(short, walked), ms_full_solve=ms_full,
             bound_ms_full_solve=full["bound_ms"], walked_slots=walked,
             levels=lv["levels"], prepass_ms=lv["prepass_ms"],
             ns_per_level=(ms_full - lv["prepass_ms"]) * 1e6
             / max(1, passes * lv["levels"]),
             level_widths={x: lv[x] for x in ("width_p50", "width_p90",
                                              "width_p99", "width_max")})
    print(f"# K3 at {what}: {walked} slots in {lv['levels']} levels a pass "
          f"(widths p50 {lv['width_p50']}, max {lv['width_max']}); warm + 1 "
          f"velocity pass {ms_short:.4f} ms, full solve {ms_full:.4f} ms, "
          f"pre-pass {lv['prepass_ms']:.4f} ms, {k['ns_per_level']:.1f} ns a "
          f"level", flush=True)
    pools.extend(g["pool_bytes"] for g in graph_info())
    out.update(metric=f"steps/s @ {boxes}-box avalanche, --autotune (port, "
               "H100 path)", settle_frames=settle, settle_s=settle_s,
               chunk=chunk,
               frames_total=settle + out["frames_total"], card=card,
               retunes=retunes, graph_pool_bytes=pools, policy=policy,
               quality=verdict, stage_device_ms=stages, graph_replay=replay,
               final_config=dict(sap_window=cfg.sap_window,
                                 sap_hits=cfg.sap_hits,
                                 max_pairs=cfg.max_pairs,
                                 tile_halo=cfg.tile_halo),
               solve_ms_full=ms_full,
               solve_share_of_frame=ms_full / out["frame_ms"],
               k3_walked_slots=walked, k3_levels=lv["levels"],
               k3_prepass_ms=lv["prepass_ms"],
               k3_ns_per_level=k["ns_per_level"],
               reference_fingerprint=REF_D20K if boxes == 20_000 else None)
    print(json.dumps(out), flush=True)
    release_graphs()
    return dict(out=out, k3=k)


# the colored solve on the card against the same solve on the CPU: max
# abs difference of every float output (the card sums the final color
# class and the warm start in another order).  Sound readings on the H100:
# up to 2.7e-5 (the pile at 4 colors after one pass of each kind); each
# check also reads a solve one velocity pass short, which must land above
# the limit
COLORED_ATOL = 1e-4
_SOLVE_KEYS = ("vel", "angvel", "dvel", "dangvel", "accum_n", "accum_t",
               "residual", "joint_accum")


def _moved(x, device):
    """A record, a dict of records or a record tree with every tensor on
    ``device``."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return x.replace(**{f.name: _moved(getattr(x, f.name), device)
                            for f in dataclasses.fields(x)})
    return x


def _colored_solve(inputs: dict, cfg) -> dict:
    """The colored solve of one frame (``step.solve_colored``) on the
    device of ``inputs`` (the frame's contact stage), with its contact and
    joint colors (``step.colored_rows``) and the contact coloring's
    conflicts."""
    from phyx_tpu_torch.coloring import check_coloring
    from phyx_tpu_torch.step import colored_rows, solve_colored
    args = (inputs["bodies"], inputs["contacts"], inputs["joints"],
            inputs["joint_rows"], inputs["joint_warm"], cfg)
    static, colored, xj = colored_rows(*args)
    out = dict(color=colored.color,
               conflicts=check_coloring(colored, static, cfg))
    if xj is not None:
        out["joint_color"] = xj.color
    bodies, an, at, res, joints = solve_colored(*args)
    out.update(vel=bodies.vel, angvel=bodies.angvel, dvel=bodies.dvel,
               dangvel=bodies.dangvel, accum_n=an, accum_t=at, residual=res,
               joint_accum=joints.accum)
    return out


def _colored_parts(bodies, contacts, joints, jrows, jwarm, cfg) -> dict:
    """The colored solve of one frame (``step.solve_colored``) split into
    its parts, each a function of the frame's inputs and the parts before
    it: the coloring (``step.colored_rows``), the warm start, the velocity
    passes and the displacement passes."""
    from phyx_tpu_torch import solver
    from phyx_tpu_torch.step import colored_rows

    def coloring():
        return colored_rows(bodies, contacts, joints, jrows, jwarm, cfg)

    _, colored, xj = coloring()
    warm = solver.warm_start(bodies, colored, xj)
    vel = solver.solve_velocity(warm, colored, cfg, xj)[0]
    return {
        "coloring": coloring,
        "warm start": lambda: solver.warm_start(bodies, colored, xj),
        "velocity passes": lambda: solver.solve_velocity(warm, colored, cfg,
                                                         xj),
        "displacement passes": lambda: solver.solve_position(
            vel, colored, cfg, xj)}


def _solve_diff(card: dict, host: dict, what: str) -> float:
    """Max abs difference of the colored solve's float outputs, card
    (``_colored_solve`` on the card) against host (on the CPU); raises on a
    non-finite output."""
    import torch
    err = 0.0
    for k in _SOLVE_KEYS:
        a, b = card[k].cpu(), host[k]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{what}: non-finite {k}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _bit_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _colored_checks(st, cfg, what: str) -> dict:
    """At a settled frame: the colors on the card equal the CPU's (as
    integers), the coloring is conflict-free (``check_coloring`` 0), the
    share of live rows in the final class, the colored solve on the card
    within ``COLORED_ATOL`` of the same solve on the CPU while the card's
    solve one velocity pass short lands above it, and the solve and the
    whole step, each run twice on the card, equal to the bit."""
    import dataclasses

    import torch
    from phyx_tpu_torch.step import contact_stage, step
    bodies, _, contacts, jrows, jwarm = contact_stage(st, cfg)
    inputs = dict(bodies=bodies, contacts=contacts, joints=st.joints,
                  joint_rows=jrows, joint_warm=jwarm)
    card = _colored_solve(inputs, cfg)
    again = _colored_solve(inputs, cfg)
    t0 = time.perf_counter()
    host = _colored_solve(_moved(inputs, "cpu"), cfg)
    host_s = time.perf_counter() - t0
    for k in card:
        if not _bit_equal(card[k], again[k]):
            raise AssertionError(f"{what}: two colored solves of one frame "
                                 f"on the card differ in {k}")
    steps = [step(st, cfg) for _ in range(2)]
    for rec in ("bodies", "joints", "cache", "stats"):
        for f in dataclasses.fields(getattr(steps[0], rec)):
            if not _bit_equal(getattr(getattr(steps[0], rec), f.name),
                              getattr(getattr(steps[1], rec), f.name)):
                raise AssertionError(f"{what}: two steps of one frame on "
                                     f"the card differ in {rec}.{f.name}")
    for k in ("color", "joint_color", "conflicts"):
        if k in card and not torch.equal(card[k].cpu(), host[k]):
            raise AssertionError(f"{what}: {k} differs between the card "
                                 "and the CPU")
    if int(card["conflicts"]) != 0:
        raise AssertionError(f"{what}: check_coloring counts "
                             f"{int(card['conflicts'])} conflicts")
    err = _solve_diff(card, host, what)
    if not err <= COLORED_ATOL:
        raise AssertionError(f"{what}: the colored solve on the card is "
                             f"{err} from the CPU's (atol {COLORED_ATOL})")
    # the check's reach: a solve that misses its last velocity pass
    short = _solve_diff(_colored_solve(inputs, cfg.replace(
        velocity_iterations=cfg.velocity_iterations - 1)), host, what)
    if not short > COLORED_ATOL:
        raise AssertionError(f"{what}: a solve one velocity pass short is "
                             f"only {short} from the CPU's full solve, "
                             f"within the atol {COLORED_ATOL}")
    live = contacts.valid
    k = cfg.num_colors - 1
    final = int((live & (card["color"] == k)).sum())
    out = dict(colors=cfg.num_colors, live_rows=int(live.sum()),
               final_class_rows=final,
               final_class_share=final / max(1, int(live.sum())),
               max_abs_err_cpu=err, atol=COLORED_ATOL,
               max_abs_err_one_pass_short=short, cpu_solve_s=host_s)
    if "joint_color" in card:
        jlive = st.joints.kind != 0
        out.update(joint_rows=int(jlive.sum()), joint_final_class_rows=int(
            (jlive & (card["joint_color"] == k)).sum()))
    print(f"# colored at {what}: colors equal to the CPU's, 0 conflicts, "
          f"{final} of {out['live_rows']} live contact rows in the final "
          f"class ({out['final_class_share']:.4f}); solve on the card vs "
          f"the CPU: max abs diff {err} (atol {COLORED_ATOL}; one velocity "
          f"pass short: {short}); two solves and two steps of the frame on "
          "the card equal to the bit",
          flush=True)
    return out


# bench row C's frame of its quality verdict: bench.py's 300-frame settle
# and its timed 100 + 200 frames (`--steps 100`, BASELINE.md:22)
ROW_C_VERDICT_FRAME = 600


def _run_to(st, cfg, frame: int, last: int) -> dict:
    """The stats at frame ``last`` of a run at frame ``frame``, reached
    through ``rollout`` with every synchronising call an error."""
    import torch
    from phyx_tpu_torch.step import rollout, stats_dict
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = rollout(st, cfg, last - frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(stats_dict(st.stats), frame=last)


def _penetration_trace(st, cfg, frame: int, last: int) -> dict:
    """The penetration ratio (max penetration over the box half, 0.5) of
    every frame after ``frame`` up to ``last``, one replayed frame at a
    time, read after each: the peak and its frame, beside the 0.6 bar.
    The card's input states of the peak frame and of the two before it
    are kept and re-synced on the CPU (``_resync_on_cpu``)."""
    from phyx_tpu_torch.step import rollout
    ratios, inputs, peak_inputs = [], [], []
    for _ in range(frame, last):
        inputs = (inputs + [st])[-3:]
        st = rollout(st, cfg, 1)      # a copy: later replays leave it
        ratios.append(st.stats.max_penetration.item() / 0.5)
        if ratios[-1] == max(ratios):
            peak_inputs = inputs
    peak = max(ratios)
    out = dict(frames=[frame + 1, last], peak=peak,
               peak_frame=frame + 1 + ratios.index(peak),
               mean=sum(ratios) / len(ratios),
               frames_above_bar=sum(r > 0.6 for r in ratios))
    print(f"# colored 10k pile, frames {frame + 1}-{last} one at a time: "
          f"penetration ratio peak {peak:.4f} at frame {out['peak_frame']}"
          f", mean {out['mean']:.4f}, {out['frames_above_bar']} frames "
          "above the 0.6 bar", flush=True)
    out["resync"] = _resync_on_cpu(peak_inputs, cfg, out["peak_frame"])
    return out


def _resync_on_cpu(inputs: list, cfg, peak_frame: int) -> dict:
    """Each of the card's input states ``inputs`` (those of the frames up
    to ``peak_frame``) stepped one frame on the card and one frame on the
    CPU (where the colored solve's conflicting sums go through
    ``index_add``): max |dpos| and |dvel| over the bodies and |dratio| of
    the penetration ratio, each within ``COLORED_ATOL`` (the re-synced
    tolerance of tests/test_torch_colored.py), or the card's frame is not
    the CPU's."""
    import torch
    from phyx_tpu_torch.step import step
    t0 = time.perf_counter()
    rows = []
    for k, st in enumerate(inputs):
        card, host = step(st, cfg), step(_moved(st, "cpu"), cfg)
        diff = {f"d{name}": float((getattr(card.bodies, name).cpu().double()
                                   - getattr(host.bodies, name).double())
                                  .abs().max()) for name in ("pos", "vel")}
        ratio = [x.stats.max_penetration.item() / 0.5 for x in (card, host)]
        if not all(torch.isfinite(x.bodies.pos).all().item()
                   for x in (card, host)):
            raise AssertionError("re-synced colored frame: non-finite")
        rows.append(dict(frame=peak_frame - len(inputs) + 1 + k, **diff,
                         dratio=abs(ratio[0] - ratio[1]), ratio_card=ratio[0],
                         ratio_cpu=ratio[1]))
    worst = {k: max(r[k] for r in rows) for k in ("dpos", "dvel", "dratio")}
    out = dict(frames=rows, **worst, atol=COLORED_ATOL,
               seconds=time.perf_counter() - t0)
    print(f"# colored 10k pile re-synced on the CPU, frames "
          f"{rows[0]['frame']}-{rows[-1]['frame']} (the peak's and the two "
          f"before): max |dpos| {worst['dpos']}, |dvel| {worst['dvel']}, "
          f"|dratio| {worst['dratio']} (atol {COLORED_ATOL}), "
          f"{out['seconds']:.1f} s", flush=True)
    if not all(v <= COLORED_ATOL for v in worst.values()):
        raise AssertionError(f"the colored pile's frame on the card is not "
                             f"the CPU's: {rows}")
    return out


# the colored 10k pile's penetration ratio is read frame by frame from its
# settled frame to this one
PILE_TRACE_TO = 330


def _colored_scene(scene: str, boxes: int, settle: int, card: str,
                   verdict_frame: int = 0) -> dict:
    """One of bench.py's scenes under ``solver_backend="xla"`` (its
    build() policy otherwise): settled and timed by ``_drive`` (no kernel
    of K1-K7 may launch) both ways; from the settled frame, the pile's
    penetration ratio read frame by frame to ``PILE_TRACE_TO`` and the
    chain run on to ``verdict_frame`` (no host wait); bench.py's quality
    bar (the pile's at the end of its timing, the chain's at
    ``verdict_frame``), stage times, two replays against two steps, the
    checks of ``_colored_checks``, and the frame's stages handed to the
    profiler's count of kernels."""
    from phyx_tpu_torch.step import contact_stage, finish_stage, solve_stage
    if scene == "pile":
        def after(st, cfg):
            return _penetration_trace(st, cfg, settle, PILE_TRACE_TO)
    else:
        def after(st, cfg):
            return _run_to(st, cfg, settle, verdict_frame)
    st, cfg, out = _drive(scene, boxes, settle, (), card,
                          built=_bench_row(scene, boxes, "--backend", "xla"),
                          both_ways=True, after_settle=after)
    if scene == "pile":
        out["penetration_ratio"] = out["max_penetration"] / 0.5
        ok = out["num_contacts"] > 0 and out["penetration_ratio"] <= 0.6
        ovf = out["pair_overflow"]
    else:
        verdict = out["after_settle"]
        ok = verdict["residual"] <= 1e-2
        ovf = verdict["pair_overflow"]
    if ovf != 0 or not ok:
        raise AssertionError(f"colored {scene} bar missed: {out}")
    # no sleep ahead: a colored solve queues more kernels than the launch
    # queue holds, so behind a sleep the host waits for it (666 ms of
    # "enqueue" behind a 0.5 s sleep at the 10k frame).  The events time
    # the device stream's wall clock, idle gaps included; the stages' busy
    # time comes from torch.profiler (``_kernels_a_call``)
    st, stages = _stage_ms(st, cfg, frames=3, sleep_ms=0.0)
    del stages["sleep"], stages["device_only"]
    out["graph_replay"] = _replay_equals_steps(
        st, cfg, f"the settled colored {scene}")
    out["host_enqueue_ms"] = stages["host_enqueue"]
    checks = _colored_checks(st, cfg, f"the settled {scene} frame")
    if scene == "pile":
        # colors scarce: the final class sums real conflicts, through the
        # sorted index_put, which must be as deterministic as the rest.
        # One pass of each kind: over 10 + 6 passes a final class holding
        # most rows is a Jacobi sweep on a 100-deep pile, which amplifies
        # the order of its sums (0.73 card vs CPU at 4 colors in a
        # development run), so card and CPU are compared after one
        scarce = _colored_checks(st, cfg.replace(
            num_colors=4, velocity_iterations=1, position_iterations=1),
            "the settled pile frame at 4 colors, one pass of each kind")
        if scarce["final_class_rows"] <= 0:
            raise AssertionError("4 colors left the final class empty")
        checks["four_colors"] = scarce
    # the settled frame's three stages, for the profiler's count and busy
    # time (each a pure function of the frame)
    bodies, pairs, contacts, jrows, jwarm = contact_stage(st, cfg)
    solved = solve_stage(bodies, contacts, pairs, st.joints, jrows, jwarm,
                         cfg)
    where = f"the settled {scene} frame"
    _FRAMES[f"{scene} xla contact_stage"] = (
        where, lambda: contact_stage(st, cfg))
    _FRAMES[f"{scene} xla solve_stage"] = (where, lambda: solve_stage(
        bodies, contacts, pairs, st.joints, jrows, jwarm, cfg))
    _FRAMES[f"{scene} xla finish_stage"] = (where, lambda: finish_stage(
        st, cfg, solved[0], solved[4], solved[5], contacts, *solved[1:4]))
    _register(f"{scene} {boxes} xla", out, st, cfg, (), stages=tuple(
        f"{scene} xla {s}" for s in ("contact_stage", "solve_stage",
                                     "finish_stage")))
    for part, fn in _colored_parts(bodies, contacts, st.joints, jrows,
                                   jwarm, cfg).items():
        _FRAMES[f"{scene} xla solve: {part}"] = (where, fn)
    what = "box pile" if scene == "pile" else "link chain"
    out.update(metric=f"steps/s @ {boxes}-{what}, solver_backend xla "
               "(port, colored solve in torch ops)", stage_event_ms=stages,
               **checks)
    print(json.dumps(out), flush=True)
    return out


def _colored_fallback_frame() -> float:
    """One frame of a small "pallas" configuration that takes the colored
    fallback (over the reference's fused budget, contact slots not whole
    1024-slot blocks) on the card against the CPU: integers equal, floats
    within 1e-4, no kernel of K1-K7 launched.  Returns the max float
    diff."""
    from phyx_tpu_torch import SimConfig, scenes, tiling
    from phyx_tpu_torch.step import rollout, step
    cfg = SimConfig(max_bodies=64, max_pairs=5888, broadphase="sap_grid",
                    sap_window=32, solver_backend="pallas")
    if not tiling.colored_fallback(cfg, 64, 2 * 5888, 0):
        raise AssertionError("the fallback configuration is not one")
    st = rollout(scenes.pile(cfg, 60, seed=3).build("cpu"), cfg, 5)
    _reset_counts()
    card = step(_moved(st, "cuda"), cfg)
    if any(_counts().values()):
        raise AssertionError(f"colored fallback launched {_counts()}")
    worst = _close(step(st, cfg), card, "colored fallback")
    print(f"# colored fallback: a 60-box \"pallas\" frame at 11,776 contact "
          f"slots, card vs CPU: integers equal, max float diff {worst}",
          flush=True)
    return worst


def _colored_summary(colored: dict, a_call: dict, traced: dict) -> dict:
    """The colored scenes' frames: the uncaptured stages' CUDA kernels and
    device busy ms (torch.profiler), and the replayed frame's kernels,
    busy ms and idle share from the trace of its graph replays
    (``_replays_traced``), beside the replayed slope's frame ms (both
    ways: ``_frames_summary``)."""
    out = {}
    for key, scene in (("pile10k", "pile"), ("chain", "chain")):
        rec = colored[key]
        stages = {s: a_call[f"{scene} xla {s}"] for s in (
            "contact_stage", "solve_stage", "finish_stage")}
        busy = sum(v["busy_ms"] for v in stages.values())
        parts = {k[len(f"{scene} xla solve: "):]: v for k, v in a_call.items()
                 if k.startswith(f"{scene} xla solve: ")}
        t = traced[f"{scene} {rec['boxes']} xla"]
        out[key] = dict(
            steps_per_s=rec["steps_per_s"], frame_ms=rec["frame_ms"],
            host_enqueue_ms=rec["stage_event_ms"]["host_enqueue"],
            stage_event_ms=rec["stage_event_ms"], stages=stages,
            solve_parts=parts,
            kernels_a_frame=sum(v["kernels"] for v in stages.values()),
            device_busy_ms=busy,
            kernels_a_replayed_frame=t["kernels_a_frame"],
            device_busy_ms_replayed=t["device_busy_ms"],
            idle_share=t["idle_share"])
    return out


def phase_colored(card: str) -> dict:
    """The colored solve (``solver_backend="xla"``) on the 10k pile (the
    200-frame settle of its K1 run) and the 1000-link chain (the bench's
    300, its bar read at bench row C's frame 600), and one
    colored-fallback "pallas" frame."""
    t0 = time.perf_counter()
    out = dict(pile10k=_colored_scene("pile", 10_000, 200, card),
               # the chain's residual passes through the transients of its
               # fall until about frame 350 under the colored solve, in
               # the reference too (PERF.md §6), so its bar is read where
               # bench row C reads it
               chain=_colored_scene("chain", 1000, 300, card,
                                    ROW_C_VERDICT_FRAME),
               fallback_max_abs_err=_colored_fallback_frame())
    out["phase_s"] = time.perf_counter() - t0
    print(f"# colored phase: {out['phase_s']:.1f} s", flush=True)
    return out


def _states_equal(a, b, what: str) -> None:
    """Every State tensor of ``a`` equal to ``b``'s to the bit (same
    device, or ``b`` on the CPU against ``a``'s CPU copy)."""
    import torch
    from phyx_tpu_torch.step import _leaves
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = x.cpu(), y.cpu()
        if (x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(_bits(x), _bits(y))):
            raise AssertionError(f"{what}: states differ")


def _settled(label: str, scene: str, boxes: int, settle: int):
    """The settled state of a timed scene (``_SETTLED``), or, where this
    run has none (the phase called alone), the scene built and settled
    through ``rollout`` as its phase settles it."""
    from phyx_tpu_torch.step import rollout
    if label in _SETTLED:
        return _SETTLED[label]
    cfg, st = _bench_row(scene, boxes)
    return rollout(st, cfg, settle), cfg


def _aux_checkpoint(tmp: str) -> tuple:
    """Row B' (the 1k pile, K2) settled 60 frames, saved, loaded onto the
    card: the loaded state and the saved one each replay 30 frames, equal
    to the bit; the file loaded with a CPU ``like`` equals the card
    state's CPU copy.  Returns (record, the settled state, cfg)."""
    from phyx_tpu_torch import checkpoint
    from phyx_tpu_torch.step import _map, rollout
    cfg, built = _bench_row("pile", 1000)
    st = rollout(built, cfg, 60)
    path = os.path.join(tmp, "pile1k.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, st)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoint.load(path, built)
    _sync()
    load_s = time.perf_counter() - t0
    if loaded.bodies.pos.device != st.bodies.pos.device:
        raise AssertionError("checkpoint: load left the card")
    _states_equal(loaded, st, "checkpoint: the loaded state")
    _states_equal(rollout(loaded, cfg, 30), rollout(st, cfg, 30),
                  "checkpoint: 30 replayed frames after the load")
    host = checkpoint.load(path, _map(built, lambda t: t.cpu()))
    if host.bodies.pos.device.type != "cpu":
        raise AssertionError("checkpoint: a CPU like loaded off the CPU")
    _states_equal(host, _map(st, lambda t: t.cpu()),
                  "checkpoint: the file on the CPU")
    print(f"# aux checkpoint: the 1k pile at frame 60 saved "
          f"({os.path.getsize(path)} B, {save_s:.3f} s) and loaded onto "
          f"the card ({load_s:.3f} s); 30 replayed frames of each equal to "
          "the bit; the CPU load equals the card state's copy", flush=True)
    return dict(bytes=os.path.getsize(path), save_s=save_s,
                load_s=load_s, ok=True), st, cfg


def _aux_metrics(st) -> dict:
    """``snapshot`` of a card state against ``snapshot`` of its CPU copy:
    integers exact, floats within 1e-5 relative."""
    from phyx_tpu_torch.metrics import snapshot
    from phyx_tpu_torch.step import _map
    card = snapshot(st)
    host = snapshot(_map(st, lambda t: t.cpu()))
    if list(card) != list(host):
        raise AssertionError(f"metrics: keys {list(card)} != {list(host)}")
    worst = 0.0
    for k, v in host.items():
        if isinstance(v, int):
            if card[k] != v or type(card[k]) is not int:
                raise AssertionError(f"metrics: {k} {card[k]} != {v}")
        else:
            rel = abs(card[k] - v) / max(abs(v), 1e-30)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                raise AssertionError(f"metrics: {k} {card[k]} vs {v}")
    if host["num_contacts"] <= 0:
        raise AssertionError("metrics: no contacts in the settled 1k pile")
    return dict(snapshot=card, max_rel_err_floats=worst, ok=True)


def _aux_guards(st, cfg) -> dict:
    """``checked_rollout`` over 60 frames of the settled 1k pile: passes,
    replays a graph of its own (K2 launched by its wrapper once, in the
    warm-up frame) and equals ``rollout``'s 60 frames to the bit; one NaN
    velocity raises "non-finite" from ``checked_step``; the reference's
    overflow scene (tests/test_property.py:164-175) raises "overflow" from
    ``checked_rollout``."""
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.debug import GuardError, checked_rollout, \
        checked_step
    from phyx_tpu_torch.step import _GRAPHS, release_graphs, rollout
    _reset_counts()
    t0 = time.perf_counter()
    checked = checked_rollout(st, cfg, 60)
    checked_s = time.perf_counter() - t0
    launched = _counts()
    if launched != {k: int(k == "K2") for k in launched}:
        raise AssertionError(f"guards: checked_rollout launched {launched}")
    if (cfg, st.bodies.pos.device, "checked") not in _GRAPHS:
        raise AssertionError("guards: no captured guarded frame")
    _states_equal(checked, rollout(st, cfg, 60),
                  "guards: checked_rollout against rollout, 60 frames")
    bad = st.replace(bodies=st.bodies.replace(vel=st.bodies.vel.clone()))
    bad.bodies.vel[1, 0] = float("nan")
    messages = {}
    try:
        checked_step(bad, cfg)
    except GuardError as e:
        messages["nan"] = str(e)
    if "non-finite" not in messages.get("nan", ""):
        raise AssertionError("guards: a NaN velocity passed checked_step")
    ovf = SimConfig(max_bodies=32, max_pairs=4, broadphase="n2",
                    solver_backend="pallas")
    try:
        checked_rollout(scenes.pile(ovf, 12, seed=0).build(), ovf, 30)
    except GuardError as e:
        messages["overflow"] = str(e)
    release_graphs(ovf)
    if "overflow" not in messages.get("overflow", ""):
        raise AssertionError("guards: the overflow scene passed "
                             "checked_rollout")
    print(f"# aux guards: checked_rollout of 60 frames in {checked_s:.3f} s"
          f" == rollout to the bit; raised: {messages}", flush=True)
    return dict(checked_rollout_s=checked_s, raised=messages, ok=True)


def _aux_profile(label: str, st, cfg, kernel: str) -> dict:
    """``profile_step`` at a settled frame with reps=20: the reference's
    stage order, every ms positive, the host's enqueue inside the sleep;
    the frame run with the stage marks equal to ``step``'s to the bit on
    the card, launching ``kernel`` once, its marks in the stage order; a
    sleep too short on purpose (1 us) flagged as host-paced by
    ``stage_times`` and refused by ``profile_step``."""
    from phyx_tpu_torch.profiling import (STAGES, STAGES_JOINTS,
                                          profile_step, stage_times)
    from phyx_tpu_torch.step import step
    stages = STAGES_JOINTS if st.joints.capacity else STAGES
    marks = []
    _reset_counts()
    staged = step(st, cfg, marks.append)
    launched = _counts()
    if launched != {k: int(k == kernel) for k in launched}:
        raise AssertionError(f"profile {label}: the staged frame launched "
                             f"{launched}")
    if marks != stages:
        raise AssertionError(f"profile {label}: marks {marks}")
    _states_equal(staged, step(st, cfg),
                  f"profile {label}: the staged frame against step")
    rows = profile_step(st, cfg, reps=20)
    if [r["stage"] for r in rows] != stages + ["REAL full step"]:
        raise AssertionError(f"profile {label}: rows {rows}")
    if not all(r["ms"] > 0 for r in rows):
        raise AssertionError(f"profile {label}: a stage not positive: "
                             f"{rows}")
    _, short = stage_times(st, cfg, 2, sleep_ms=1e-3)
    if short["device_only"]:
        raise AssertionError(f"profile {label}: a 1 us sleep read as "
                             f"device-only: {short}")
    try:
        profile_step(st, cfg, reps=2, sleep_ms=1e-3)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError(f"profile {label}: profile_step took a 1 us "
                             "sleep")
    total = rows[-2]["cum_ms"]
    print(f"# aux profile, {label} (reps 20): " + ", ".join(
        f"{r['stage']} {r['ms']:.4f} ms" for r in rows[:-1])
        + f"; uncaptured sum of the stages {total:.4f} ms; REAL full step "
        f"(replayed) {rows[-1]['ms']:.4f} ms; behind a 1 us sleep: host "
        f"{short['host_enqueue']:.3f} ms, refused: {refused}", flush=True)
    return dict(rows=rows, stages_sum_ms=total,
                replayed_ms=rows[-1]["ms"],
                short_sleep=dict(host_enqueue_ms=short["host_enqueue"],
                                 sleep_ms=short["sleep"], refused=refused),
                ok=True)


def _aux_demos(tmp: str) -> dict:
    """``run_scene.main`` on a 500-box pile (120 steps with ``--metrics``
    and ``--checkpoint``, then 60 more with ``--resume``) and
    ``run_envs.main`` (16 envs x 64 boxes, 100 steps), in this process:
    each returns 0 and the JSONL parses."""
    import contextlib
    import io

    from phyx_tpu_torch.demos import run_envs, run_scene
    m1, m2 = os.path.join(tmp, "m1.jsonl"), os.path.join(tmp, "m2.jsonl")
    ck = os.path.join(tmp, "ck.npz")
    base = ["pile", "--boxes", "500"]
    runs = dict(
        run_scene=(run_scene.main, base + [
            "--steps", "120", "--metrics", m1, "--checkpoint", ck]),
        run_scene_resumed=(run_scene.main, base + [
            "--steps", "60", "--metrics", m2, "--resume", ck]),
        run_envs=(run_envs.main, ["--envs", "16", "--boxes", "64",
                                  "--steps", "100"]))
    out = {}
    for name, (fn, argv) in runs.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        _sync()
        lines = buf.getvalue().splitlines()
        out[name] = dict(rc=rc, s=time.perf_counter() - t0,
                         last_line=lines[-1] if lines else "")
        if rc != 0:
            raise AssertionError(f"demo {name} exited {rc}: {lines}")
    for name, path, steps in (("run_scene", m1, [60, 120]),
                              ("run_scene_resumed", m2, [60])):
        recs = [json.loads(line) for line in open(path)]
        if ([r["event"] for r in recs] != ["run_start"] + ["step"] * len(
                steps) or [r["step"] for r in recs[1:]] != steps):
            raise AssertionError(f"demo {name}: records {recs}")
        last = recs[-1]
        if last["num_contacts"] <= 0:
            raise AssertionError(f"demo {name}: {last}")
        out[name]["last_record"] = last
    print("# aux demos: " + "; ".join(
        f"{k} rc {v['rc']} in {v['s']:.2f} s: {v['last_line']}"
        for k, v in out.items()), flush=True)
    return out


def phase_aux() -> dict:
    """The auxiliaries on the card: checkpoint and resume, metrics, the
    debug guards, the stage profiler (the settled 10k pile, K1, and the
    chain, K2 with joint stages) and the two demos.  Any failed check
    raises."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, st, cfg = _aux_checkpoint(tmp)
        out = dict(checkpoint=ckpt, metrics=_aux_metrics(st),
                   guards=_aux_guards(st, cfg))
        del st
        out["profile"] = {
            label: _aux_profile(label, *_settled(label, scene, boxes,
                                                 settle), kernel)
            for label, scene, boxes, settle, kernel in (
                ("pile 10000", "pile", 10_000, 200, "K1"),
                ("chain 1000", "chain", 1000, 300, "K2"))}
        out["demos"] = _aux_demos(tmp)
    out["phase_s"] = time.perf_counter() - t0
    print(f"# aux phase: {out['phase_s']:.1f} s", flush=True)
    return out


# the multi phase (M16): row D's 100k avalanche in shards, row E's 1024
# envs in groups, bench.py's default env count as a stacked batch
SHARDS = 4
GROUPS = 4
BATCH_ENVS = 64
# the profiler's session traces the first envs of the batch only: 64 envs
# are ~37.6k kernels a frame, about as many device events as every other
# traced scene together
TRACE_BATCH_ENVS = 8
# the sharded avalanche runs chunks of this many frames, reading the
# counters once a chunk, at least SPATIAL_CHUNKS of them and at most
# SPATIAL_CHUNKS_MAX (a chunk that overflowed its halo is rebalanced and
# followed by another)
SPATIAL_CHUNK = 10
SPATIAL_CHUNKS = 3
SPATIAL_CHUNKS_MAX = 6
# the reference's cut-error envelope on a settled 1.5k-box grid at 8
# shards (tests/test_spatial.py:360): printed beside the 100k's, no gate
SPATIAL_ENVELOPE = 0.12
# frames of each slope window of the multi phase's scenes (half of row
# D's --steps, for the script's time)
MULTI_STEPS = 5
MULTI_GROUPED_STEPS = 3


def _stacked_part(batch, i: int):
    """Slice ``i`` of a stacked state (a shard, a group, an env)."""
    from phyx_tpu_torch.step import _map
    return _map(batch, lambda t: t[i])


def _small_sharded_scene(scene: str, cfg):
    """tests/test_spatial.py:36's 8 stacks of 3 on one ground, or a
    200-box pile, built on the card."""
    from phyx_tpu_torch import scenes
    from phyx_tpu_torch.world import SceneBuilder
    if scene == "pile 200":
        return scenes.pile(cfg, 200, seed=0).build()
    sb = SceneBuilder(cfg)
    sb.add_box((0.0, -1.0), (64.0, 1.0), static=True)
    for k in range(8):
        for j in range(3):
            sb.add_box((-28.0 + 8.0 * k, 0.5 + 1.02 * j), (0.5, 0.5))
    return sb.build()


def _multi_small() -> dict:
    """A sharded frame, card against CPU: the 8 stacks and a 200-box pile
    in 4 shards (``suggest_halo``), under "pallas" and "pallas_tiled",
    developed 3 sharded frames on the card; then one halo exchange on the
    card equal to the CPU's to the bit (``halo_overflow`` included) and
    one sharded frame (uncaptured, each shard's kernels launched once)
    within 1e-4 of the CPU's, integers exact."""
    import dataclasses

    from phyx_tpu_torch import SimConfig
    from phyx_tpu_torch.parallel.spatial import (_exchange_halo,
                                                 shard_spatial, spatial_frame,
                                                 suggest_halo)
    from phyx_tpu_torch.step import stats_dict
    base = dict(max_bodies=256, max_pairs=2048, broadphase="sap",
                sap_window=64)
    out = {}
    for scene in ("stacks", "pile 200"):
        for backend in ("pallas", "pallas_tiled"):
            what = f"{scene}, {backend}, {SHARDS} shards"
            tiled = backend == "pallas_tiled"
            cfg = SimConfig(**base, solver_backend=backend,
                            **(dict(tile_stride=256, tile_halo=256)
                               if tiled else {}))
            st = _small_sharded_scene(scene, cfg)
            halo = suggest_halo(st, SHARDS)
            sst, lcfg, meta = shard_spatial(
                st, cfg, SHARDS, halo,
                max_pairs_per_shard=1024 if tiled else None)
            for _ in range(3):
                sst = spatial_frame(sst, lcfg, meta.dims)
            host = _moved(sst, "cpu")
            b_card, ovf_card = _exchange_halo(sst.bodies, meta.dims)
            b_host, ovf_host = _exchange_halo(host.bodies, meta.dims)
            for f in dataclasses.fields(b_host):
                if not _bit_equal(getattr(b_card, f.name).cpu(),
                                  getattr(b_host, f.name)):
                    raise AssertionError(f"{what}: the halo exchange's "
                                         f"{f.name} differs on the card")
            if not _bit_equal(ovf_card.cpu(), ovf_host):
                raise AssertionError(f"{what}: halo_overflow differs")
            _reset_counts()
            card = spatial_frame(sst, lcfg, meta.dims)
            launched = {k: v for k, v in _counts().items() if v}
            if not launched or any(v != SHARDS for v in launched.values()):
                raise AssertionError(f"{what}: a sharded frame launched "
                                     f"{_counts()}")
            err = _close(spatial_frame(host, lcfg, meta.dims), card, what)
            out[what] = dict(halo=halo, dims=list(meta.dims),
                             halo_overflow=ovf_host.tolist(),
                             launched=launched, max_abs_err=err,
                             contacts=stats_dict(_stacked_part(
                                 card, 0).stats)["num_contacts"])
            print(f"# multi: {what} (H {halo}, L {lcfg.max_bodies}): the "
                  f"halo exchange on the card == the CPU's to the bit "
                  f"(halo_overflow {ovf_host.tolist()}); a sharded frame "
                  f"card vs CPU max float diff {err}, launches {launched}",
                  flush=True)
    return out


def _multi_spatial(card: str) -> dict:
    """Row D's 100k avalanche (bench.py's settings, the ``pallas``
    backend, settled ``SETTLE_100K`` frames unsharded by its phase) in
    ``SHARDS`` x-bands (``suggest_halo``; each shard's pair budget the
    global one's share rounded up to 512, so its contact slots come in
    whole blocks and each shard takes the tiled tier, K3): chunks of
    ``SPATIAL_CHUNK`` frames through ``spatial_rollout`` (a graph replay of
    whole 4-shard frames), the counters read once a chunk, a chunk that
    overflowed its halo rebalanced with a fresh ``suggest_halo`` (the old
    layout's graph freed first); row D's bar on the last chunk with
    ``halo_overflow`` 0; two replays equal to two uncaptured sharded
    frames to the bit; the frame timed both ways; and 20 sharded frames
    from the settled state, unsharded, against 20 unsharded frames: max
    and quantiles of |dpos| over the active bodies beside the reference's
    envelope (no gate: the reference never ran this scale), and the same
    for one shard (no cut, the rows reordered), which shows how far the
    row order alone carries a flowing avalanche."""
    import torch
    from phyx_tpu_torch.parallel.spatial import (rebalance, shard_spatial,
                                                 spatial_frame,
                                                 spatial_rollout,
                                                 suggest_halo, unshard)
    from phyx_tpu_torch.step import (_GRAPHS, release_graphs, rollout,
                                     stats_dict)
    from phyx_tpu_torch.tiling import block_pair_budget
    from phyx_tpu_torch.tune import rollout_autotuned
    boxes = 100_000
    t0 = time.perf_counter()
    if f"avalanche {boxes}" in _SETTLED:
        st, cfg = _SETTLED[f"avalanche {boxes}"]
    else:
        cfg, st = _bench_row("avalanche", boxes)
        st, cfg = rollout_autotuned(st, cfg, SETTLE_100K, chunk=10)
    release_graphs()
    per = block_pair_budget(-(-cfg.max_pairs // SHARDS))
    halo = suggest_halo(st, SHARDS)
    t1 = time.perf_counter()
    sst, lcfg, meta = shard_spatial(st, cfg, SHARDS, halo,
                                    max_pairs_per_shard=per)
    shard_s = time.perf_counter() - t1

    def layout(meta, lcfg) -> dict:
        D, S, H, M = meta.dims
        rec = dict(D=D, S=S, H=H, M=M, L=lcfg.max_bodies,
                   max_pairs_per_shard=lcfg.max_pairs)
        print(f"# multi: the 100k avalanche in {D} shards: D {D}, S {S}, "
              f"H {H}, M {M}, L {lcfg.max_bodies}; "
              f"{lcfg.max_pairs} pairs a shard", flush=True)
        return rec

    layouts = [layout(meta, lcfg)]
    chunks, rebalances = [], []
    _sync()
    _reset_counts()
    while True:
        sst = spatial_rollout(sst, lcfg, meta, SPATIAL_CHUNK)
        stats = stats_dict(_stacked_part(sst, 0).stats)
        chunks.append(dict(frames=SPATIAL_CHUNK, **stats))
        if stats["halo_overflow"] > 0:
            release_graphs(lcfg)
            halo = suggest_halo(unshard(sst, meta, st), SHARDS)
            sst, lcfg, meta = rebalance(sst, meta, st, cfg, halo=halo,
                                        max_pairs_per_shard=per)
            rebalances.append(dict(chunk=len(chunks), halo=halo))
            print(f"# multi: chunk {len(chunks)} overflowed its halo "
                  f"({stats['halo_overflow']}): rebalanced, "
                  f"suggest_halo {halo}", flush=True)
            layouts.append(layout(meta, lcfg))
        elif len(chunks) >= SPATIAL_CHUNKS:
            break
        if len(chunks) >= SPATIAL_CHUNKS_MAX:
            raise AssertionError(f"the sharded avalanche still overflows "
                                 f"its halo after {len(chunks)} chunks")
    launched = _counts()
    if launched != {k: SHARDS * len(layouts) * int(k == "K3")
                    for k in launched}:
        raise AssertionError(f"sharded avalanche chunks: launches {launched}"
                             f", expected K3 {SHARDS} x a layout's warm-up "
                             "frame")
    last = chunks[-1]
    bar = dict(penetration_ratio=last["max_penetration"] / 0.5, bar=2.0,
               overflow={k: last[k] for k in (
                   "pair_overflow", "halo_overflow", "ovf_window",
                   "ovf_slots", "ovf_drop", "ovf_band", "ovf_slab")})
    bar["passed"] = (not any(bar["overflow"].values())
                     and bar["penetration_ratio"] <= 2.0
                     and last["num_contacts"] > 0
                     and torch.isfinite(sst.bodies.pos).all().item())
    print(f"# multi: the sharded avalanche's last chunk: {bar}", flush=True)
    if not bar["passed"]:
        raise AssertionError(f"the sharded 100k avalanche missed row D's "
                             f"bar: {bar}")
    key = (lcfg, sst.bodies.pos.device, ("spatial", meta.dims))
    if key not in _GRAPHS:
        raise AssertionError("no captured sharded frame to replay")
    _reset_counts()
    replayed = spatial_rollout(sst, lcfg, meta, 2)
    if any(_counts().values()):
        raise AssertionError(f"two sharded replays launched {_counts()}")
    stepped = spatial_frame(spatial_frame(sst, lcfg, meta.dims), lcfg,
                            meta.dims)
    _states_equal(replayed, stepped, "two sharded replays against two "
                  "uncaptured sharded frames")
    print("# multi: two replays of the sharded 100k frame == two uncaptured "
          "sharded frames, every State tensor to the bit", flush=True)
    sst, timed = _timed(
        sst, lcfg, ("K3",), both_ways=True, steps=MULTI_STEPS,
        run=lambda s, k: spatial_rollout(s, lcfg, meta, k),
        frame=lambda s: spatial_frame(s, lcfg, meta.dims), times=SHARDS)
    unsharded = _TIMED.get(f"avalanche {boxes}", {})
    out = dict(scene="avalanche", boxes=boxes, shards=SHARDS, **timed,
               max_bodies=lcfg.max_bodies, max_pairs=lcfg.max_pairs,
               **stats_dict(_stacked_part(sst, 0).stats),
               unsharded_frame_ms=unsharded.get("frame_ms"),
               unsharded_frame_ms_uncaptured=unsharded.get(
                   "frame_ms_uncaptured"))
    _register(f"spatial {boxes}", out, sst, lcfg, ("K3",),
              frame=lambda s: spatial_frame(s, lcfg, meta.dims),
              run=lambda s, k: spatial_rollout(s, lcfg, meta, k),
              times=SHARDS)
    print(f"# multi: the sharded 100k frame {timed['frame_ms']:.3f} ms "
          f"replayed ({timed['frame_ms_uncaptured']:.3f} uncaptured) beside "
          f"the unsharded 100k frame of this run "
          f"{out['unsharded_frame_ms']} ms", flush=True)

    # 20 frames from the settled state, sharded and unsharded; beside them
    # one shard (no cut: the same bodies, reordered statics first and the
    # dynamics by x), which shows what the row order alone moves
    solo = rollout(st, cfg, 20)
    release_graphs(cfg)
    act = st.bodies.active
    cut = {}
    for d in (SHARDS, 1):
        s2, l2, m2 = shard_spatial(st, cfg, d, meta.dims.H,
                                   max_pairs_per_shard=per * SHARDS // d)
        back = unshard(spatial_rollout(s2, l2, m2, 20), m2, st)
        release_graphs(l2)
        err = (back.bodies.pos[act] - solo.bodies.pos[act]).abs().amax(dim=1)
        q = torch.quantile(err.double(), torch.tensor(
            [0.5, 0.99, 0.999], dtype=torch.float64, device=err.device))
        cut[d] = dict(max=err.max().item(), p50=q[0].item(), p99=q[1].item(),
                      p999=q[2].item(), above_envelope=int(
                          (err > SPATIAL_ENVELOPE).sum()))
        print(f"# multi: 20 frames from the settled avalanche in {d} "
              f"shard(s), unsharded, against 20 unsharded frames: |dpos| "
              f"over the {int(act.sum())} active bodies {cut[d]} (the "
              f"reference's envelope on a settled 1.5k-box grid at 8 "
              f"shards: {SPATIAL_ENVELOPE}; not a gate)", flush=True)
    cut_err = cut[SHARDS]["max"]
    out.update(layouts=layouts, shard_s=shard_s, chunks=chunks,
               rebalances=rebalances, quality=bar, card=card,
               cut_error_20_frames=cut_err, cut_error_quantiles=cut[SHARDS],
               reorder_error_20_frames_one_shard=cut[1],
               cut_error_envelope_reference=SPATIAL_ENVELOPE,
               seconds=time.perf_counter() - t0)
    return out


def _multi_grouped(card: str) -> dict:
    """Row E's 1024 envs x 256 boxes as ``GROUPS`` stacked mega-scenes of
    256 envs (``concat_envs_grouped``, ``demos.run_envs.envs_layout``'s
    policy for 256 envs): 10 frames of ``sharded_mega_step`` (one graph of
    a frame of all groups) equal to the bit to each group's own
    ``rollout``; every overflow counter 0; env-steps/s both ways."""
    from phyx_tpu_torch.demos.run_envs import env_builders, envs_layout
    from phyx_tpu_torch.parallel.envs import (concat_envs_grouped, each,
                                              sharded_mega_step)
    from phyx_tpu_torch.step import release_graphs, rollout, stats_dict, step
    t0 = time.perf_counter()
    per = ENVS // GROUPS
    cfg, bands = envs_layout(per, 256)
    stacked, _, _ = concat_envs_grouped(env_builders(cfg, ENVS, 256), cfg,
                                        GROUPS, **bands)
    build_s = time.perf_counter() - t0
    _sync()
    _reset_counts()
    grouped = sharded_mega_step(cfg, 10)(stacked)
    launched = _counts()
    if launched != {k: GROUPS * int(k in ("K3", "K4")) for k in launched}:
        raise AssertionError(f"grouped E-1024: launches {launched}, "
                             f"expected K3 and K4 {GROUPS} x (the warm-up "
                             "frame)")
    for g in range(GROUPS):
        _states_equal(_stacked_part(grouped, g),
                      rollout(_stacked_part(stacked, g), cfg, 10),
                      f"group {g} of the grouped E-1024 against its own "
                      "rollout")
    release_graphs(cfg)
    stats = [stats_dict(_stacked_part(grouped, g).stats)
             for g in range(GROUPS)]
    ovf = {k: sum(x[k] for x in stats) for k in (
        "pair_overflow", "ovf_window", "ovf_slots", "ovf_drop", "ovf_band",
        "ovf_slab")}
    contacts = sum(x["num_contacts"] for x in stats)
    print(f"# multi: grouped E-1024 ({GROUPS} x {per} envs, cap "
          f"{cfg.max_bodies}): 10 frames == each group's own rollout to the "
          f"bit; overflow {ovf}, {contacts} contacts", flush=True)
    if any(ovf.values()) or contacts <= 0:
        raise AssertionError(f"grouped E-1024: overflow {ovf}, contacts "
                             f"{contacts}")

    def frame(s):
        return each(lambda x: step(x, cfg), s)

    def run(s, k):
        return sharded_mega_step(cfg, k)(s)

    grouped, timed = _timed(grouped, cfg, ("K3", "K4"), both_ways=True,
                            steps=MULTI_GROUPED_STEPS, run=run, frame=frame,
                            times=GROUPS)
    out = dict(scene="envs grouped", boxes=ENVS * 256, envs=ENVS,
               groups=GROUPS, **timed,
               env_steps_per_s=timed["steps_per_s"] * ENVS,
               env_steps_per_s_uncaptured=timed["steps_per_s_uncaptured"]
               * ENVS, max_bodies=cfg.max_bodies, max_pairs=cfg.max_pairs,
               overflow=ovf, contacts_per_env=contacts / ENVS,
               build_s=build_s, card=card)
    _register(f"grouped envs {ENVS}", out, grouped, cfg, ("K3", "K4"),
              frame=frame, run=run, times=GROUPS)
    out["seconds"] = time.perf_counter() - t0
    print(f"# multi: grouped E-1024 {out['env_steps_per_s']:.1f} env-steps/s"
          f" replayed, {out['env_steps_per_s_uncaptured']:.1f} uncaptured",
          flush=True)
    return out


def _multi_batch() -> dict:
    """bench.py's default 64 envs of 256 boxes as a stacked batch
    (``make_env_batch``, each env ``envs_layout``'s one-env scene):
    10 frames of ``sharded_env_step`` (one graph of the 64 env steps)
    equal to the bit to each env's own 10 uncaptured ``step``s; the
    kernels a frame launches (the warm-up frame's, by the wrappers); the
    replayed frame timed by the slope (env-steps/s beside E-64's
    mega-scene); its first ``TRACE_BATCH_ENVS`` envs traced."""
    from phyx_tpu_torch.demos.run_envs import env_builders, envs_layout
    from phyx_tpu_torch.parallel import make_env_batch, sharded_env_step
    from phyx_tpu_torch.parallel.envs import each
    from phyx_tpu_torch.step import _map, stats_dict, step
    t0 = time.perf_counter()
    cfg, _ = envs_layout(1, 256)
    states = [sb.build() for sb in env_builders(cfg, BATCH_ENVS, 256)]
    batch = make_env_batch(states)
    vstep = sharded_env_step(cfg)
    _sync()
    _reset_counts()
    out_batch = batch
    for _ in range(10):
        out_batch = vstep(out_batch)
    launched = {k: v for k, v in _counts().items() if v}
    if not launched or any(v != BATCH_ENVS for v in launched.values()):
        raise AssertionError(f"env batch: the warm-up frame launched "
                             f"{_counts()}")
    kernels = tuple(sorted(launched))
    for e, st in enumerate(states):
        _states_equal(_stacked_part(out_batch, e), _step_loop(st, cfg, 10),
                      f"env {e} of the batch against its own steps")
    print(f"# multi: a batch of {BATCH_ENVS} envs x 256 boxes (cap "
          f"{cfg.max_bodies}): 10 frames == each env's own 10 steps to the "
          f"bit; a frame launches {kernels} {BATCH_ENVS} x each", flush=True)
    _, ms, rec = _slope(lambda s, _, k: sharded_env_step(cfg, k)(s),
                        out_batch, None, MULTI_GROUPED_STEPS, (),
                        "the env batch replayed")
    print(f"# multi: the env batch replayed {ms:.3f} ms a frame, "
          f"{BATCH_ENVS * 1e3 / ms:.1f} env-steps/s", flush=True)
    _trace(f"env batch {TRACE_BATCH_ENVS}",
           _map(out_batch, lambda t: t[:TRACE_BATCH_ENVS].clone()), cfg,
           kernels, frame=lambda s: each(lambda x: step(x, cfg), s),
           run=lambda s, k: sharded_env_step(cfg, k)(s),
           times=TRACE_BATCH_ENVS)
    return dict(envs=BATCH_ENVS, boxes=256, max_bodies=cfg.max_bodies,
                max_pairs=cfg.max_pairs, kernels=list(kernels),
                frame_ms=ms, env_steps_per_s=BATCH_ENVS * 1e3 / ms, **rec,
                seconds=time.perf_counter() - t0,
                **stats_dict(_stacked_part(out_batch, 0).stats))


def phase_multi(card: str) -> dict:
    """Multi-device (M16) on one card: a sharded frame card vs CPU, the
    100k avalanche in ``SHARDS`` shards, the grouped E-1024 and the
    64-env batch.  The shards, groups and envs share the card and step in
    turn; each frame of all of them is one captured graph."""
    from phyx_tpu_torch.step import release_graphs
    t0 = time.perf_counter()
    release_graphs()
    out = dict(small=_multi_small())
    out["spatial"] = _multi_spatial(card)
    release_graphs()
    out["grouped"] = _multi_grouped(card)
    release_graphs()
    out["batch"] = _multi_batch()
    release_graphs()
    out["phase_s"] = time.perf_counter() - t0
    print(f"# multi phase: {out['phase_s']:.1f} s", flush=True)
    return out


def _row(name, source, replaces, launches, k, timed, **extra) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "ms_full_solve", "bound_ms_full_solve", "ns_per_visit")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, **{key: k[key] for key in keys},
                library_ms=None,
                timed=timed, **extra)


# K2's numbers at each of its frames in the kernels line
_K2_KEYS = ("max_abs_err", "max_abs_err_k1", "ms", "plain_ms", "bound_ms",
            "ms_full_solve", "ms_full_solve_device", "ns_per_visit",
            "contacts", "levels", "visits_a_pass", "narrow_level_share",
            "narrow_visit_share", "prepass_ms", "ns_per_level",
            "k1_ms_full_solve", "layout")


def _emit_row(name, replaces, launches, k, small, timed, **extra) -> dict:
    """The kernels line's row of K6 or K7: ``k`` from its main path,
    ``small`` from the small inputs."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return dict(name=name, route="cuda",
                source="phyx_tpu_torch/csrc/sweep_emit.cu",
                replaces=replaces, launches=launches,
                **{key: k[key] for key in keys},
                library_ms=None, timed=timed,
                **{f"{key}_small_frames": small[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms")},
                **{key: k[key] for key in (
                    "kernel_ms", "wrapper_device_ms", "wrapper_ms",
                    "device_only",
                    "emitted", "ovf", "rows_read", "walked", "bytes", "ops")
                   if key in k}, **extra)


# bench.py's command line for the bench phase: row B' (the 1k pile, K2)
BENCH_ARGS = ("--boxes", "1000")
BENCH_TIMEOUT_S = 120


def phase_bench() -> dict:
    """Row B' through ``python3 -m phyx_tpu_torch.bench`` in a process of
    its own (the kernels load from the build this process made): exit
    code 0, the last line bench.py's JSON line of a passing ``"cuda"`` /
    ``"pallas"`` row with no overflow, and the launches its stderr
    reports K2's and no other kernel's.  Returns the line."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "phyx_tpu_torch.bench", *BENCH_ARGS],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    notes = [ln for ln in run.stderr.splitlines() if ln.startswith("# ")]
    for ln in notes:
        print(f"# bench: {ln[2:]}", flush=True)
    if run.returncode != 0:
        raise AssertionError(f"bench {' '.join(BENCH_ARGS)}: rc "
                             f"{run.returncode}: {run.stderr[-2000:]}")
    line = json.loads(run.stdout.strip().splitlines()[-1])
    extra = line["extra"]
    if not (extra["backend"] == "cuda" and extra["solver_backend"] == "pallas"
            and extra["quality"]["pass"] is True
            and extra["pair_overflow"] == 0 and line["value"] > 0):
        raise AssertionError(f"bench {' '.join(BENCH_ARGS)}: {line}")
    launched = [json.loads(ln[len("# launches "):]) for ln in notes
                if ln.startswith("# launches ")]
    if not (launched and launched[0]["K2"] > 0
            and all(v == 0 for k, v in launched[0].items() if k != "K2")):
        raise AssertionError(f"bench {' '.join(BENCH_ARGS)}: launches "
                             f"{launched}, expected K2 and no other kernel")
    print(f"# bench: {wall:.1f} s in all", flush=True)
    return line


def main() -> int:
    import argparse

    import torch
    from phyx_tpu_torch.step import release_graphs
    parser = argparse.ArgumentParser(description="Smoke run of the port on "
                                     "one GPU (see the module docstring).")
    parser.add_argument("--quick", action="store_true",
                        help="stop after the build and the small checks")
    parser.add_argument("--parent", metavar="DIR",
                        help="a tree of an earlier commit of the port: its "
                        "K4 and K6 are timed beside this tree's at their "
                        "settled frames")
    opts = parser.parse_args()
    card = phase_device()
    t_start = time.perf_counter()

    def lap(name: str) -> None:
        print(f"# phase {name} done at {time.perf_counter() - t_start:.1f} "
              "s", flush=True)

    if opts.parent:
        _PARENT.update(_parent_wrappers(opts.parent))
    phase_build()
    lap("build")
    small = phase_compare()
    tiled = phase_compare_tiled()
    sweep_small = phase_compare_sweep()
    emit_small = phase_compare_emit()
    phase_step_parity()
    lap("compare")
    if opts.quick:
        _replays_traced(_kernels_a_call())
        return 0
    pile = phase_pile10k(card)
    lap("pile10k")
    chain = phase_chain(card)
    lap("chain")
    pile1k = phase_pile1k(card)
    lap("pile1k")
    pile20k = phase_pile20k(card)
    lap("pile20k")
    envs = phase_envs1024(card)
    lap("envs1024")
    envs64 = phase_envs64(card, envs)
    lap("envs64")
    pile500 = phase_pile500(card)
    lap("pile500")
    aval20k = phase_avalanche(card, 20_000, 300)
    lap("avalanche 20k")
    aval100k = phase_avalanche(card, 100_000, SETTLE_100K,
                               plain_check=False)
    lap("avalanche 100k")
    colored = phase_colored(card)
    lap("colored")
    aux = phase_aux()
    lap("aux")
    print(json.dumps({"aux": aux}), flush=True)
    multi = phase_multi(card)
    lap("multi")
    print(json.dumps({"bench": phase_bench()}), flush=True)
    lap("bench")
    release_graphs()
    a_call = _kernels_a_call()
    traced = _replays_traced(a_call)
    lap("profiler")
    print(json.dumps({"profiler_session": _SESSION}), flush=True)
    multi["launches_a_replayed_frame"] = {
        label: {k: v // TRACED_REPLAYS for k, v in
                traced[label]["launches"].items() if v}
        for label in (f"spatial {100_000}", f"grouped envs {ENVS}",
                      f"env batch {TRACE_BATCH_ENVS}")}
    print(json.dumps({"multi": multi}), flush=True)
    print(json.dumps({"colored": _colored_summary(colored, a_call, traced)}),
          flush=True)
    print(json.dumps({"frames": _frames_summary(a_call, traced)}),
          flush=True)

    def launches(label: str, name: str) -> int:
        # the kernel's launches in the traced graph replays of a scene
        return traced[label]["launches"][name]

    passes = "warm + 1 velocity + 1 displacement pass"
    k3, k5 = pile20k["k3"], pile20k["k5"]
    # the tiled kernels' level schedule at the 20k frame
    tiled_keys = ("walked_slots", "levels", "prepass_ms", "ns_per_level",
                  "level_widths", "max_abs_err_levels_plain",
                  "levels_plain_ms", "placement", "max_abs_err_placements",
                  "ms_full_solve_placements")
    # the tiled kernels on the small frames (all passes, ungated)
    small_tiled = {name: {f"{key}_small_frames": rec[key] for key in
                          ("max_abs_err", "ms", "plain_ms", "bound_ms")}
                   for name, rec in tiled.items()}
    kernels = [
        _row("contact_solver_streamed (K1)",
             "phyx_tpu_torch/csrc/contact_solver_streamed.cu",
             "phyx_tpu/kernels/contact_solver_streamed.py:58",
             launches("pile 10000", "K1"), pile,
             f"{passes} at the 10k pile frame",
             max_abs_err_small_frames=small["K1"],
             ms_full_solve_chain_frame=chain["k1_ms_full_solve"],
             contacts=pile["contacts"], joints=pile["joints"],
             **{key: pile[key] for key in (
                 "levels", "prepass_ms", "ns_per_level", "level_widths",
                 "max_abs_err_levels_plain", "levels_plain_ms",
                 "max_abs_err_device_memory",
                 "ms_full_solve_device_memory")},
             launches_envs64=launches("envs 64", "K1"), **envs64["k1"]),
        _row("contact_solver (K2)", "phyx_tpu_torch/csrc/contact_solver.cu",
             "phyx_tpu/kernels/contact_solver.py:50",
             launches("chain 1000", "K2"), chain,
             f"{passes} at the 1000-link chain frame",
             max_abs_err_small_frames=small["K2"],
             joints=chain["joints"],
             **{key: chain[key] for key in _K2_KEYS if key not in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "ms_full_solve", "ns_per_visit")},
             launches_pile1k=launches("pile 1000", "K2"),
             **{f"{key}_pile1k": pile1k[key] for key in _K2_KEYS},
             launches_pile500=launches("pile 500 sap", "K2"),
             **pile500["k2"]),
        _row("contact_solver_tiled2 (K3)",
             "phyx_tpu_torch/csrc/contact_solver_tiled.cu",
             "phyx_tpu/kernels/contact_solver_tiled2.py:68",
             launches("pile 20000", "K3"), k3,
             "warm + 1 velocity pass at the 20k pile frame",
             **small_tiled["K3"], contacts=k3["contacts"],
             **{key: k3[key] for key in tiled_keys},
             launches_envs1024=launches(f"envs {ENVS}", "K3"), **envs["k3"],
             launches_avalanche20k=launches("avalanche 20000", "K3"),
             launches_avalanche100k=launches("avalanche 100000", "K3"),
             launches_spatial100k=launches("spatial 100000", "K3"),
             launches_grouped_envs1024=launches(f"grouped envs {ENVS}",
                                                "K3"),
             **{f"{key}_{name}": v for name, rec in (
                 ("avalanche20k", aval20k), ("avalanche100k", aval100k))
                for key, v in rec["k3"].items()}),
        _row("contact_solver_tiled (K5)",
             "phyx_tpu_torch/csrc/contact_solver_tiled.cu",
             "phyx_tpu/kernels/contact_solver_tiled.py:57", k5["launches"],
             k5,
             "warm + 1 velocity pass at the 20k pile frame's routed rows",
             **small_tiled["K5"], small_frame=tiled["K5"]["frame"],
             **{key: k5[key] for key in tiled_keys}),
        dict(name="sweep_tiled (K4)", route="cuda",
             source="phyx_tpu_torch/csrc/sweep_tiled.cu",
             replaces="phyx_tpu/kernels/sweep.py:114",
             launches=launches(f"envs {ENVS}", "K4"),
             launches_grouped_envs1024=launches(f"grouped envs {ENVS}",
                                                "K4"),
             **{key: envs[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")},
             library_ms=None,
             timed=f"the settled {ENVS}-env frame, device time of its "
                   "one launch",
             **{f"{key}_small_frames": sweep_small[key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms")},
             **{key: envs[key] for key in envs if key in (
                 "kernel_ms", "wrapper_ms", "wrapper_device_ms",
                 "device_only", "sweeps", "rows_read", "bytes")
                or key.endswith("_versus_parent")},
             kernels_a_call=a_call["K4"], emitted_pairs=envs["emitted"]),
        _emit_row("sweep_emit_v2 (K6)", "phyx_tpu/kernels/sweep.py:371",
                  launches("envs 64", "K6"), envs64, emit_small["K6"],
                  "the settled 64-env frame, device time of its one "
                  "launch", kernels_a_call=a_call["K6"],
                  launches_pile10k_check=pile["k6"]["sap_launches"], **{
                      f"{key}_pile10k": pile["k6"][key] for key in (
                          "ms", "plain_ms", "bound_ms", "emitted",
                          "rows_read", "walked")},
                  **{key: envs64[key] for key in envs64 if key in (
                      "max_abs_err_cut", "ovf_cut", "max_pairs_cut")
                     or key.endswith("_versus_parent")}),
        _emit_row("sweep_emit (K7)", "phyx_tpu/kernels/sweep.py:36",
                  launches("pile 500 sap", "K7"), pile500, emit_small["K7"],
                  "the settled 500-box frame, device time of its one "
                  "launch", kernels_a_call=a_call["K7"],
                  **{key: pile500[key] for key in (
                      "max_abs_err_cut", "ovf_cut", "max_pairs_cut",
                      "max_abs_err_counts_device_memory")}),
    ]
    for k in kernels:
        name = k["name"].split("(")[1].rstrip(")")
        batch = launches(f"env batch {TRACE_BATCH_ENVS}", name)
        if batch:
            k[f"launches_env_batch{TRACE_BATCH_ENVS}"] = batch
        k["max_abs_err"] = max(v for key, v in k.items()
                               if key.startswith("max_abs_err"))
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
        if not all(math.isfinite(k[key]) for key in ("ms", "plain_ms",
                                                     "bound_ms")):
            raise AssertionError(f"non-finite time in {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
