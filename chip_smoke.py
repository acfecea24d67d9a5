"""Smoke run of the PyTorch/CUDA port (``phyx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — build the solve kernel from ``phyx_tpu_torch/csrc``.
3. compare — the kernel against its plain torch version on the packed
             solve input of a small pile frame on the card, with the
             residual gates off and on: body rows, accumulators and
             residual must be equal (exact float32 equality); then the
             whole step on the card against the step on the CPU.
4. main    — the 10k-box pile at the bench's settings (cap 16,384 bodies,
             32,256 pairs, sap_grid window 192 / 8 hits, 10+6 passes)
             through ``rollout``: a 300-frame settle in which no step may
             wait for the device, then frames timed by the slope
             t(2n) - t(n) over n, each launching the kernel once; finite
             state, contacts present, bench.py's quality bar met; the
             device time of the step's three stages (CUDA events); the
             kernel against its plain version at the frame's shapes on
             fewer passes, gates off and on (equal, as in phase 3), and
             both timed.

Prints a JSON line of the main path's physics and rate, a JSON line of
the kernels, the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

BOXES = 10_000
SETTLE = 300


def _sync():
    import torch
    torch.cuda.synchronize()


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
    from phyx_tpu_torch.kernels import contact_solver_streamed as K
    t0 = time.perf_counter()
    _, report = K.build()
    print(f"# build: {time.perf_counter() - t0:.2f} s "
          f"({K.SOURCE.name})", flush=True)
    for line in report.splitlines():
        print(f"#   nvcc: {line}")


def _compare(args) -> tuple:
    """Kernel vs plain version on the same CUDA tensors; returns (max abs
    difference, plain version's ms), raising unless every output is
    equal."""
    import torch
    from phyx_tpu_torch.kernels import contact_solver_streamed as K
    got = K.solve_contacts_streamed(**args)
    _sync()
    t0 = time.perf_counter()
    ref = K.solve_contacts_streamed_plain(**args)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0.0
    for name, a, b in zip(("body", "acc", "residual"), got, ref):
        if not torch.isfinite(a).all().item():
            raise AssertionError(f"kernel {name} has non-finite values")
        d = (a - b).abs().max().item()
        err = max(err, d)
        if not torch.equal(a, b):
            raise AssertionError(f"kernel {name} differs from the plain "
                                 f"version: max abs diff {d}")
    return err, plain_ms


def phase_compare() -> float:
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.step import rollout, solve_inputs, stats_dict
    cfg = SimConfig(max_bodies=256, max_pairs=1024, broadphase="sap_grid",
                    sap_window=64, solver_backend="pallas")
    st = rollout(scenes.pile(cfg, 200, seed=0).build("cuda"), cfg, 40)
    contacts = stats_dict(st.stats)["num_contacts"]
    if contacts < 200:
        raise AssertionError(f"small pile has only {contacts} contacts")
    err = _compare(solve_inputs(st, cfg))[0]
    gated = cfg.replace(velocity_rel_tol=1e-2, position_rel_tol=1e-2)
    err = max(err, _compare(solve_inputs(st, gated))[0])
    print(f"# compare: kernel == plain on a 200-box pile frame "
          f"({contacts} contacts, 2048 rows), gates off and on; "
          f"max abs diff {err}", flush=True)
    return err


def phase_step_parity() -> float:
    """The whole step on the card against the same step on the CPU (whose
    stages the CPU tests hold to the JAX package), re-synced every frame:
    integers exact, floats within 1e-4.  Returns the max float diff."""
    import dataclasses

    import numpy as np
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.convert import state_from_numpy, state_to_numpy
    from phyx_tpu_torch.step import step
    cfg = SimConfig(max_bodies=64, max_pairs=256, broadphase="sap_grid",
                    sap_window=32, solver_backend="pallas")
    st = scenes.pile(cfg, 60, seed=1).build("cpu")
    worst = 0.0
    for frame in range(10):
        card = state_to_numpy(step(state_from_numpy(state_to_numpy(st),
                                                    "cuda"), cfg))
        st = step(st, cfg)
        host = state_to_numpy(st)
        for rec in ("bodies", "cache", "stats"):
            for f in dataclasses.fields(getattr(host, rec)):
                a = getattr(getattr(host, rec), f.name)
                b = getattr(getattr(card, rec), f.name)
                if a.dtype.kind in "biu":
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"frame {frame}: {rec}.{f.name} differs "
                            "between the card and the CPU")
                elif a.size:
                    d = float(np.abs(a.astype(np.float64) - b).max())
                    worst = max(worst, d)
                    if not d <= 1e-4:
                        raise AssertionError(
                            f"frame {frame}: {rec}.{f.name} off by {d}")
    print(f"# step parity: 60-box pile, 10 frames, card vs CPU: integers "
          f"equal, max float diff {worst}", flush=True)
    return worst


def _kernel_ms(args, reps: int) -> float:
    import torch
    from phyx_tpu_torch.kernels import contact_solver_streamed as K
    K.solve_contacts_streamed(**args)          # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        K.solve_contacts_streamed(**args)
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _stage_ms(st, cfg, frames: int):
    """Device ms of the step's three stages, averaged over ``frames``
    frames, on CUDA events.  Each frame is queued behind a ~100 ms sleep
    kernel, so the host has queued the stages before the device reaches
    them and the events time device work alone (``device_only`` says
    whether the host's enqueue did finish inside the sleep).  Returns
    (state after the frames, dict of ms)."""
    import torch
    from phyx_tpu_torch.step import contact_stage, finish_stage, solve_stage
    names = ("contact_stage", "solve_stage", "finish_stage")
    out = dict.fromkeys(names + ("sleep", "host_enqueue"), 0.0)
    for _ in range(frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        _sync()
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        ev[1].record()
        bodies, pairs, contacts = contact_stage(st, cfg)
        ev[2].record()
        bodies, acc_n, acc_t, res = solve_stage(bodies, contacts, cfg)
        ev[3].record()
        st = finish_stage(st, cfg, bodies, pairs, contacts, acc_n, acc_t, res)
        ev[4].record()
        out["host_enqueue"] += (time.perf_counter() - t0) * 1e3 / frames
        _sync()
        out["sleep"] += ev[0].elapsed_time(ev[1]) / frames
        for k, name in enumerate(names):
            out[name] += ev[k + 1].elapsed_time(ev[k + 2]) / frames
    out["device_only"] = out["host_enqueue"] < out["sleep"]
    return st, out


def phase_main(card: str) -> dict:
    import torch
    from phyx_tpu_torch import SimConfig, scenes
    from phyx_tpu_torch.kernels import contact_solver_streamed as K
    from phyx_tpu_torch.step import rollout, solve_inputs, stats_dict

    cap = 1
    while cap < BOXES + 8:
        cap *= 2
    cfg = SimConfig(max_bodies=cap,
                    max_pairs=max(1024, (int(BOXES * 3.2) + 511)
                                  // 512 * 512),
                    broadphase="sap_grid", sap_window=192, sap_hits=8,
                    num_colors=24, solver_backend="pallas")
    st = scenes.pile(cfg, BOXES, seed=0).build("cuda")

    # settle as bench.py does (300 frames: the pile lands and its contact
    # count levels off, so the slope below times a near-stationary state),
    # then size n from the measured frame time (about 20 s for 3n frames)
    _sync()
    t0 = time.perf_counter()
    # a step must not wait for the device: any synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = rollout(st, cfg, SETTLE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _sync()
    settle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = rollout(st, cfg, 2)
    _sync()
    frame_s = (time.perf_counter() - t0) / 2
    n = max(4, min(30, int(20.0 / max(frame_s, 1e-3) / 3)))

    K.solve_contacts_streamed.launches = 0
    t0 = time.perf_counter()
    st = rollout(st, cfg, n)
    _sync()
    t1 = time.perf_counter()
    st = rollout(st, cfg, 2 * n)
    _sync()
    t2 = time.perf_counter()
    launches = K.solve_contacts_streamed.launches
    if launches != 3 * n:
        raise AssertionError(f"kernel launched {launches} times in "
                             f"{3 * n} frames")
    per_frame = ((t2 - t1) - (t1 - t0)) / n
    if not per_frame > 0.0:
        raise AssertionError(f"slope timing not positive: t(n)={t1 - t0}, "
                             f"t(2n)={t2 - t1}")

    stats = stats_dict(st.stats)
    if not torch.isfinite(st.bodies.pos).all().item():
        raise AssertionError("non-finite body positions")
    if stats["num_contacts"] <= 0:
        raise AssertionError("no contacts in the 10k pile")
    # bench.py's quality bar for piles: no overflow, penetration <= 0.6
    # of the box half (0.5)
    pen_ratio = stats["max_penetration"] / 0.5
    if stats["pair_overflow"] != 0 or not pen_ratio <= 0.6:
        raise AssertionError(f"quality bar missed: overflow "
                             f"{stats['pair_overflow']}, penetration ratio "
                             f"{pen_ratio}")

    # device time of the step's stages on three more settled frames
    st, stages = _stage_ms(st, cfg, frames=3)
    stage_sum = sum(stages[k] for k in ("contact_stage", "solve_stage",
                                        "finish_stage"))

    # the solve kernel against its plain version at this frame's shapes
    # (the plain version runs one device launch per scalar operation, so
    # it walks the warm pass + one velocity + one displacement pass, not
    # all 17): ungated, and gated with thresholds that skip every second
    # pass (so 2 + 2 passes run as 1 + 1)
    args = solve_inputs(st, cfg)
    short = dict(args, vel_iters=1, pos_iters=1)
    err, plain_ms = _compare(short)
    skip = torch.full((2,), 1e30, dtype=torch.float32, device="cuda")
    err = max(err, _compare(dict(args, vel_iters=2, pos_iters=2,
                                 tols=skip))[0])
    live = int(args["num_contacts"])
    print(f"# compare: kernel == plain at the 10k frame ({live} contacts, "
          f"{args['b1'].numel()} rows), warm + 1 + 1 passes, gates off and "
          f"on; max abs diff {err}", flush=True)
    ms_full = _kernel_ms(args, reps=3)
    ms_short = _kernel_ms(short, reps=3)

    out = dict(metric=f"steps/s @ {BOXES}-box pile (port, H100 path)",
               steps_per_s=1.0 / per_frame, frame_ms=per_frame * 1e3,
               frames_timed=3 * n, frames_total=SETTLE + 2 + 3 * n,
               settle_s=settle_s,
               t_n_s=t1 - t0, t_2n_s=t2 - t1,
               num_contacts=stats["num_contacts"],
               num_pairs=stats["num_pairs"],
               pair_overflow=stats["pair_overflow"],
               **{k: stats[k] for k in ("ovf_window", "ovf_slots",
                                        "ovf_drop", "ovf_band", "ovf_slab")},
               max_penetration=stats["max_penetration"],
               penetration_ratio=pen_ratio,
               residual=stats["residual"],
               solve_ms_full=ms_full,
               solve_share_of_frame=ms_full / (per_frame * 1e3),
               stage_device_ms=stages, stage_device_sum_ms=stage_sum,
               card=card)
    print(json.dumps(out), flush=True)
    return dict(launches=launches, ms=ms_short, plain_ms=plain_ms,
                max_abs_err=err, ms_full_solve=ms_full,
                num_contacts=live)


def main() -> int:
    import torch
    card = phase_device()
    phase_build()
    err = phase_compare()
    phase_step_parity()
    main_out = phase_main(card)
    kernels = [dict(
        name="contact_solver_streamed", route="cuda",
        source="phyx_tpu_torch/csrc/contact_solver_streamed.cu",
        replaces="phyx_tpu/kernels/contact_solver_streamed.py:58",
        launches=main_out["launches"],
        max_abs_err=max(err, main_out["max_abs_err"]),
        ms=main_out["ms"], plain_ms=main_out["plain_ms"],
        timed="warm + 1 velocity + 1 displacement pass at the 10k frame's "
              "shapes",
        ms_full_solve=main_out["ms_full_solve"],
        contacts_last_frame=main_out["num_contacts"])]
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("non-finite kernel time")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
