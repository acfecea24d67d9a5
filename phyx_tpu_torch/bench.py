"""Bench harness (the JAX package's ``bench.py``): steps/s of one bench
row, printed as ONE JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

The same flags, defaults, configurations, settle, timing protocol and line
as the reference's.  ``vs_baseline`` is steps/s over the north-star target
of 1,000 steps/s at the 10k-box pile (BASELINE.json), not a measurement.
Frames run through ``step.rollout``: on the card a CUDA graph replay of
the step, fenced by ``torch.cuda.synchronize()``; with ``--cpu`` a loop of
``step`` through the kernels' plain versions.  Readings beyond the line go
to stderr on ``#`` lines.

Usage: python -m phyx_tpu_torch.bench [--boxes N] [--steps N]
           [--scene pile|avalanche|chain|bridge|net|envs]
           [--backend xla|pallas] [--autotune] [--cpu] ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from phyx_tpu_torch import scenes
from phyx_tpu_torch.broadphase import suggest_sap_window
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.demos.run_envs import envs_scene
from phyx_tpu_torch.kernels import wrappers
from phyx_tpu_torch.metrics import snapshot
from phyx_tpu_torch.step import graph_info, rollout

NORTH_STAR_STEPS_PER_SEC = 1000.0


def build_envs(num_envs: int, boxes_per_env: int, backend: str,
               band: bool = True, broadphase: str = "sap",
               sap_window: int = 96, sap_hits: int = 8,
               segsort: bool = False,
               velocity_rel_tol: float = 0.0,
               position_rel_tol: float = 0.0, device="cuda"):
    """Row E: independent piles as one block-diagonal mega-scene on a band
    grid (``demos.run_envs.envs_layout``'s policy).  Raises SystemExit on
    a ``segsort`` that cannot apply.  Returns (cfg, state on
    ``device``)."""
    cfg, mega, _, _ = envs_scene(
        num_envs, boxes_per_env, backend=backend, band=band,
        broadphase=broadphase,
        sap_window=sap_window, sap_hits=sap_hits, segsort=segsort,
        velocity_rel_tol=velocity_rel_tol, position_rel_tol=position_rel_tol)
    return cfg, mega.build(device)


def build(scene: str, boxes: int, backend: str, broadphase: str = "sap",
          sap_window: int = 96, sap_hits: int = 8,
          pairs_per_box: float = 0.0, velocity_tol: float = 0.0,
          velocity_rel_tol: float = 0.0, position_rel_tol: float = 0.0,
          device="cuda"):
    """One scene at bench capacities: bodies the next power of two above
    boxes + 8; pairs ``pairs_per_box`` a box (the scene's policy when 0)
    rounded up to 512, at least 1024, so contact slots come in whole
    1024-slot blocks.  Returns (cfg, state on ``device``)."""
    cap = 1
    while cap < boxes + 8:
        cap *= 2
    joint_scene = scene in ("chain", "bridge", "net")
    if pairs_per_box <= 0.0:
        # settled piles hold ~2.8 pairs a box, avalanche wedges ~5.6; joint
        # scenes (jointed pairs excluded) far fewer
        pairs_per_box = (2 if joint_scene
                         else 8 if scene == "avalanche" else 3.2)
    cfg = SimConfig(
        max_bodies=cap,
        max_pairs=max(1024, (int(boxes * pairs_per_box) + 511)
                      // 512 * 512),
        max_joints=cap if joint_scene else 0,
        broadphase=broadphase,
        sap_window=sap_window,
        sap_hits=sap_hits,
        num_colors=24,
        solver_backend=backend,
        velocity_tol=velocity_tol,
        velocity_rel_tol=velocity_rel_tol,
        position_rel_tol=position_rel_tol,
    )
    kw = {} if joint_scene else {"seed": 0}
    return cfg, getattr(scenes, scene)(cfg, boxes, **kw).build(device)


def _suggest_window(st, cfg=None) -> int:
    return int(suggest_sap_window(st.bodies, cfg=cfg))


def window_policy(sap_window: int, suggested: int) -> str:
    """UNDER: the configured window is below the policy's suggestion
    (truncation risk; ``ovf_window`` says whether it fired); OVER: above
    twice it (wasted sweep walk); ok otherwise."""
    return ("UNDER" if sap_window < suggested
            else "OVER" if sap_window > 2 * suggested else "ok")


# Physics-quality bars a row must meet besides pair_overflow == 0:
# max_penetration / box half (0.5 in every box scene) for the piles, envs
# and avalanches; the joint residual for the jointed scenes.
_PEN_BARS = {"pile": 0.6, "envs": 0.2, "avalanche": 2.0}
_RESIDUAL_BARS = {"chain": 1e-2, "bridge": 1e-2, "net": 1e-2}
_BOX_HALF = 0.5


def _verdict(scene: str, overflow: int, penetration: float,
             residual: float) -> dict:
    out = {"overflow_zero": overflow == 0}
    if scene in _PEN_BARS:
        ratio = penetration / _BOX_HALF
        out["penetration_ratio"] = round(ratio, 4)
        out["bar"] = _PEN_BARS[scene]
        out["pass"] = (overflow == 0) and ratio <= _PEN_BARS[scene]
    else:
        out["joint_residual"] = residual
        out["bar"] = _RESIDUAL_BARS.get(scene, 1e-2)
        out["pass"] = (overflow == 0) and residual <= out["bar"]
    return out


def quality_verdict(scene: str, st) -> dict:
    """Pass/fail physics-quality verdict for one bench row (one host
    transfer of the three counters it reads)."""
    s = st.stats
    overflow, pen, res = torch.stack([
        s.pair_overflow.double(), s.max_penetration.double(),
        s.residual.double()]).tolist()
    return _verdict(scene, int(overflow), pen, res)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m phyx_tpu_torch.bench")
    ap.add_argument("--boxes", type=int, default=10000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--settle", type=int, default=300,
                    help="pre-measurement frames so the pile reaches its "
                         "settled, contact-rich state")
    ap.add_argument("--scene", default="pile",
                    choices=["pile", "avalanche", "chain", "bridge", "net",
                             "envs"])
    ap.add_argument("--backend", default="pallas",
                    choices=["xla", "pallas"])
    # None = per-scene choice: sap_grid for single scenes, the auto "sap"
    # dispatch for --scene envs
    ap.add_argument("--broadphase", default=None,
                    choices=["sap", "sap_kernel", "sap_grid", "sap_window",
                             "sap_tiled", "n2"])
    ap.add_argument("--sap-window", type=int, default=192)
    ap.add_argument("--sap-hits", type=int, default=8)
    ap.add_argument("--pairs-per-box", type=float, default=0.0,
                    help="pair budget per box (0 = per-scene policy)")
    ap.add_argument("--velocity-tol", type=float, default=0.0,
                    help="residual-gated velocity early exit (0 = off; "
                         "changes solver semantics)")
    ap.add_argument("--rel-tol", type=float, default=0.0,
                    help="scale-normalized velocity gate: skip velocity "
                         "iterations once residual < rel_tol * max warm "
                         "impulse (0 = off)")
    ap.add_argument("--pos-rel-tol", type=float, default=0.0,
                    help="scale-normalized displacement gate (0 = off)")
    ap.add_argument("--autotune", action="store_true",
                    help="settle via tune.rollout_autotuned: budgets "
                         "(window/hits/pairs) self-size on overflow")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the kernels' plain "
                         "versions (tests only; no device numbers)")
    ap.add_argument("--no-band", action="store_true",
                    help="disable banded sweep keys for --scene envs")
    ap.add_argument("--segsort", action="store_true",
                    help="per-band segmented body sorts for --scene envs "
                         "(requires banding)")
    ap.add_argument("--envs", type=int, default=64,
                    help="env count for --scene envs (boxes = per-env size)")
    return ap


def build_row(args, device):
    """The row ``args`` (``parser()``'s namespace) names: (cfg, state)."""
    if args.scene == "envs":
        return build_envs(args.envs, args.boxes, args.backend,
                          band=not args.no_band,
                          broadphase=args.broadphase or "sap",
                          sap_window=args.sap_window,
                          sap_hits=args.sap_hits,
                          segsort=args.segsort,
                          velocity_rel_tol=args.rel_tol,
                          position_rel_tol=args.pos_rel_tol,
                          device=device)
    return build(args.scene, args.boxes, args.backend,
                 args.broadphase or "sap_grid", args.sap_window,
                 args.sap_hits, args.pairs_per_box, args.velocity_tol,
                 args.rel_tol, args.pos_rel_tol, device=device)


def _metric(args) -> tuple:
    if args.scene == "envs":
        return (f"env-steps/sec @ {args.envs} envs x {args.boxes} boxes",
                "env-steps/sec")
    return f"steps/sec @ {args.boxes}-box {args.scene}", "steps/sec"


def _note(text: str):
    print(f"# {text}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    metric, unit = _metric(args)
    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print(json.dumps({
            "metric": metric, "value": 0.0, "unit": unit,
            "vs_baseline": 0.0,
            "error": "no CUDA device: torch.cuda.is_available() is false; "
                     "no measurement possible (--cpu runs the plain "
                     "versions on the CPU)"}))
        return 2
    device = "cuda" if on_card else "cpu"
    cfg, st = build_row(args, device)
    kernels = wrappers()
    for w in kernels.values():
        w.launches = 0

    def run(s, c, n):
        # on the card no frame may wait for the device: a synchronizing
        # call inside raises
        if not on_card:
            return rollout(s, c, n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return rollout(s, c, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def fence():
        # on the CPU the frames have run when the loop returns
        if on_card:
            torch.cuda.synchronize()

    t_settle = time.perf_counter()
    retunes = []
    if args.autotune:
        from phyx_tpu_torch.tune import rollout_autotuned
        chunk = 10 if args.boxes >= 50000 else min(args.steps, 50)
        st, cfg = rollout_autotuned(
            st, cfg, args.settle, chunk=chunk,
            on_retune=lambda a, b, done: (
                retunes.append({"frame": done, "window": b.sap_window,
                                "hits": b.sap_hits, "pairs": b.max_pairs}),
                _note(f"retune@{done}: window {a.sap_window}->"
                      f"{b.sap_window} hits {a.sap_hits}->{b.sap_hits} "
                      f"pairs {a.max_pairs}->{b.max_pairs}")))
        # the two measurement lengths on the final config
        st = run(st, cfg, args.steps)
        fence()
        st = run(st, cfg, 2 * args.steps)
        fence()
    else:
        # both lengths first, then the settle, so the timed window sees
        # the full contact network, not free fall
        st = run(st, cfg, args.steps)
        fence()
        st = run(st, cfg, 2 * args.steps)
        fence()
        for _ in range(max(0, -(-args.settle // args.steps) - 3)):
            st = run(st, cfg, args.steps)
        fence()
    _note(f"settle {time.perf_counter() - t_settle:.3f} s")

    # per-step = (t(2n) - t(n)) / n cancels the fixed per-call cost; a
    # noisy pair (t2 <= t1) is measured again, and only if every try
    # stays under the noise floor is the long-run upper bound reported,
    # flagged as noise_floor
    noise_floor = False
    for attempt in range(3):
        t0 = time.perf_counter()
        st = run(st, cfg, args.steps)
        fence()
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = run(st, cfg, 2 * args.steps)
        fence()
        t2 = time.perf_counter() - t0
        _note(f"try {attempt + 1}: t(n) {t1:.6f} s, t(2n) {t2:.6f} s, "
              f"n {args.steps}")
        if t2 > t1:
            break
    dt = max(t2 - t1, 1e-9)
    if t2 <= t1:
        dt = t2 / 2.0
        noise_floor = True
    if on_card:
        # uncaptured launches only: each configuration's warm-up frame
        _note("launches " + json.dumps(
            {name: w.launches for name, w in kernels.items()}))
        _note("graphs " + json.dumps([
            dict(frame=g["frame"], max_bodies=g["cfg"].max_bodies,
                 max_pairs=g["cfg"].max_pairs, pool_bytes=g["pool_bytes"])
            for g in graph_info()]))

    steps_per_sec = args.steps / dt
    stats = snapshot(st)
    pair_iters = steps_per_sec * stats["num_contacts"] \
        * cfg.velocity_iterations
    if args.scene == "envs":
        value = round(steps_per_sec * args.envs, 2)
    else:
        value = round(steps_per_sec, 2)
    suggested = _suggest_window(st, cfg)
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": round(steps_per_sec / NORTH_STAR_STEPS_PER_SEC, 4),
        "extra": {
            "contacts": stats["num_contacts"],
            "pairs": stats["num_pairs"],
            "pair_overflow": stats["pair_overflow"],
            "ovf": {k: stats[k] for k in
                    ("ovf_window", "ovf_slots", "ovf_drop",
                     "ovf_band", "ovf_slab")},
            "pair_impulse_iters_per_sec": round(pair_iters),
            "max_penetration": stats["max_penetration"],
            "residual": stats["residual"],
            "quality": _verdict(args.scene, stats["pair_overflow"],
                                stats["max_penetration"],
                                stats["residual"]),
            "backend": device,
            "solver_backend": args.backend,
            "noise_floor": noise_floor,
            "suggested_sap_window": suggested,
            "window_policy": window_policy(cfg.sap_window, suggested),
            "autotune": ({"final_window": cfg.sap_window,
                          "final_hits": cfg.sap_hits,
                          "final_pairs": cfg.max_pairs,
                          "retunes": retunes}
                         if args.autotune else None),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
