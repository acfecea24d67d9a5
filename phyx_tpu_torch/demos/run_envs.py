"""Headless multi-env (RL-batch) runner (``demos/run_envs.py`` of the JAX
package): bench row E as a demo.

Builds N independent pile envs, concatenates them into one band-grid
mega-scene (``parallel.envs.concat_envs``), rolls it out in chunks, and
reports per-env statistics from the one state.  On the card unless
``--cpu`` is given.

Examples:
  python -m phyx_tpu_torch.demos.run_envs --envs 16 --boxes 64 --steps 200
  python -m phyx_tpu_torch.demos.run_envs --envs 4 --boxes 16 --steps 20 --cpu
"""

from __future__ import annotations

import argparse
import sys
import time

from phyx_tpu_torch import scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.parallel.envs import concat_envs, env_positions
from phyx_tpu_torch.step import rollout


def envs_layout(num_envs: int, boxes_per_env: int, backend: str = "pallas",
                band: bool = True, broadphase: str = "sap",
                sap_window: int = 96, sap_hits: int = 8,
                segsort: bool = False, velocity_rel_tol: float = 0.0,
                position_rel_tol: float = 0.0):
    """bench.py's ``build_envs`` policy (bench row E), its defaults with
    the pallas backend: a band grid of x cells 80 apart and, from 64 envs,
    8 y-bands 400 apart, which keeps coordinates small where an x-line
    would reach float32 spacings above the contact slop; banded sweep keys
    unless ``band`` is off, so each y-band sweeps in its own x region; with
    ``segsort``, per-band segmented body sorts (the exact band layout: rows
    an env block, y-bands, x-cells), and SystemExit where they cannot
    apply.  Returns (cfg, the ``concat_envs`` band keywords)."""
    total = num_envs * (boxes_per_env + 1) + 8
    cap = max(1024, -(-total // 1024) * 1024)
    # a 256-box pile is ~23 columns (~24 units) wide: ground_half 30 and
    # band_width 80 leave cross-band gaps; piles are ~15 tall -> y 400
    y_bands = 8 if num_envs >= 64 else 1
    x_count = -(-num_envs // y_bands)
    use_segsort = (segsort and band and y_bands > 1
                   and num_envs % y_bands == 0)
    if segsort and not use_segsort:
        # a segsort row that measured the flat sort would be mislabelled
        raise SystemExit(
            "--segsort requires banding on, num_envs >= 64 and "
            f"num_envs % {y_bands} == 0 (got envs={num_envs}, "
            f"band={band}); refusing to measure the flat path under a "
            "segsort label")
    # the banded keys' span must exceed the grid's x extent
    span = 1.0
    while span < x_count * 80.0 + 256.0:
        span *= 2.0
    banded = band and y_bands > 1
    cfg = SimConfig(
        max_bodies=cap,
        max_pairs=max(1024,
                      (int(num_envs * boxes_per_env * 3.2) + 511)
                      // 512 * 512),
        broadphase=broadphase,
        sap_window=sap_window,
        sap_hits=sap_hits,
        solver_backend=backend,
        sweep_band_h=400.0 if banded else 0.0,
        sweep_band_y0=-200.0,
        sweep_band_span=span if banded else 0.0,
        sweep_band_rows=(boxes_per_env + 1) if use_segsort else 0,
        sweep_band_n=y_bands if use_segsort else 0,
        sweep_band_cols=(num_envs // y_bands) if use_segsort else 0,
        velocity_rel_tol=velocity_rel_tol,
        position_rel_tol=position_rel_tol,
    )
    return cfg, dict(band_width=80.0, y_bands=y_bands, band_height=400.0)


def env_builders(cfg: SimConfig, num_envs: int, boxes_per_env: int):
    """The policy's per-env piles: seed = env, ground half 30."""
    return [scenes.pile(cfg, boxes_per_env, seed=s, ground_half=30.0)
            for s in range(num_envs)]


def envs_scene(num_envs: int, boxes_per_env: int, **layout):
    """``envs_layout``'s mega-scene (``layout``: its keywords).  Returns
    (cfg, mega builder, env slices, env offsets)."""
    cfg, bands = envs_layout(num_envs, boxes_per_env, **layout)
    mega, slices, offsets = concat_envs(
        env_builders(cfg, num_envs, boxes_per_env), cfg, **bands)
    return cfg, mega, slices, offsets


def build_envs(num_envs: int, boxes_per_env: int, device="cuda"):
    """bench.py's ``build_envs(num_envs, boxes_per_env, "pallas")``:
    ``envs_scene``'s (cfg, state on ``device``)."""
    cfg, mega, _, _ = envs_scene(num_envs, boxes_per_env)
    return cfg, mega.build(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--boxes", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=50,
                    help="frames per rollout call")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    cfg, mega, env_slices, offsets = envs_scene(args.envs, args.boxes)
    st = mega.build("cpu" if args.cpu else "cuda")

    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        st = rollout(st, cfg, n)
        done += n
        s = st.stats
        print(f"frame {done}: contacts {int(s.num_contacts)} "
              f"overflow {int(s.pair_overflow)} "
              f"penetration {float(s.max_penetration):.3f} "
              f"({time.perf_counter() - t0:.1f}s)")

    # per-env readback: env-local positions (offsets subtracted)
    pos = env_positions(st, env_slices, offsets)
    heights = [float(p[:, 1].max()) for p in pos]
    print(f"per-env max height: min {min(heights):.2f} "
          f"median {sorted(heights)[len(heights) // 2]:.2f} "
          f"max {max(heights):.2f}")
    vel = st.bodies.vel.abs().max().item()
    print(f"batch settled: max|vel| {vel:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
