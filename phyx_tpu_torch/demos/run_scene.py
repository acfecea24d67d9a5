"""Headless scene runner (``demos/run_scene.py`` of the JAX package).

Runs any canonical scene in ``rollout`` chunks, prints its counters after
each chunk, logs JSONL metrics, optionally renders matplotlib frames, and
can checkpoint and resume.  On the card unless ``--cpu`` is given.

Examples:
  python -m phyx_tpu_torch.demos.run_scene pile --boxes 500 --steps 600
  python -m phyx_tpu_torch.demos.run_scene chain --boxes 100 --steps 400
  python -m phyx_tpu_torch.demos.run_scene bridge --boxes 16 --metrics m.jsonl
  python -m phyx_tpu_torch.demos.run_scene pile --steps 500 --checkpoint ck.npz
  python -m phyx_tpu_torch.demos.run_scene pile --steps 500 --resume ck.npz
  python -m phyx_tpu_torch.demos.run_scene pile --boxes 50 --steps 60 --cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from phyx_tpu_torch import checkpoint, scenes
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.metrics import MetricsLogger, snapshot
from phyx_tpu_torch.step import rollout


def build(args):
    """The demo's configuration for ``args.scene``: capacity the next
    power of two above boxes + 8, the sweep broadphase with window 64."""
    cap = 1
    while cap < args.boxes + 8:
        cap *= 2
    joint_scene = args.scene in ("chain", "bridge", "net")
    cfg = SimConfig(
        max_bodies=max(64, cap),
        max_pairs=max(1024, ((args.boxes * (2 if joint_scene else 4)) + 511)
                      // 512 * 512),
        max_joints=cap if joint_scene else 0,
        broadphase="sap", sap_window=64,
        solver_backend=args.backend)
    kw = {} if joint_scene else {"seed": args.seed}
    sb = getattr(scenes, args.scene)(cfg, args.boxes, **kw)
    return cfg, sb


def render_frame(state, path, k, lim):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Polygon

    b = state.bodies
    act = b.active.cpu().numpy()
    pos = b.pos.cpu().numpy()[act]
    rot = b.rot.cpu().numpy()[act]
    h = b.half_extent.cpu().numpy()[act]
    stat = b.inv_mass.cpu().numpy()[act] == 0

    fig, ax = plt.subplots(figsize=(8, 8))
    patches = []
    for p, (c, s), (hx, hy) in zip(pos, rot, h):
        corners = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]])
        world = p + corners @ np.array([[c, s], [-s, c]])
        patches.append(Polygon(world, closed=True))
    col = PatchCollection(patches, facecolor=np.where(stat, "#888", "#4a90d9"),
                          edgecolor="k", linewidth=0.3)
    ax.add_collection(col)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-2, 2 * lim)
    ax.set_aspect("equal")
    fig.savefig(os.path.join(path, f"frame_{k:05d}.png"), dpi=80)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", choices=["pile", "stack", "pyramid", "avalanche",
                                      "chain", "bridge", "net"])
    ap.add_argument("--boxes", type=int, default=200)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=60,
                    help="frames per rollout call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--render", default=None, help="PNG frame directory")
    ap.add_argument("--checkpoint", default=None, help="save state here")
    ap.add_argument("--resume", default=None, help="load state from here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    cfg, sb = build(args)
    st = sb.build("cpu" if args.cpu else "cuda")
    if args.resume:
        st = checkpoint.load(args.resume, st)
        print(f"resumed from {args.resume}")

    logger = MetricsLogger(args.metrics, dict(scene=args.scene,
                                              boxes=args.boxes)) \
        if args.metrics else None
    if args.render:
        os.makedirs(args.render, exist_ok=True)

    done = 0
    frame_idx = 0
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        st = rollout(st, cfg, n)
        done += n
        if logger:
            logger.log(done, st)
        if args.render:
            render_frame(st, args.render, frame_idx,
                         lim=max(10.0, args.boxes ** 0.5 * 1.2))
            frame_idx += 1
        s = snapshot(st)
        print(f"step {done:5d}: contacts={s['num_contacts']:5d} "
              f"pen={s['max_penetration']:.4f} residual={s['residual']:.5f} "
              f"ke={s['kinetic_energy']:.2f}")

    if logger:
        logger.close()
    if args.checkpoint:
        checkpoint.save(args.checkpoint, st)
        print(f"checkpointed to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
