"""Capacity and window auto-tuning from scene statistics
(``phyx_tpu/tune.py``): the same policies, arguments, defaults and results,
measured in host NumPy on the current state.

    cfg2 = tune_config(state, cfg)          # measure state, resize budgets
    if cfg2 != cfg:
        state = resize(state, cfg2)         # re-capacity the pair cache

Run it on a representative (settled, densest) state: neighbourhoods grow
as scenes compact.  ``rollout_autotuned`` re-tunes between rollout chunks
whenever a chunk's overflow counters fire.  Every distinct configuration
is a new set of shapes: on the card ``step.rollout`` captures a CUDA graph
for each one, and ``rollout_autotuned`` frees the graph of a configuration
it has left.
"""

from __future__ import annotations

import dataclasses

import torch

from phyx_tpu_torch.broadphase import suggest_sap_hits, suggest_sap_window
from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.types import EMPTY, ContactCache, State

# the five per-cause counters, in the reference's order
CAUSES = ("ovf_window", "ovf_slots", "ovf_drop", "ovf_band", "ovf_slab")


def suggest_pair_budget(state: State, margin: float = 1.6) -> int:
    """Pair-slot budget from the current live pair count, with headroom:
    ``live_pairs * margin`` rounded up to a multiple of 512 (so the contact
    slots, 2 * max_pairs, come in whole 1024-slot blocks), with a floor of
    3.2 a box of the active bodies for states measured before any contacts
    exist, and at least 512."""
    live = int(state.stats.num_pairs)
    act = int(state.bodies.active.sum())
    floor = int(act * 3.2)
    want = max(int(live * margin), floor, 512)
    return -(-want // 512) * 512


def tune_config(state: State, cfg: SimConfig, margin: float = 1.5,
                pair_margin: float = 1.6) -> SimConfig:
    """``cfg`` with its data-dependent budgets sized for ``state``:

    * ``sap_window``: ``suggest_sap_window`` (the forward x-neighbour span
      percentile times ``margin``), a multiple of 8, at least 16;
    * ``sap_hits``: ``suggest_sap_hits`` (the most true forward hits + 4),
      in [8, 64];
    * ``max_pairs``: ``suggest_pair_budget``.

    Capacities that encode the scene (``max_bodies``, ``max_joints``) and
    the solver's semantics are never touched.  Returns a new SimConfig,
    equal to ``cfg`` when nothing needs resizing."""
    window = int(suggest_sap_window(state.bodies, margin=margin, cfg=cfg))
    window = max(16, -(-window // 8) * 8)
    # the reference measures hits with suggest_sap_hits' default
    # exclude_long_k=8 whatever the configuration (kept as it is)
    hits = int(suggest_sap_hits(state.bodies, cfg=cfg))
    hits = int(min(64, max(8, hits)))
    return dataclasses.replace(
        cfg,
        sap_window=window,
        sap_hits=hits,
        max_pairs=suggest_pair_budget(state, pair_margin),
    )


def _counters(state: State) -> dict:
    """``pair_overflow``, ``halo_overflow`` and the five causes: one
    device-to-host copy."""
    s = state.stats
    names = ("pair_overflow", "halo_overflow") + CAUSES
    values = torch.stack([getattr(s, k).to(torch.int64)
                          for k in names]).tolist()
    return dict(zip(names, values))


def rollout_autotuned(state: State, cfg: SimConfig, num_steps: int,
                      chunk: int = 10, margin: float = 1.5,
                      pair_margin: float = 1.6, on_retune=None):
    """A chunked, self-sizing rollout.  Runs ``chunk`` frames at a time
    (``step.rollout``: a graph replay on the card); after each chunk one
    host read of the overflow counters.  On any overflow (``pair_overflow``,
    which sums the five causes, or ``halo_overflow``) the budgets are
    re-derived from the current state (``tune_config``), grown only where
    their own counter fired: the window on ``ovf_window``, the hit slots on
    ``ovf_slots``, the pair budget on ``ovf_drop``; ``tile_halo`` doubles on
    ``ovf_slab``, and on ``ovf_window`` under the ``sap_tiled`` and ``sap``
    sweeps.  Nothing shrinks.  If the counters fire with unchanged
    suggestions, the margins escalate 1.5x a stuck chunk.  The pair cache
    is re-capacitied (``resize``) and the rollout continues with the new
    configuration; on the card the old one's captured graph is freed.

    Frames of an overflowing chunk ran with dropped pairs (that is what the
    counter means): the tuner bounds the damage to one chunk and sizes the
    next ones.  Returns ``(state, cfg)``; ``on_retune(old_cfg, new_cfg,
    frames_done)`` is called on every applied retune."""
    from phyx_tpu_torch.step import release_graphs, rollout

    done = 0
    stuck = 0
    while done < num_steps:
        n = min(chunk, num_steps - done)
        state = rollout(state, cfg, n)
        done += n
        cause = _counters(state)
        if cause["pair_overflow"] == 0 and cause["halo_overflow"] == 0:
            stuck = 0
            continue
        esc = 1.5 ** stuck
        cfg2 = tune_config(state, cfg, margin=margin * esc,
                           pair_margin=pair_margin * esc)
        # cause-targeted growth: a budget whose counter reads 0 keeps its
        # value
        if cause["ovf_window"] == 0:
            cfg2 = dataclasses.replace(cfg2, sap_window=cfg.sap_window)
        if cause["ovf_slots"] == 0:
            cfg2 = dataclasses.replace(cfg2, sap_hits=cfg.sap_hits)
        if cause["ovf_drop"] == 0:
            cfg2 = dataclasses.replace(cfg2, max_pairs=cfg.max_pairs)
        # a truncated tiled-sweep window and slab clamps in the solve both
        # mean the slab halo is too small for the x-rank spread: double it
        if cause["ovf_slab"] > 0 or (
                cause["ovf_window"] > 0 and cfg.broadphase in
                ("sap_tiled", "sap")):
            cfg2 = dataclasses.replace(
                cfg2, tile_halo=max(cfg2.tile_halo, cfg.tile_halo * 2))
        # never shrink mid-rollout
        cfg2 = dataclasses.replace(
            cfg2,
            sap_window=max(cfg2.sap_window, cfg.sap_window),
            sap_hits=max(cfg2.sap_hits, cfg.sap_hits),
            max_pairs=max(cfg2.max_pairs, cfg.max_pairs),
        )
        if cfg2 == cfg:
            stuck += 1
            continue
        if on_retune is not None:
            on_retune(cfg, cfg2, done)
        state = resize(state, cfg2)
        if state.bodies.pos.device.type == "cuda":
            release_graphs(cfg, state.bodies.pos.device)
        cfg = cfg2
        stuck = 0
    return state, cfg


def resize(state: State, cfg: SimConfig) -> State:
    """``state`` with its pair cache re-capacitied to ``cfg.max_pairs``.

    Only the contact cache depends on the pair budget.  The cache is
    lex-sorted with EMPTY slots last, so growing pads with EMPTY and
    shrinking truncates dead slots; live entries are lost only below the
    live pair count (``tune_config`` never suggests that).  Warm-start
    impulses carry over."""
    P = cfg.max_pairs
    c = state.cache

    def fit(x, fill):
        if x.shape[0] >= P:
            return x[:P]
        pad = torch.full((P - x.shape[0],) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    cache = ContactCache(
        pi=fit(c.pi, EMPTY),
        pj=fit(c.pj, EMPTY),
        fid=fit(c.fid, -1),
        normal_impulse=fit(c.normal_impulse, 0.0),
        friction_impulse=fit(c.friction_impulse, 0.0),
    )
    return state.replace(cache=cache)
