"""Simulation configuration.

A field-for-field copy of ``phyx_tpu.config.SimConfig`` (same fields,
defaults, validation and ``rl_preset``).  It is copied rather than imported
because importing anything under ``phyx_tpu`` imports jax, and this package
never does.  The comments below describe the JAX package's backends; which
of them this package runs so far is stated in ``step.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (trace-time) simulation parameters.

    Capacities are static shape budgets: dynamic pair/contact counts live in
    fixed buffers with validity masks and overflow counters (SURVEY.md §7
    hard part #1).
    """

    # --- time stepping ---
    dt: float = 1.0 / 60.0
    gravity: Tuple[float, float] = (0.0, -10.0)

    # --- solver iterations (velocity = "impulses", position = "displacement",
    #     SURVEY.md §3.3 hot loops #1/#2) ---
    velocity_iterations: int = 10
    position_iterations: int = 6

    # --- contact model ---
    # Penetration allowed before the displacement pass pushes back.
    slop: float = 0.01
    # Fraction of (penetration - slop) converted to displacement target per
    # position iteration (split-impulse / pseudo-velocity scheme: the
    # velocity pass carries no Baumgarte bias; see SURVEY.md §3.4).
    contact_beta: float = 0.2
    # Cap on the per-step displacement target, to avoid explosive
    # depenetration of deeply overlapping spawns.
    max_displacement_velocity: float = 0.2
    # Relative approach speed below which restitution is ignored.
    restitution_threshold: float = 1.0
    # Fraction of joint anchor error corrected per displacement iteration
    # (user joints: revolute/distance, joints.py).
    joint_beta: float = 0.2

    # --- capacities (static shapes) ---
    max_bodies: int = 1024
    max_pairs: int = 8192           # candidate pair buffer (broadphase out)
    max_contacts: int = 16384       # = 2 * max_pairs contact-point slots
    max_joints: int = 0             # user-joint slots (revolute/distance)

    # --- broadphase ---
    # "n2"         : masked O(N^2) all-pairs (small scenes, exact)
    # "sap"        : auto — Pallas sweep kernel when the solver backend is
    #                pallas and it fits SMEM, else the windowed XLA sweep
    # "sap_window" : force the windowed XLA sweep
    # "sap_kernel" : force the Pallas emission kernel
    # "sap_grid"   : force the scanned-window XLA sweep (vector tests +
    #                per-body hit slots; no serial emission, vmap/shard-safe)
    # "sap_tiled"  : force the tiled Pallas sweep (slab AABB windows;
    #                the 100k+/mega-scene auto choice)
    broadphase: str = "sap"
    sap_window: int = 16            # forward neighbors examined per body
    # Per-body forward-hit slots for the sap_grid variant.  A settled pile
    # holds ~2.6 pairs/body; hits beyond sap_hits are counted as overflow
    # (raise it like max_pairs).
    sap_hits: int = 8
    # Bodies with the top-K largest x-extent (ground planes, slopes) are
    # excluded from the windowed sweep and tested densely vs all bodies:
    # a long body's x-interval stays open across the whole sweep, which a
    # fixed window cannot cover (classic SAP long-object failure).
    sap_long_k: int = 8

    # --- solver scheduling ---
    # Number of Gauss-Seidel color classes.  phyx packs joints into
    # conflict-free SIMD blocks (SURVEY.md §2 C7); here a color class is the
    # analogous conflict-free batch.  Contacts left uncolored after
    # `num_colors` Luby rounds fall into the final class, where scatter-add
    # makes them Jacobi-like (still deterministic and stable).
    num_colors: int = 16

    # --- tiled kernels (scenes whose body table exceeds SMEM, 100k+) ---
    # Bodies are x-sorted and processed in slab windows of
    # (tile_stride + tile_halo) rows; the halo must exceed the x-rank span
    # of any dynamic-dynamic contact (violations are counted, clamped).
    # Both must be multiples of 128 (the tiled sweep kernel internally
    # rounds its window geometry up to 1024 for i32 DMA tiling).
    # Note the solver's effective dynamic halo is tile_halo - 128: each
    # solver window begins with a 128-row zero block serving as the
    # static-partner landing pad.
    tile_stride: int = 16384
    tile_halo: int = 2048
    # Slab-major tiled pipeline (round 5): the tiled broadphase finalizes
    # pairs keyed (slab, pi, pj) with routed endpoints riding the sort,
    # and the solver runs the slab-segmented kernel with zero routing
    # sorts (K3, kernels/contact_solver_tiled.py).  False = round-4 layout
    # (per-slab block budgets + solve-side routing sorts) — kept for
    # A/B fencing and for jointed scenes (which force it off anyway).
    tiled_routing: bool = True

    # --- adaptive iteration (0.0 = off, exact fixed-count semantics) ---
    # When > 0: once a velocity iteration's residual (max |impulse delta|)
    # falls below this, the remaining velocity iterations are skipped.
    # Saves most of the solve on settled scenes; changes results only
    # below the tolerance.  ABSOLUTE impulse units — scene-scale
    # dependent (measured useless at 10k, BASELINE.md B'); prefer
    # velocity_rel_tol.
    velocity_tol: float = 0.0
    # Scale-NORMALIZED residual gates (round 3, VERDICT r2 #1).  The
    # residual is max |impulse delta| in absolute impulse units, which
    # grows with contact count (a bottom-of-pile contact carries ~70 box
    # rows at 10k), so a fixed velocity_tol can never fire at scale.
    # These gate on residual < rel_tol * SCALE where SCALE = max |warm-
    # start impulse| of the frame — the previous frame's converged
    # impulse magnitude, a scene-scale proxy that costs nothing per
    # sweep visit (the threshold is precomputed outside the kernels).
    # velocity_rel_tol gates the velocity passes (combined with
    # velocity_tol as max(abs, rel*scale) if both set); position_rel_tol
    # gates the displacement passes on the same scale (the first
    # position iteration always runs).  Cold starts (zero warm impulses)
    # never gate.  ALL backends honor these since round 4 (the tiled
    # kernel gates at pass granularity: a converged pass still streams
    # its DMA pipeline, ~100 us vs a ~58 ms sweep pass at mega scale).
    velocity_rel_tol: float = 0.0
    position_rel_tol: float = 0.0

    # --- banded sweep keys (mega-scene band grids; 0.0 = off) ---
    # The band-grid mega-scene (parallel/envs.py concat_envs y_bands>1)
    # interleaves the bodies of y-stacked envs in x-order, so the tiled
    # sweep's forward x-scan visits ~y_bands times more candidates than
    # one band holds (they fail the y test but cost the visit).  With
    # sweep_band_h > 0 the sweep x-keys become
    #   x' = x + floor((y - sweep_band_y0) / sweep_band_h) * sweep_band_span
    # — each y-band gets its own x region, restoring band-local scan
    # density.  The hi-x' interval end is inflated by span * 2^-18
    # (covers the f32 rounding of the offset add for <= 31 bands) so the
    # candidate set can only GROW within a band; pairs CROSSING a band
    # boundary are never emitted — callers must guarantee none exist
    # (concat_envs band grids do by construction).  Bodies whose own
    # AABB crosses a bucket boundary are counted into pair overflow
    # (no silent loss): size sweep_band_y0/h so nothing crosses.
    # sweep_band_span must exceed the global x extent plus slack.
    sweep_band_h: float = 0.0
    sweep_band_y0: float = 0.0
    sweep_band_span: float = 0.0

    # --- segmented (per-band batched) body sort (0 = flat sort) ---
    # XLA's TPU sort runs O(log^2 n) compare-exchange passes over the
    # FULL array; a band-grid mega-scene whose layout is known statically
    # can instead batch-sort each y-band independently — same total rows
    # per pass, log^2(rows/band) passes.  Layout contract (concat_envs):
    # env e = rows [e*rows, (e+1)*rows), e's y-band = e % n, envs
    # x-major (x = e // n), head = cols * n * rows rows, any tail rows
    # inactive.  Bodies found outside their HOME band are counted into
    # pair overflow (their cross-band pairs are not emitted — same
    # accounting as the band-boundary crossers above; size the bands so
    # no env's bodies ever leave).  Requires sweep_band_h > 0.
    sweep_band_rows: int = 0     # rows per env block (R)
    sweep_band_n: int = 0        # y-bands (B)
    sweep_band_cols: int = 0     # x-cells (X); head = X*B*R rows

    # --- solver backend ---
    # "xla"          : pure-XLA gather/scatter sweeps (always available,
    #                  the correctness fallback per SURVEY.md §7.6)
    # "pallas"       : fused SMEM-resident Pallas iteration kernel
    #                  (flagship); auto-dispatches fused -> streamed ->
    #                  tiled by capacity (step.solve_stage)
    # "pallas_tiled" : FORCE the tiled slab-window kernel regardless of
    #                  capacity (tests / micro benches / the multichip
    #                  dryrun exercise the 100k-class path at small
    #                  shapes this way; requires max_contacts % 1024 == 0
    #                  and >= 2048, like the auto dispatch)
    solver_backend: str = "xla"

    def __post_init__(self):
        if self.max_contacts < 2 * self.max_pairs:
            object.__setattr__(self, "max_contacts", 2 * self.max_pairs)
        if self.broadphase not in ("n2", "sap", "sap_window", "sap_kernel",
                                   "sap_grid", "sap_tiled"):
            raise ValueError(f"unknown broadphase {self.broadphase!r}")
        if self.solver_backend not in ("xla", "pallas", "pallas_tiled"):
            raise ValueError(f"unknown solver_backend {self.solver_backend!r}")
        if self.tile_stride % 128 or self.tile_halo % 128:
            raise ValueError("tile_stride/tile_halo must be multiples of 128")
        if self.sweep_band_h > 0.0 and self.sweep_band_span <= 0.0:
            raise ValueError("sweep_band_h > 0 requires sweep_band_span")
        seg = (self.sweep_band_rows, self.sweep_band_n, self.sweep_band_cols)
        if any(s > 0 for s in seg):
            if not all(s > 0 for s in seg):
                raise ValueError("sweep_band_rows/_n/_cols must be set "
                                 "together")
            if self.sweep_band_h <= 0.0:
                raise ValueError("segmented band sort requires "
                                 "sweep_band_h > 0")

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def rl_preset(cls, **kw) -> "SimConfig":
        """Preset for RL-style batched-env workloads (mega-scenes of
        small, genuinely-converging envs — BASELINE.md row E).

        Sets ``velocity_rel_tol = 1e-2``: the scale-normalized velocity
        gate, fenced at settled 1024-env config E at +22% (round 5:
        927 -> ~1130 env-steps/s) with QUALITY-BOUNDED trajectory
        deviation — 500-frame divergence run (BASELINE.md round-5
        table): worst-case RMS position drift < 1% of a box-half with
        no growth trend, contact-set churn <= 0.9%, penetration within
        0.7% of ungated, overflow 0.  The gate changes fixed-iteration
        semantics (the drift is real, 4 orders above the perturbation
        control), so it is opt-in — this preset IS the opt-in; right
        where per-env trajectories must be plausible, not
        bit-reproducible.  Do NOT use it for deep monolithic piles: a
        10k-box pile re-solves every frame and the gate either never
        fires or degrades physics (fenced negative, BASELINE.md
        round-3 notes).  Add ``position_rel_tol=1e-2`` only where <=5%
        penetration / ~1.3% churn is acceptable for another ~+30%.

        Any field can be overridden: ``SimConfig.rl_preset(
        max_bodies=..., broadphase="sap", ...)``."""
        kw.setdefault("velocity_rel_tol", 1e-2)
        return cls(**kw)
