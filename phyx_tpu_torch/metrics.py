"""Structured per-step metrics as JSONL (``phyx_tpu/metrics.py``).

The counters come from ``State.stats``, written on the device by the step,
so logging waits for the device only at the cadence the caller chooses.
``snapshot`` reduces on the state's device and moves one tensor of
scalars to the host.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch

from phyx_tpu_torch.types import State

_INTS = ("num_pairs", "num_contacts", "pair_overflow", "halo_overflow",
         # per-cause split of pair_overflow: which budget to grow
         "ovf_window", "ovf_slots", "ovf_drop", "ovf_band", "ovf_slab")
_FLOATS = ("max_penetration", "residual", "momentum_x", "momentum_y",
           "kinetic_energy")


def snapshot(state: State) -> dict:
    """Host dict of the counters, the linear momentum and the linear
    kinetic energy of the dynamic active bodies (one host transfer)."""
    s = state.stats
    b = state.bodies
    dyn = (b.inv_mass > 0) & b.active
    # float64 sums of the float32 terms: masked bodies contribute 0
    inv_m = torch.where(dyn, b.inv_mass, 1.0).double()
    vel = torch.where(dyn[:, None], b.vel, 0.0).double()
    momentum = (vel / inv_m[:, None]).sum(dim=0)
    energy = (0.5 * (vel ** 2).sum(dim=-1) / inv_m).sum()
    scalars = [getattr(s, k).double() for k in _INTS] + [
        s.max_penetration.double(), s.residual.double(), momentum[0],
        momentum[1], energy]
    host = torch.stack(scalars).cpu().tolist()
    out = {k: int(v) for k, v in zip(_INTS, host)}
    out.update(zip(_FLOATS, host[len(_INTS):]))
    return out


class MetricsLogger:
    """Appends one JSON line per ``log`` call."""

    def __init__(self, path_or_file, run_meta: Optional[dict] = None):
        self._file: IO = (open(path_or_file, "a")
                          if isinstance(path_or_file, str) else path_or_file)
        self._t0 = time.time()
        if run_meta:
            self._emit({"event": "run_start", **run_meta})

    def _emit(self, rec: dict):
        rec.setdefault("t_wall", round(time.time() - self._t0, 3))
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def log(self, step_idx: int, state: State, **extra):
        self._emit({"event": "step", "step": step_idx,
                    **snapshot(state), **extra})

    def close(self):
        self._file.close()
