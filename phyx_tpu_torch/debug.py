"""Debug-mode stepping: NaN and overflow guards (``phyx_tpu/debug.py``).

The production step never waits for the host, so a NaN made in one frame
of a ``rollout`` spreads silently through every later frame, and a pair
dropped by a full budget is never reported.  ``checked_step`` and
``checked_rollout`` guard every frame instead, with the reference's
checks and messages:

  * non-finite positions, velocities or angular velocities after the step,
  * a denormalized rotation basis (|(cos, sin)|² drifting from 1),
  * a pair-budget overflow (dropped contacts: raise ``max_pairs``),
  * a spatial halo overflow.

Each frame's guards update an error record on the device (the frames run
so far, the first failing frame, its check and the count it reports), with
no host read inside the frames; the record is read once at the end and the
first error raised as ``GuardError``, with the reference's message and the
failing frame as ``GuardError.frame``.  Use in debugging and CI: the guards
add a few reductions a frame.
"""

from __future__ import annotations

import torch

from phyx_tpu_torch.config import SimConfig
from phyx_tpu_torch.step import _map, graph_for, step
from phyx_tpu_torch.types import State

# the checks in the reference's order; "{n}" takes the reported count
MESSAGES = (
    "non-finite body position after step",
    "non-finite body velocity after step",
    "non-finite angular velocity after step",
    "rotation basis denormalized",
    "pair budget overflow: {n} candidate pairs dropped (raise max_pairs)",
    "spatial halo overflow: {n} bodies reach past the exported halo (grow "
    "halo / rebalance)",
)


class GuardError(RuntimeError):
    """A guard of ``checked_step`` or ``checked_rollout`` failed: the
    message is the reference's; ``frame`` is the first failing frame of
    the call (1 = its first)."""

    def __init__(self, message: str, frame: int):
        super().__init__(message)
        self.frame = frame


def _new_record(device) -> torch.Tensor:
    """[frames run, first failing frame (0 = none), its check, its n]."""
    return torch.zeros(4, dtype=torch.int64, device=device)


def _guards(out: State, record: torch.Tensor) -> None:
    """Updates ``record`` in place with ``out``'s frame: no host read."""
    b, s = out.bodies, out.stats
    rot_norm = (b.rot * b.rot).sum(dim=1)
    rot_ok = torch.where(b.active, (rot_norm - 1.0).abs() < 1e-3, True)
    failed = torch.stack([
        ~torch.isfinite(b.pos).all(), ~torch.isfinite(b.vel).all(),
        ~torch.isfinite(b.angvel).all(), ~rot_ok.all(),
        s.pair_overflow != 0, s.halo_overflow != 0])
    counts = torch.stack([
        torch.zeros_like(s.pair_overflow)] * 4
        + [s.pair_overflow, s.halo_overflow]).to(torch.int64)
    first = torch.argmax(failed.to(torch.int32)).view(1)
    frame = record[:1] + 1
    hit = (record[1:2] == 0) & failed.any().view(1)
    err = torch.cat([frame, first, counts.index_select(0, first)])
    record.copy_(torch.cat([frame, torch.where(hit, err, record[1:])]))


def _raise(record: torch.Tensor, num_steps: int) -> None:
    """One host read of the record: checks that ``num_steps`` guarded
    frames ran, then raises the first error, if any."""
    frames, bad, check, n = record.cpu().tolist()
    if frames != num_steps:
        raise RuntimeError(f"the guards saw {frames} frames of {num_steps}")
    if bad:
        raise GuardError(MESSAGES[check].format(n=n), bad)


def checked_step(state: State, cfg: SimConfig) -> State:
    """``step`` with the NaN/denorm/overflow guards; raises ``GuardError``
    on a violation.  One uncaptured guarded frame."""
    record = _new_record(state.bodies.pos.device)
    out = step(state, cfg)
    _guards(out, record)
    _raise(record, 1)
    return out


def checked_rollout(state: State, cfg: SimConfig, num_steps: int) -> State:
    """``rollout`` with the guards in every frame: every frame runs, then
    the first failing frame's error is raised (as checkify's scan reports
    the first error), or the state returned.

    On the CPU a loop of guarded frames.  On the card a CUDA graph replay,
    as ``rollout`` is: the guarded frame (``step``, then the guards'
    update of an error record kept on the device) is captured once per
    configuration and device under a key of its own (``rollout``'s graph
    stays; ``step.release_graphs`` frees both), and its frames equal
    ``rollout``'s to the bit.  A capture that fails raises.  The graphs of
    a device share K4's and K6's scan scratch: replay them one at a time,
    on one stream or in turn, never overlapping."""
    dev = state.bodies.pos.device
    if num_steps <= 0:
        return state
    if dev.type != "cuda":
        record = _new_record(dev)
        for _ in range(num_steps):
            state = step(state, cfg)
            _guards(state, record)
        _raise(record, num_steps)
        return state

    def make_frame():
        record = _new_record(dev)

        def frame(s: State) -> State:
            out = step(s, cfg)
            _guards(out, record)
            return out

        return frame, record

    graph, done = graph_for(state, (cfg, dev, "checked"), make_frame)
    if not done:
        graph.aux.zero_()
    for _ in range(num_steps - done):
        graph.graph.replay()
    _raise(graph.aux, num_steps)
    return _map(graph.static, torch.clone)
