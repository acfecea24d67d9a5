"""Tiny cells, added by new files and entries alone (``cells.tiny_root``:
a configuration file and a manifest entry each, one with a scene kind of
its own), run through the whole harness on the CPU
with the kernels' plain versions: each traffic mix runs and its output is
correct; with the timed path broken underneath, ``correct`` comes out
false; the envs cell is refused where the reference ranks the tiled tier
by raw min x, or where one env of the sixty-four is stepped wrong; the
command without a card prints no result."""

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.reference import engine
from benchmark.tests.cells import tiny_root

SEED = 3_000_000_007


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("bench"))


REALTIME = {"steps_per_s.realtime", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("cell,metrics", [
    ("tiny-realtime", REALTIME),
    ("tiny-batch", {"steps_per_s", "setup_s"}),
    ("tiny-column", REALTIME),
    ("tiny-envs", REALTIME)])
def test_mix_runs_and_is_correct(root, cell, metrics):
    result, lines = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == metrics
    assert list(result)[-1] == "check"
    assert result["check"]["pos_gap"]["value"] <= \
        result["check"]["pos_gap"]["limit"]


def test_traced_run_reads_the_stages(root):
    result, lines = run.run_cell(root, "tiny-realtime", SEED + 1, 1.0, True,
                                 device="cpu")
    assert result["correct"], lines
    assert {"contact_stage_ms.realtime", "solve_stage_ms.realtime",
            "rollout_call_ms"} <= set(result["metrics"])
    assert "steps_per_s.realtime" not in result["metrics"]


def unchanged(call):
    """A step that returns its state unchanged."""
    return lambda state, frames: state


def half_left_out(call):
    """Every other body left where it was: half of the batch not
    stepped."""
    def broken(state, frames):
        out = call(state, frames)
        for f in ("pos", "rot", "vel", "angvel"):
            getattr(out.bodies, f)[1::2] = getattr(state.bodies, f)[1::2]
        return out
    return broken


def altered(call):
    """One answer altered where it is produced: a body moved by two
    units."""
    def broken(state, frames):
        out = call(state, frames)
        out.bodies.pos[7, 0] += 2.0
        return out
    return broken


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", ["tiny-realtime", "tiny-batch",
                                  "tiny-envs"])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    result, lines = run.run_cell(root, cell, SEED, 1.0, False,
                                 device="cpu", wrap=fault)
    assert not result["correct"], lines


def one_env_unsolved(call):
    """Env 5 of the sixty-four (6 rows, its ground first) left out of the
    solve: its boxes fall freely through the call's one frame."""
    def broken(state, frames):
        out = call(state, frames)
        b, dt = state.bodies, 1.0 / 60.0
        rows = slice(31, 36)
        out.bodies.vel[rows] = b.vel[rows] + torch.tensor([0.0, -10.0]) * dt
        out.bodies.pos[rows] = b.pos[rows] + out.bodies.vel[rows] * dt
        out.bodies.angvel[rows] = b.angvel[rows]
        out.bodies.rot[rows] = b.rot[rows]
        return out
    return broken


@pytest.mark.parametrize("seed", [SEED, 11])
def test_one_env_stepped_wrong_is_not_correct(root, seed):
    result, lines = run.run_cell(root, "tiny-envs", seed, 1.0, False,
                                 device="cpu", wrap=one_env_unsolved)
    assert not result["correct"], lines


@pytest.mark.parametrize("seed", [SEED, 11])
def test_envs_ranked_by_raw_min_x_are_refused(root, seed, monkeypatch):
    """The order matters in this layout: the reference ranking the tiled
    tier by raw min x, the 8 envs of an x cell interleave, slab
    boundaries cut other envs than the program's, and the sound run is
    refused."""
    world_from = engine.world_from
    monkeypatch.setattr(engine, "world_from", lambda *a, **k: (
        dataclasses.replace(world_from(*a, **k), band_h=0.0, band_rows=0)))
    result, lines = run.run_cell(root, "tiny-envs", seed, 1.0, False,
                                 device="cpu")
    assert not result["correct"], lines


def test_penetration_is_read_at_the_last_frame(root):
    """Every call's state deeper than the bar: only the last call's frame
    counts as failed, as the bench row's verdict reads the bar once."""
    def deep(call):
        def broken(state, frames):
            out = call(state, frames)
            out.stats.max_penetration.fill_(10.0)
            return out
        return broken

    result, _ = run.run_cell(root, "tiny-realtime", SEED, 1.0, False,
                             device="cpu", wrap=deep)
    assert result["attempted"] > 1 and result["failed"] == 1


def test_no_card_no_result(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "tiny-realtime", "--seed", "1",
                   "--seconds", "1"], root=root)
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "no CUDA device" in out.err
