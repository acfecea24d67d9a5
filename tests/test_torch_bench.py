"""The port's bench CLI (``phyx_tpu_torch.bench``) against the JAX
package's ``bench.py`` (CPU): the row configurations and states, the
quality verdict, the window readouts and the JSON line's key tree; the CLI
without a CUDA device."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from phyx_tpu_torch import bench
from phyx_tpu_torch.convert import state_to_numpy
from phyx_tpu_torch.step import rollout
from phyx_tpu_torch.types import SolverStats

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORDS = ("bodies", "joints", "cache", "stats")


@pytest.fixture
def ref():
    """bench.py, without the persistent compilation cache its import
    turns on for the rest of the process."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    import bench as ref_bench
    for k, v in before.items():
        jax.config.update(k, v)
    return ref_bench


def leaves(state) -> dict:
    out = {}
    for rec in RECORDS:
        sub = getattr(state, rec)
        for f in dataclasses.fields(sub):
            out[f"{rec}/{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def assert_same_row(got, want):
    """(cfg, state) of the port equal to bench.py's: every config field,
    every state leaf's dtype, shape and bytes."""
    cfg, st = got
    jcfg, jst = want
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    a, b = leaves(state_to_numpy(st)), leaves(jst)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# --- build -------------------------------------------------------------------

@pytest.mark.parametrize("scene,boxes", [
    ("pile", 40), ("avalanche", 40), ("chain", 24), ("bridge", 12),
    ("net", 16)])
def test_build_matches_bench(ref, scene, boxes):
    """The CLI's defaults (sap_grid, window 192, 8 hits) and the pallas
    backend."""
    assert_same_row(
        bench.build(scene, boxes, "pallas", "sap_grid", 192, 8,
                    device="cpu"),
        ref.build(scene, boxes, "pallas", "sap_grid", 192, 8))


@pytest.mark.parametrize("scene,kw", [
    ("pile", dict(pairs_per_box=5.0, velocity_tol=1e-3)),
    ("avalanche", dict(broadphase="sap_window", sap_window=64, sap_hits=4,
                       velocity_rel_tol=0.2, position_rel_tol=0.1)),
    ("chain", dict(pairs_per_box=1.5, broadphase="n2")),
])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_build_flags_match_bench(ref, scene, kw, backend):
    """Non-default flags, and bench.py's own function defaults (window 96,
    broadphase "sap") where a flag is not given."""
    assert_same_row(bench.build(scene, 30, backend, **kw, device="cpu"),
                    ref.build(scene, 30, backend, **kw))


# --- build_envs --------------------------------------------------------------

@pytest.mark.parametrize("envs,boxes,kw", [
    (16, 24, {}),
    (16, 24, dict(band=False, sap_window=192)),
    (64, 4, {}),                          # the 8-band branch
    (64, 4, dict(band=False)),
    (64, 4, dict(segsort=True, broadphase="sap_tiled")),
    (64, 4, dict(segsort=True, velocity_rel_tol=0.2,
                 position_rel_tol=0.1, sap_hits=4)),
])
def test_build_envs_matches_bench(ref, envs, boxes, kw):
    assert_same_row(
        bench.build_envs(envs, boxes, "pallas", **kw, device="cpu"),
        ref.build_envs(envs, boxes, "pallas", **kw))


@pytest.mark.parametrize("envs,kw", [
    (16, dict(segsort=True)),                # one y-band
    (64, dict(segsort=True, band=False)),    # banding off
    (68, dict(segsort=True)),                # 68 % 8 != 0
])
def test_build_envs_segsort_refused_as_bench(ref, envs, kw):
    with pytest.raises(SystemExit) as want:
        ref.build_envs(envs, 4, "pallas", **kw)
    with pytest.raises(SystemExit) as got:
        bench.build_envs(envs, 4, "pallas", **kw, device="cpu")
    assert str(got.value) == str(want.value)


# --- quality_verdict ---------------------------------------------------------

def _values_around(bar: float, scale: float) -> list:
    """float32 values just under, at and just over ``bar * scale``."""
    at = np.float32(bar * scale)
    return [np.nextafter(at, np.float32(0)), at,
            np.nextafter(at, np.float32(np.inf))]


@pytest.mark.parametrize("overflow", [0, 1])
@pytest.mark.parametrize("scene", ["pile", "avalanche", "chain", "bridge",
                                   "net", "envs"])
def test_quality_verdict_matches_bench(ref, scene, overflow):
    """Hand-made stats around each bar: the penetration bars' ratio
    (penetration / 0.5) and the joint residual's."""
    pen_bar = ref._PEN_BARS.get(scene)
    pens = (_values_around(pen_bar, ref._BOX_HALF) if pen_bar
            else [np.float32(0.3)])
    ress = (_values_around(ref._RESIDUAL_BARS[scene], 1.0)
            if scene in ref._RESIDUAL_BARS else [np.float32(0.02)])
    seen = set()
    for pen in pens:
        for res in ress:
            jstats = types.SimpleNamespace(
                pair_overflow=np.int32(overflow), max_penetration=pen,
                residual=res)
            zeros = SolverStats.zeros("cpu")
            stats = dataclasses.replace(
                zeros, pair_overflow=torch.tensor(overflow, dtype=torch.int32),
                max_penetration=torch.tensor(pen), residual=torch.tensor(res))
            want = ref.quality_verdict(scene,
                                       types.SimpleNamespace(stats=jstats))
            got = bench.quality_verdict(scene,
                                        types.SimpleNamespace(stats=stats))
            assert got == want
            assert [type(v) for v in got.values()] == \
                [type(v) for v in want.values()]
            seen.add(got["pass"])
    # the bar is crossed within the values tried unless overflow fails all
    assert seen == ({False} if overflow else {True, False})


# --- suggested window and window policy --------------------------------------

def _ref_window_policy():
    """bench.py's inline ``window_policy`` expression, compiled from its
    source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "window_policy":
                    return compile(ast.Expression(v), "bench.py", "eval")
    raise AssertionError("bench.py has no window_policy entry")


def _ref_literal_keys(marker: str) -> list:
    """The keys of the dict literal in bench.py that holds ``marker``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if marker in keys:
                return keys
    raise AssertionError(f"bench.py has no dict with {marker}")


@pytest.mark.parametrize("banded", [False, True])
def test_suggest_window_and_policy_match_bench(ref, banded):
    """One small settled state (a 60-box pile after 30 frames), and 64
    envs of 4 boxes on banded keys after 3: the suggestion read by both
    packages from the same state, and the policy's verdict at windows
    around it."""
    if banded:
        cfg, st = bench.build_envs(64, 4, "pallas", device="cpu")
        _, jlike = ref.build_envs(64, 4, "pallas")
        frames = 3
    else:
        cfg, st = bench.build("pile", 60, "xla", "sap_grid", 192,
                              device="cpu")
        _, jlike = ref.build("pile", 60, "xla", "sap_grid", 192)
        frames = 30
    st = rollout(st, cfg, frames)
    host = state_to_numpy(st)
    want = ref._suggest_window(host, cfg)
    got = bench._suggest_window(st, cfg)
    assert got == want and want > 0
    policy = _ref_window_policy()
    for window in (want // 2, want - 1, want, 2 * want, 2 * want + 1, 192):
        c = dataclasses.replace(cfg, sap_window=window)
        assert bench.window_policy(c.sap_window, got) == eval(
            policy, {"cfg": c, "suggested_window": want})


# --- the JSON line -----------------------------------------------------------

def key_tree(obj):
    """The line's keys and value types (a list by its items' trees)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [key_tree(v) for v in obj]
    return type(obj).__name__


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


TINY = ["--cpu", "--boxes", "8", "--steps", "1", "--settle", "0"]


def test_main_line_matches_bench(ref, monkeypatch, capsys):
    """bench.py's ``main`` and the port's on the same flags (the colored
    backend, so both run their plain paths): the same key tree and value
    types, the same metric and unit, the backend named."""
    argv = TINY + ["--backend", "xla"]
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    ref.main()
    want = last_json(capsys.readouterr().out)
    assert bench.main(argv) == 0
    got = last_json(capsys.readouterr().out)
    assert key_tree(got) == key_tree(want)
    for k in ("metric", "unit"):
        assert got[k] == want[k]
    assert got["extra"]["backend"] == "cpu"
    assert got["extra"]["solver_backend"] == want["extra"]["solver_backend"]
    assert got["extra"]["autotune"] is None


@pytest.mark.parametrize("row", [
    ["--scene", "chain", "--boxes", "12"],
    ["--scene", "net", "--boxes", "6", "--backend", "xla"],
    ["--scene", "envs", "--envs", "2", "--boxes", "4"],
    ["--scene", "avalanche", "--boxes", "12", "--autotune"],
])
def test_main_rows_keep_the_line(ref, capsys, row):
    """Other rows through the port's CLI on the CPU (the kernels' plain
    versions under ``"pallas"``): the line's keys as bench.py writes them,
    the quality verdict's keys as bench.py's ``quality_verdict`` gives
    them for the scene, the metric and unit of the row; under
    ``--autotune`` the keys of bench.py's autotune record."""
    args = ["--cpu", "--steps", "1", "--settle", "2", *row]
    assert bench.main(args) == 0
    line = last_json(capsys.readouterr().out)
    opts = bench.parser().parse_args(args)
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert list(line["extra"]) == _ref_literal_keys("window_policy")
    assert list(line["extra"]["ovf"]) == ["ovf_window", "ovf_slots",
                                          "ovf_drop", "ovf_band", "ovf_slab"]
    stats = types.SimpleNamespace(stats=types.SimpleNamespace(
        pair_overflow=0, max_penetration=0.0, residual=0.0))
    assert list(line["extra"]["quality"]) == list(
        ref.quality_verdict(opts.scene, stats))
    if opts.scene == "envs":
        assert line["metric"] == "env-steps/sec @ 2 envs x 4 boxes"
        assert line["unit"] == "env-steps/sec"
    else:
        assert line["metric"] == f"steps/sec @ {opts.boxes}-box {opts.scene}"
        assert line["unit"] == "steps/sec"
    tuned = line["extra"]["autotune"]
    if opts.autotune:
        assert list(tuned) == _ref_literal_keys("final_window")
        for rec in tuned["retunes"]:
            assert list(rec) == _ref_literal_keys("hits")
    else:
        assert tuned is None
    assert line["extra"]["pair_overflow"] == 0 and line["value"] > 0


def test_cli_without_cuda_exits_2():
    """No CUDA device and no ``--cpu``: bench.py's error line and exit
    code 2, nothing run on the CPU in its place."""
    assert not torch.cuda.is_available()
    run = subprocess.run(
        [sys.executable, "-m", "phyx_tpu_torch.bench", "--boxes", "20"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert run.returncode == 2
    line = last_json(run.stdout)
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["metric"] == "steps/sec @ 20-box pile"
    assert line["unit"] == "steps/sec"
    assert "CUDA" in line["error"]
    assert len(run.stdout.strip().splitlines()) == 1
