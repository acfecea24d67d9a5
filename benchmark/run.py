"""One run of one cell of the benchmark of ``phyx_tpu_torch``.

    python3 benchmark/run.py --workload pile10k-realtime --seed 7 \
        --seconds 20 --trace 0

Reads ``BENCHMARK.json`` at the root of the checkout, the cell's
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<mix>.json``); builds the configuration's scene from
the seed (``benchmark/scenes/<kind>.py``) through the program's
``SceneBuilder``,
settles it, warms the mix up, and runs the mix for ``--seconds``
(``benchmark/traffic.py``).  Each metric is read by its own reader,
``benchmark/metrics/<metric>.py``: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, over a profiled
last stretch of the same window and the stage times of frames run after
it.  Then the kept calls are compared with the reference
(``benchmark/check.py``).  The last line of standard output is the result,
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.  Without a CUDA device, or with fewer than the
cell's chips, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import check, scenes, traffic  # noqa: E402
from benchmark.reference import engine  # noqa: E402

# top-level modules the run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "phyx_tpu")


def note(text: str) -> None:
    print(f"# {text}", file=sys.stderr, flush=True)


def load_cell(root: Path, workload: str):
    """(manifest, cell entry, configuration, traffic mix) by name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, traffic.validate(mix)


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports in this kind of run."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# --- the program's side -----------------------------------------------------

def sim_config(config: dict):
    """The program's SimConfig from the configuration file's keys that
    name its fields; the others keep the program's defaults."""
    from phyx_tpu_torch import SimConfig
    kw = {f.name: config[f.name] for f in dataclasses.fields(SimConfig)
          if f.name in config}
    if "gravity" in kw:
        kw["gravity"] = tuple(kw["gravity"])
    return SimConfig(**kw)


def build(config: dict, scene, device):
    """The program's state of ``scene``, each box handed to its
    ``SceneBuilder``."""
    from phyx_tpu_torch import SceneBuilder
    cfg = sim_config(config)
    sb = SceneBuilder(cfg)
    for k in range(len(scene)):
        sb.add_box(tuple(scene.pos[k]), tuple(scene.half[k]),
                   angle=float(scene.angle[k]),
                   density=float(scene.density[k]),
                   friction=float(scene.friction[k]),
                   restitution=float(scene.restitution[k]),
                   static=bool(scene.static[k]))
    return cfg, sb.build(device)


def settle(st, cfg, spec: dict):
    """The configuration's settle: ``frames`` frames in calls of
    ``chunk`` through ``rollout``, or through the autotuner
    (``tune.rollout_autotuned``, chunks of ``chunk``) where ``autotune``
    is set.  Returns (state, configuration)."""
    from phyx_tpu_torch.step import rollout
    if spec["autotune"]:
        from phyx_tpu_torch.tune import rollout_autotuned
        return rollout_autotuned(st, cfg, spec["frames"], chunk=spec["chunk"])
    done = 0
    while done < spec["frames"]:
        n = min(spec["chunk"], spec["frames"] - done)
        st = rollout(st, cfg, n)
        done += n
    return st, cfg


def guard(st):
    """A device flag of the guarantees a returned state breaks: an
    overflow counter above 0, or a state that is not finite."""
    import torch
    s = st.stats
    counters = torch.stack([getattr(s, k) for k in check.OVERFLOW_KEYS])
    b = st.bodies
    finite = torch.isfinite(torch.cat([
        b.pos.reshape(-1), b.rot.reshape(-1), b.vel.reshape(-1),
        b.angvel])).all()
    return (counters != 0).any() | ~finite


def too_deep(st, guarantees: dict) -> bool:
    """Whether the deepest penetration of ``st`` passes the
    configuration's bar (a share of the box half), read as the bench
    row's verdict reads it: once, at the run's last frame."""
    bar = guarantees["penetration_bar"] * guarantees["box_half"]
    return not float(st.stats.max_penetration) <= bar


def host_state(st) -> dict:
    """The fields the comparison reads, as NumPy arrays."""
    b, c = st.bodies, st.cache
    out = {k: getattr(b, k).cpu().numpy() for k in
           ("pos", "rot", "vel", "angvel")}
    out.update(pi=c.pi.cpu().numpy(), pj=c.pj.cpu().numpy(),
               fid=c.fid.cpu().numpy(),
               normal_impulse=c.normal_impulse.cpu().numpy(),
               friction_impulse=c.friction_impulse.cpu().numpy())
    out["stats"] = {f.name: getattr(st.stats, f.name).item()
                    for f in dataclasses.fields(st.stats)}
    return out


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


# --- one run ----------------------------------------------------------------

def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", wrap=None,
             control: bool = False) -> tuple:
    """(the result line's object, the compared numbers' lines) of one run
    of ``workload``.  ``device`` "cpu" and ``wrap`` (which takes the
    program's call ``(state, frames) -> state`` and returns the one the
    window makes) serve the tests; ``control`` adds the numbers of the
    reference computed in bfloat16 in the program's place (``control`` in
    the result, with every number of the program's as ``numbers``, for
    ``benchmark/control.py``)."""
    import torch
    from phyx_tpu_torch.step import release_graphs
    from phyx_tpu_torch.step import rollout as program_rollout

    manifest, cell, config, mix = load_cell(root, workload)
    cuda = device == "cuda"
    scene = scenes.make(config, seed, root)
    cfg, st = build(config, scene, device)
    expected = check.bodies_of(scene, cfg.max_bodies)
    b = st.bodies
    built = {k: getattr(b, k).cpu().numpy() for k in
             ("pos", "rot", "inv_mass", "inv_inertia", "friction",
              "restitution", "active")}
    built["half"] = b.half_extent.cpu().numpy()
    numbers = {"build_gap": check.build_gap(built, expected)}

    st, cfg = settle(st, cfg, config["settle"])
    note(f"settled: sap_window {cfg.sap_window}, sap_hits {cfg.sap_hits}, "
         f"max_pairs {cfg.max_pairs}, tile_halo {cfg.tile_halo}")
    call = lambda s, n: program_rollout(s, cfg, n)  # noqa: E731
    if wrap is not None:
        call = wrap(call)
    rng = np.random.default_rng([seed, 1])
    window = traffic.drive(call, guard, st, mix, seconds, rng, len(scene),
                           trace=trace)
    setup_s = window.t_start - T_START
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    flags = torch.stack(window.flags).cpu().numpy() if window.flags else []
    failed = int(sum(c.frames for c, f in zip(window.calls, flags) if f))
    if window.calls and not flags[-1] and too_deep(window.last,
                                                   config["guarantees"]):
        failed += window.calls[-1].frames
    attempted = window.frames

    run = SimpleNamespace(
        window=window, setup_s=setup_s, mix=mix, config=config,
        live_bodies=len(scene), trace=None, stages=None,
        traced_points=[int(x) for x in torch.stack(
            window.traced_outputs).cpu().tolist()]
        if window.traced_outputs else [])
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=int(cell["chips"]) if cuda else 1, memory_peak_bytes=int(peak))
    if trace:
        from benchmark import trace as trace_mod
        from phyx_tpu_torch.profiling import stage_times
        if window.profiler is not None:
            run.trace = trace_mod.reduce_events(window.profiler.events())
            run.trace["window_s"] = window.t_end - window.t_trace
            device_info.update(busy_s=run.trace["busy_us"] / 1e6,
                               window_s=run.trace["window_s"])
        _, run.stages = stage_times(st, cfg, mix["stage_frames"])
        note(f"card and power limit: {power_line() if cuda else 'cpu'}; "
             "peaks of the rooflines: the H100 SXM data sheet's")

    breakdown = None
    if run.trace:
        breakdown = {k: run.trace[k] for k in ("device_ops", "idle_gaps")}
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    kept = [(host_state(k.state_in), host_state(k.state_out),
             None if k.host is None else k.host.numpy())
            for k in window.kept]
    last_stats = kept[-1][1]["stats"] if kept else {}
    del window, st, run
    if cuda:
        release_graphs()
        gc.collect()
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run holds modules it must not: {bad}")
    t0 = time.perf_counter()
    world = engine.world_from(expected, dict(config, max_bodies=cfg.max_bodies,
                                             max_pairs=cfg.max_pairs,
                                             tile_stride=cfg.tile_stride))
    numbers.update(check.judge(world, expected, kept,
                               mix["frames_per_call"]))
    correct, lines = check.verdict(numbers, config["limits"])
    control_numbers = (check.judge(world, expected, kept,
                                   mix["frames_per_call"], control=True)
                       if control else None)
    note(f"reference: {len(kept)} calls of {mix['frames_per_call']} frames "
         f"in {time.perf_counter() - t0:.1f} s; last kept call's counters "
         f"{last_stats}")
    limits = config["limits"]
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=device_info)
    if breakdown:
        result["breakdown"] = breakdown
    if control_numbers is not None:
        result["control"] = control_numbers
        result["numbers"] = numbers
    # the numbers compared, each beside its limit, come last
    result["check"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in limits.items()}
    return result, lines


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(root, args.workload)

    import torch
    if not torch.cuda.is_available():
        note("no CUDA device: torch.cuda.is_available() is false; no "
             "result")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        note(f"the cell asks for {cell['chips']} cards; "
             f"{torch.cuda.device_count()} found; no result")
        return 2
    result, lines = run_cell(root, args.workload, args.seed,
                                      args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        note(f"the run holds modules it must not: {bad}; no result")
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
