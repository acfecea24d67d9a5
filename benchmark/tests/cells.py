"""A copy of the benchmark in a temporary root, with tiny cells added by
new files and entries alone: a configuration file and a ``workloads``
entry each, and for one of them a scene kind of its own
(``benchmark/scenes/<kind>.py``).  ``tiny_envs`` is bench row E's
mega-scene in small: 64 envs of 5 boxes on 8 y-bands, the sweep banded,
the tiled tier in slabs of 128 bodies, so that slab boundaries cut
envs."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# tiny sizes of the two configurations, for the kernels' plain versions
TINY = {
    "tiny_pile": ("pile_10k", dict(
        boxes=40, max_bodies=64, max_pairs=1024, sap_window=32,
        settle={"frames": 20, "chunk": 10, "autotune": False})),
    "tiny_avalanche": ("avalanche_20k", dict(
        boxes=120, max_bodies=256, max_pairs=1024, sap_window=48,
        solver_backend="pallas_tiled", tile_stride=256, tile_halo=256,
        settle={"frames": 20, "chunk": 10, "autotune": True})),
}
# a scene kind that the benchmark does not have: a single column of boxes
COLUMN = '''
from benchmark.scenes import Rows


def make(boxes, seed, box_half=0.5):
    rows = Rows()
    rows.ground()
    for k in range(boxes):
        rows.box((0.01 * (seed % 7), box_half + 2.05 * box_half * k),
                 (box_half, box_half), friction=0.5)
    return rows.scene()
'''
TINY["tiny_column"] = ("pile_10k", dict(
    TINY["tiny_pile"][1], scene={"kind": "column", "box_half": 0.5},
    boxes=12))
TINY["tiny_envs"] = ("pile_10k", dict(
    scene={"kind": "envs", "envs": 64}, boxes=5,
    max_bodies=512, max_pairs=1024, broadphase="sap", sap_window=96,
    solver_backend="pallas_tiled", tile_stride=256, tile_halo=256,
    sweep_band_h=400.0, sweep_band_y0=-200.0, sweep_band_span=1024.0,
    settle={"frames": 10, "chunk": 10, "autotune": False}))
CELLS = {"tiny-realtime": ("tiny_pile", "realtime"),
         "tiny-batch": ("tiny_avalanche", "batch"),
         "tiny-column": ("tiny_column", "realtime"),
         "tiny-envs": ("tiny_envs", "realtime")}
# the cell whose metrics each tiny cell reports too
LIKE = {"tiny-realtime": "pile10k-realtime",
        "tiny-batch": "avalanche20k-batch",
        "tiny-column": "pile10k-realtime",
        "tiny-envs": "pile10k-realtime"}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and benchmark/ with the tiny
    configurations and cells added: new files, and new entries in the
    manifest's lists (each tiny cell in the metric lists of the cell it
    stands for); no other file changed."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "benchmark/scenes/column.py").write_text(COLUMN)
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, (base, changes) in TINY.items():
        cfg = json.loads((REPO / f"benchmark/configs/{base}.json")
                         .read_text())
        cfg.update(changes, name=name)
        path = f"benchmark/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        manifest["configs"].append(dict(name=name, source="test", file=path,
                                        reduced=[], why="test"))
    for cell, (config, mix) in CELLS.items():
        manifest["workloads"].append(dict(name=cell, config=config,
                                          traffic=mix, chips=1, why="test"))
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if LIKE[cell] in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp
