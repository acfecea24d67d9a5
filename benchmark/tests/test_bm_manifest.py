"""BENCHMARK.json against the benchmark's contract: names and units in the
allowed characters, the keys each entry may have, every metric's reader,
configuration and traffic file present, and each per-layer metric moving
an end-to-end metric that each of its cells reports."""

import json
import re

import pytest

from benchmark import traffic
from benchmark.tests.cells import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(one_line(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert MANIFEST["command"][1].startswith(MANIFEST["paths"][0] + "/")
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert one_line(w["why"])
    for c in MANIFEST["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_files_by_name():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in configs.values():
        path = REPO / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
        assert set(cfg["limits"]) >= {"pos_gap", "overflow", "build_gap"}
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        traffic.validate(json.loads(
            (REPO / f"benchmark/traffic/{w['traffic']}.json").read_text()))
    assert len({(w["config"], w["traffic"])
                for w in MANIFEST["workloads"]}) == len(CELLS)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (REPO / f"benchmark/metrics/{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(m, cell) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_moves_an_end_to_end_metric_of_each_cell(metric):
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    target = next(x for x in MANIFEST["end_to_end"] if x["name"] == m["moves"])
    assert m.get("workloads"), "each per-layer metric lists its cells"
    for cell in m["workloads"]:
        assert cell in CELLS
        assert reported(target, cell), (metric, cell)


def test_kernel_shares_are_rooflines():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
