"""The 10k pile under the ``batch`` mix (``pile10k-batch``), on the CPU with
the kernels' plain versions.

``cells.tiny_root`` holds the benchmark with its tiny cells; this file adds
one more by new entries alone: ``tiny-pile-batch``, the ``pile_10k_batch``
configuration (its limits and guarantees) at the tiny pile's size, under
the ``batch`` mix, in the metric lists of ``pile10k-batch``.  Checked: the
configuration is ``pile_10k``'s scene and engine settings; the cell runs
and is correct; the broken timed paths of ``test_bm_cells`` are refused
under its limits, set for the ties of 10-frame calls; ``pile10k-batch``'s
entry loads, and each metric it lists reads a value on the CPU where it
comes from the host clock, and nothing where it comes from the device
trace."""

import json

import pytest
import torch

from benchmark import run
from benchmark.tests.cells import REPO, TINY, tiny_root
from benchmark.tests.test_bm_cells import altered, half_left_out, unchanged

SEED = 3_000_000_007
CELL, TINY_CELL, LIKE = "pile10k-batch", "tiny-pile-batch", "tiny_pile_batch"
# the keys in which the two configurations of the pile may differ
OWN = ("name", "source", "deployment", "limits")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tiny_root(tmp_path_factory.mktemp("bench"))
    cfg = json.loads((REPO / "benchmark/configs/pile_10k_batch.json")
                     .read_text())
    cfg.update(TINY["tiny_pile"][1], name=LIKE)
    path = f"benchmark/configs/{LIKE}.json"
    (tmp / path).write_text(json.dumps(cfg))
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(name=LIKE, source="test", file=path,
                                    reduced=[], why="test"))
    manifest["workloads"].append(dict(name=TINY_CELL, config=LIKE,
                                      traffic="batch", chips=1, why="test"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


def test_the_batch_pile_is_the_piles_deployment():
    pile, batch = (json.loads((REPO / f"benchmark/configs/{n}.json")
                              .read_text())
                   for n in ("pile_10k", "pile_10k_batch"))
    assert set(pile) == set(batch)
    assert {k: v for k, v in pile.items() if k not in OWN} == {
        k: v for k, v in batch.items() if k not in OWN}


def test_batch_pile_cell_runs_and_is_correct(root):
    result, lines = run.run_cell(root, TINY_CELL, SEED, 1.0, False,
                                 device="cpu")
    assert result["correct"], lines
    assert result["attempted"] >= 10 and result["failed"] == 0
    assert result["attempted"] % 10 == 0
    assert set(result["metrics"]) == {"steps_per_s.realtime", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_timed_path_is_not_correct(root, fault):
    result, lines = run.run_cell(root, TINY_CELL, SEED, 1.0, False,
                                 device="cpu", wrap=fault)
    assert not result["correct"], lines


def test_the_cell_loads_and_its_metrics_read_by_kind(root):
    """``pile10k-batch``'s entry loads from the manifest with its
    configuration and mix; run at its tiny stand-in on the CPU, untraced
    and traced, every metric it lists reads a value where its source is
    the host clock and none where it is the device trace (no device here);
    the program's spans may read either."""
    manifest, entry, config, mix = run.load_cell(REPO, CELL)
    assert entry["chips"] == 1 and config["name"] == entry["config"]
    assert mix["frames_per_call"] == 10 and mix["readback"] == "none"
    tiny = json.loads((root / "BENCHMARK.json").read_text())
    for trace in (False, True):
        metrics = run.metrics_for(manifest, CELL, trace)
        assert metrics
        assert ({m["name"] for m in metrics}
                == {m["name"] for m in run.metrics_for(tiny, TINY_CELL,
                                                       trace)})
        result, lines = run.run_cell(root, TINY_CELL, SEED, 1.0, trace,
                                     device="cpu")
        assert result["correct"], lines
        for m in metrics:
            got = result["metrics"].get(m["name"])
            if m["source"] == "host_clock":
                assert got is not None and got["value"] > 0, m["name"]
            elif m["source"] == "device_trace":
                assert got is None, m["name"]
