"""A configuration, a cell and a per-layer metric are found by name: a
later change adds files and entries and edits no file of the harness."""

import json
import shutil
import time

from agbench import harness
from conftest import bench_with_read_cell


def test_new_config_cell_and_metric_need_only_new_files(tmp_path, tiny,
                                                        monkeypatch):
    for kind in ("cells", "configs", "drivers", "metrics"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    cfg = tiny("athaliana_chr1")
    cfg["name"] = "tiny_genome"
    (tmp_path / "configs" / "tiny_genome.json").write_text(json.dumps(cfg))
    cell = dict(harness.load_json("cells", "athaliana_chr1.align_reads"),
                config="tiny_genome")
    (tmp_path / "cells" / "tiny_genome.align_reads.json").write_text(
        json.dumps(cell))
    (tmp_path / "metrics" / "records_per_pair.align_reads.py").write_text(
        "from agbench import readers\n\n\ndef read(run):\n"
        "    return readers.stat_mean(run, 'records') / "
        "readers.stat_mean(run, 'pairs')\n")
    bench = harness.benchmark()
    bench["configs"].append({"name": "tiny_genome", "source": "a test",
                             "file": "agbench/configs/tiny_genome.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_genome.align_reads",
                               "config": "tiny_genome",
                               "traffic": "align_reads", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "records_per_pair.align_reads", "unit": "records",
        "better": "higher", "source": "program_counter",
        "layer": "read aligner, host side", "moves": "read_pairs_per_s",
        "workloads": ["tiny_genome.align_reads"]})
    monkeypatch.setattr(harness, "HERE", tmp_path)
    res, _ = harness.execute("tiny_genome.align_reads", 5, 0.0, True,
                             time.perf_counter(), bench=bench, device="cpu")
    assert res["correct"] is True
    assert 0.5 < res["metrics"]["records_per_pair.align_reads"]["value"] < 5


def test_metric_reader_that_finds_nothing_is_left_out():
    run = harness.Run("c", {}, {}, 0, 0.0, True, None)
    run.steps = [dict(seconds=1.0, units={}, stats={}, traced=False)]
    entries = [m for m in bench_with_read_cell()["per_layer"]
               if m["name"] == "sw_roofline.align_reads"]
    assert harness.read_metrics(entries, run) == {}
