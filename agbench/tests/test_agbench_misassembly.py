"""The misassembly removal cell, athaliana_chr1.misassembly: found by name
(cell file, driver, reference, readers), its driver's spans name
functions of the program, its readers give nothing on a run without the
root span `misassembly`, and on the CPU at a tiny size its run is
correct and reads the span metrics, the control fails it, and a fault in
stage (5) makes it not correct."""

import time

import numpy as np
import pytest

from agbench import control, harness

CELL = "athaliana_chr1.misassembly"
READERS = ("masb_reads_s.misassembly", "masb_coverage_s.misassembly",
           "masb_host_s.misassembly", "device_idle.misassembly")
SPAN_READERS = READERS[:3]
LAYERS = ("misassembly, read align", "misassembly, coverage",
          "misassembly, host loops and files", "device")
CONFIG = "athaliana_chr1_masb"


def run_cell(tiny, tracing=False, seed=2147483907):
    return harness.execute(CELL, seed, 0.0, tracing, time.perf_counter(),
                           config=tiny(CONFIG), device="cpu")[0]


def test_listed_in_the_benchmark():
    bench = harness.benchmark()
    conf = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert conf["file"] == f"agbench/configs/{CONFIG}.json"
    assert conf["reduced"] == []
    deployment = harness.load_json("configs", CONFIG)
    assert deployment["name"] == CONFIG
    assert deployment["pipeline"]["misassembly_removal"] is True
    # the drafts, reads and genome of config 3's sample, nothing cut
    assert deployment["sample"] == harness.load_json(
        "configs", "athaliana_chr1")["sample"]
    layers = {m["name"]: m for m in bench["per_layer"]}
    for name, layer in zip(READERS, LAYERS):
        assert layers[name]["layer"] == layer
        assert layers[name]["moves"] == "reassembly_s"
        assert layers[name]["workloads"] == [CELL]


def test_found_by_name():
    bench = harness.benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert wl["chips"] == 1 and wl["config"] == CONFIG
    cell = harness.load_json("cells", CELL)
    assert cell["traffic"] == wl["traffic"] == "misassembly"
    driver = harness.load_module("drivers", cell["driver"])
    for fn in ("setup", "step", "finish", "check"):
        assert callable(getattr(driver, fn))
    assert {m["name"] for m in harness.metrics_for(bench["per_layer"],
                                                   CELL)} == set(READERS)
    assert {m["name"] for m in harness.metrics_for(bench["end_to_end"],
                                                   CELL)} == {
        "reassembly_s", "peak_device_gib", "setup_s"}
    for name in READERS:
        assert callable(harness.load_module("metrics", name).read)
    from agbench.reference import misassembly
    assert callable(misassembly.remove_misassembly)


def test_driver_spans_name_functions_of_the_program():
    driver = harness.load_module("drivers", "misassembly")
    for mod, attr in driver.SPANS:
        assert callable(harness.resolve(mod, attr)[2]), (mod, attr)


def test_readers_give_none_without_the_root_span():
    from aligngraph_tpu_torch.utils import spans

    spans.records(clear=True)
    # the parent's stage (5): its steps are roots of their own
    with spans.recording():
        for step in ("reads", "coverage", "placement_loops"):
            with spans.span(f"misassembly.{step}"):
                pass
    run = harness.Run(CELL, {}, {}, 0, 0.0, True, None)
    run.steps = [dict(seconds=1.0, units={}, stats={}, traced=True)]
    for name in READERS:
        assert harness.load_module("metrics", name).read(run) is None, name
    spans.records(clear=True)


def test_traced_run_is_correct_and_reads_the_spans(tiny):
    from aligngraph_tpu_torch.utils import spans

    spans.records(clear=True)
    res = run_cell(tiny, tracing=True)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"masb_pieces_diff", "coverage_diff",
                                  "placements_diff", "read_records_diff"}
    # the device's idle share needs the card
    assert set(res["metrics"]) == set(SPAN_READERS)
    assert all(res["metrics"][m]["value"] > 0 for m in SPAN_READERS)
    root = [r for r in spans.records() if r["name"] == "misassembly"]
    assert root and root[-1]["counts"]["which"] == 0


def test_control_fails(tiny):
    got = control.readings(CELL, 4242, config=tiny(CONFIG), device="cpu")
    assert any(v > lim for v, lim in got.values()), got


# --- faults planted in stage (5) ---------------------------------------

def _coverage_fault(monkeypatch):
    from aligngraph_tpu_torch.pipeline import misassembly

    cover = misassembly._coverage_from_reads

    def broken(*args, **kwargs):
        cov = cover(*args, **kwargs)
        cov[len(cov) // 2][10] += 1
        return cov
    monkeypatch.setattr(misassembly, "_coverage_from_reads", broken)


def _placement_fault(monkeypatch):
    from aligngraph_tpu_torch.pipeline import misassembly

    place = misassembly._placements

    def broken(*args, **kwargs):
        pos = place(*args, **kwargs)
        live = [p for plist in pos for p in plist if p.target_id == 0]
        live[len(live) // 2].source_end -= 1
        return pos
    monkeypatch.setattr(misassembly, "_placements", broken)


def _sweep_fault(monkeypatch):
    from aligngraph_tpu_torch.pipeline import misassembly

    # every unplaced run kept, whatever its coverage
    monkeypatch.setattr(misassembly, "_sweep",
                        lambda state, coverage: np.ones(len(state), bool))


def _records_fault(monkeypatch):
    import dataclasses

    from aligngraph_tpu_torch.align.read_aligner import ReadAligner

    align = ReadAligner.align

    def broken(self, reads):
        out = align(self, reads)
        pm = np.array(out.pos_map)
        pm[len(pm) // 2, 0, 10] += 1
        return dataclasses.replace(out, pos_map=pm)
    monkeypatch.setattr(ReadAligner, "align", broken)


@pytest.mark.parametrize("fault", [_coverage_fault, _placement_fault,
                                   _sweep_fault, _records_fault],
                         ids=lambda f: f.__name__[1:])
def test_fault_in_stage_five_is_not_correct(fault, tiny, monkeypatch):
    fault(monkeypatch)
    res = run_cell(tiny)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]


@pytest.mark.card
def test_short_run_is_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark runs on the card)")
    res, _ = harness.execute(CELL, 8080, 1.0, False, time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
