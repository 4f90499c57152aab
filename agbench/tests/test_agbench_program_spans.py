"""The metrics that read the program's own spans, on the CPU: a traced
run of each tiny cell reads every one of them, and a run that is not
traced, or a program without the recorder, reads none.  The reassembly's
k-mer layer is built as on the card (graph_build_for answers "device"),
so its state's trip up and back has spans to read."""

import sys
import time

import pytest

from agbench import harness, program_spans

NEW = {"ecoli_k12.reassemble": ("kmer_state_copy_s.reassemble",
                                "graph_create_s.reassemble",
                                "read_wait_s.reassemble"),
       "athaliana_chr1.align_contigs": ("contig_segments_s.align_contigs",)}


def run_cell(name, tiny, tracing):
    bench = harness.benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    return harness.execute(name, 2147483801, 0.0, tracing,
                           time.perf_counter(), bench=bench,
                           config=tiny(wl["config"]), device="cpu")[0]


@pytest.fixture
def device_build(monkeypatch):
    from aligngraph_tpu_torch.pipeline import driver

    monkeypatch.setattr(driver, "graph_build_for", lambda device, k: "device")


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_run_reads_each_span_metric(name, tiny, device_build):
    from aligngraph_tpu_torch.utils import spans

    spans.records(clear=True)
    res = run_cell(name, tiny, tracing=True)
    assert res["correct"] is True
    for metric in NEW[name]:
        got = res["metrics"][metric]
        assert got["unit"] == "s" and got["value"] >= 0, metric
    if name == "ecoli_k12.reassemble":
        assert all(res["metrics"][m]["value"] > 0 for m in NEW[name])
    # those per-layer metrics that need the card are left out
    assert not {m["name"] for m in harness.metrics_for(
        harness.benchmark()["per_layer"], name)
        if m["source"] == "program_span"} - set(res["metrics"])


def test_untraced_steps_leave_nothing_to_read(tiny):
    from aligngraph_tpu_torch.utils import spans

    spans.records(clear=True)
    run = harness.Run("athaliana_chr1.align_contigs", {}, {}, 0, 0.0, True,
                      None)
    run.steps = [dict(seconds=1.0, units={}, stats={}, traced=False)]
    assert program_spans.mean_per_root(
        run, "align.contigs", ("align.contigs.segments",)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import aligngraph_tpu_torch.utils as utils
    from aligngraph_tpu_torch.utils import spans

    spans.records(clear=True)
    with spans.recording():
        with spans.span("pipeline"):
            with spans.span("x") as x:
                pass
    run = harness.Run("c", {}, {}, 0, 0.0, True, None)
    run.steps = [dict(seconds=1.0, units={}, stats={}, traced=True)]
    assert program_spans.mean_per_root(run, "pipeline", ("x",)) == \
        x.seconds
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "aligngraph_tpu_torch.utils.spans",
                        None)
    assert program_spans.mean_per_root(run, "pipeline", ("x",)) is None
