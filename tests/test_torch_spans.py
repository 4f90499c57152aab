"""The port's span recorder (aligngraph_tpu_torch/utils/spans.py) on the
CPU: a recorded run_pipeline is one sample under one root, its two
alignment threads' spans hang under the alignment stage, every timer
dict the program keeps is the sum of its spans, a span that is off makes
no CUDA event, no profiler range and no record, and a torch.profiler
profile sees the program's spans, nested as recorded, while it runs and
only then."""

import collections
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu_torch.align import contig_aligner as cal
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.fasta import decode, read_fasta, write_fasta
from aligngraph_tpu_torch.io.formalize import (formalize_contigs,
                                               formalize_reads)
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.utils import spans
from tests.simdata import make_simdata


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim_dir(tmp_path_factory):
    """A 20 kb sim (one chromosome, 800 pairs, 6 drafts) as FASTA."""
    d = tmp_path_factory.mktemp("sim")
    sim = make_simdata(seed=7, genome_len=20_000, n_pairs=800,
                       read_len=100, insert=500, n_contigs=6,
                       snp_rate=0.01, err_rate=0.003)
    write_fasta(d / "genome.fa", ["chr"], [decode(sim.reference)])
    write_fasta(d / "contigs.fa", [f"c{i}" for i in range(6)],
                [decode(c) for c in sim.contigs])
    for mate, reads in (("r1", sim.reads1), ("r2", sim.reads2)):
        write_fasta(d / f"{mate}.fa", [f"p{i}" for i in range(800)],
                    [decode(r) for r in reads])
    return d, sim


def sim_cfg(d: Path, out: Path) -> Config:
    return Config(read1=str(d / "r1.fa"), read2=str(d / "r2.fa"),
                  contig=str(d / "contigs.fa"), genome=str(d / "genome.fa"),
                  distance_low=300, distance_high=700, graph_build="device",
                  extended_contig=str(out / "extended.fa"),
                  remaining_contig=str(out / "remaining.fa"),
                  work_dir=str(out / "tmp"))


@pytest.fixture(scope="module")
def traced_sample(sim_dir, tmp_path_factory):
    """One run_pipeline under a CPU profile: (its result, the recorder's
    records, the profiler's events)."""
    out = tmp_path_factory.mktemp("out")
    spans.records(clear=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        res = run_pipeline(sim_cfg(sim_dir[0], out), device="cpu")
    recs = spans.records(clear=True)
    return res, recs, prof.events()


def by_id(recs):
    return {r["id"]: r for r in recs}


def ancestors(rec, ids):
    out = []
    while rec["parent"] is not None:
        rec = ids[rec["parent"]]
        out.append(rec)
    return out


def total(recs, name, under=None):
    """Host seconds of the spans `name`, those under a span named
    `under` when given, summed in record order."""
    ids = by_id(recs)
    s = 0.0
    for r in recs:
        if r["name"] == name and (under is None or any(
                a["name"] == under for a in ancestors(r, ids))):
            s += r["host_s"]
    return s


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)


def test_one_root_per_sample_and_nesting(traced_sample):
    _, recs, _ = traced_sample
    ids = by_id(recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["pipeline"]
    root = roots[0]
    assert all(r["sample"] == root["id"] for r in recs)
    for r in recs:
        if r["parent"] is None:
            continue
        p = ids[r["parent"]]
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
            p["end_ns"], (r["name"], p["name"])
    names = collections.Counter(r["name"] for r in recs)
    for stage in ("pipeline.formalize", "formalize.reads",
                  "formalize.contigs", "formalize.genome",
                  "pipeline.alignment", "pipeline.alignment.index",
                  "pipeline.trim", "pipeline.graph", "pipeline.graph.create",
                  "pipeline.graph.contig_layer",
                  "pipeline.graph.kmer_build", "pipeline.graph.traverse",
                  "pipeline.graph.stage_files", "pipeline.refinement",
                  "pipeline.write", "graph.kmer.h2d", "graph.kmer.d2h",
                  "align.contigs.segments", "align.reads.wait"):
        assert names[stage] >= 1, stage
    # the two alignment threads: their spans hang under the stage's span
    align = next(r for r in recs if r["name"] == "pipeline.alignment")
    threads = {r["name"]: r for r in recs
               if r["name"] in ("pipeline.alignment.reads",
                                "pipeline.alignment.contigs")}
    assert set(threads) == {"pipeline.alignment.reads",
                            "pipeline.alignment.contigs"}
    assert {r["parent"] for r in threads.values()} == {align["id"]}
    assert len({r["thread"] for r in threads.values()}) == 2
    assert align["thread"] not in {r["thread"] for r in threads.values()}
    for r in recs:
        if r["thread"] != align["thread"]:
            assert align in ancestors(r, ids), r["name"]
    for name, thread in (("align.reads.wait", "pipeline.alignment.reads"),
                         ("align.contigs.segments",
                          "pipeline.alignment.contigs")):
        first = next(r for r in recs if r["name"] == name)
        assert threads[thread] in ancestors(first, ids)
        assert first["thread"] == threads[thread]["thread"]
    # a CPU device's device seconds are its host seconds
    kb = next(r for r in recs if r["name"] == "graph.kmer.h2d")
    assert kb["device_s"] == kb["host_s"]


def test_stats_are_views_of_spans(traced_sample):
    res, recs, _ = traced_sample
    st = res.stats
    stage = st["stage_seconds"]
    for key, name in (("contig_layer", "pipeline.graph.contig_layer"),
                      ("kmer_build", "pipeline.graph.kmer_build"),
                      ("traverse", "pipeline.graph.traverse"),
                      ("refinement", "pipeline.refinement"),
                      ("alignment", "pipeline.alignment")):
        assert close(stage[key], total(recs, name)), key
    assert close(st["formalize_seconds"], total(recs, "pipeline.formalize"))
    assert close(st["heap_trim_seconds"], total(recs, "pipeline.trim"))
    threads = st["alignment_threads"]
    for key, name in (("index", "pipeline.alignment.index"),
                      ("reads", "pipeline.alignment.reads"),
                      ("contigs", "pipeline.alignment.contigs")):
        assert close(threads[key], total(recs, name)), key
    for key in ("wait", "copy_out", "concat"):
        assert close(threads[f"reads_{key}_s"],
                     total(recs, f"align.reads.{key}",
                           under="pipeline.alignment")), key
    layers = st["contig_align_layers"]
    assert set(layers) == set(cal.LAYERS)
    for layer in cal.LAYERS:
        assert close(layers[layer],
                     total(recs, f"align.contigs.{layer}",
                           under="pipeline.alignment")), layer
    root = next(r for r in recs if r["parent"] is None)
    assert 0 < res.wall_seconds <= root["host_s"]


def test_contig_aligner_views(sim_dir, tmp_path):
    d, sim = sim_dir
    contigs = formalize_contigs(str(d / "contigs.fa"))
    ca = ContigAligner(np.asarray(sim.reference, np.int8), Config(),
                       device="cpu")
    spans.records(clear=True)
    with spans.recording():
        out = ca.align(contigs)
    recs = spans.records(clear=True)
    ids = by_id(recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["align.contigs"]
    assert roots[0]["counts"] == dict(chunks=contigs.n_chunks,
                                      placements=out.n)
    for layer in cal.LAYERS:
        assert close(ca.layer_s[layer], total(recs, f"align.contigs.{layer}"))
    assert close(ca.finalize_s, total(recs, "align.contigs.finalize"))
    assert set(ca.finalize_split) == set(cal.FINALIZE_STEPS)
    for step in cal.FINALIZE_STEPS:
        assert close(ca.finalize_split[step],
                     total(recs, f"align.contigs.finalize.{step}")), step
    fin = next(r for r in recs if r["name"] == "align.contigs.finalize")
    assert fin["counts"] == ca.finalize_counts
    seed = next(r for r in recs if r["name"] == "align.contigs.seed")
    assert seed["counts"] == ca.seeding
    seg = next(r for r in recs if r["name"] == "align.contigs.segments")
    assert ids[seg["parent"]] is seed
    assert seg["counts"]["segments"] == 2 * contigs.n_chunks
    assert seg["counts"]["bases"] == 2 * int(np.sum(contigs.chunk_len))


def test_read_aligner_views(sim_dir):
    d, sim = sim_dir
    reads = formalize_reads(str(d / "r1.fa"), str(d / "r2.fa"))
    ra = ReadAligner.build(np.asarray(sim.reference, np.int8),
                           Config(distance_low=300, distance_high=700),
                           batch_pairs=256, device="cpu")
    spans.records(clear=True)
    with spans.recording():
        recs_out = ra.align(reads)
    recs = spans.records(clear=True)
    assert [r["name"] for r in recs if r["parent"] is None] == \
        ["align.reads"]
    batches = -(-reads.n_pairs // 256)
    names = collections.Counter(r["name"] for r in recs)
    assert names["align.reads.enqueue"] == batches
    assert names["align.reads.copy_out"] == batches
    assert names["align.reads.wait"] >= batches
    for key in ("wait", "copy_out", "concat"):
        assert close(ra.split[f"{key}_s"], total(recs, f"align.reads.{key}"))
    summed = collections.Counter()
    for r in recs:
        if r["name"] == "align.reads.copy_out":
            summed.update(r["counts"])
    assert summed.pop("records") == recs_out.n
    assert dict(summed) == {k: v for k, v in ra.transfer.items() if v}
    assert sum(r["counts"]["pairs"] for r in recs
               if r["name"] == "align.reads.enqueue") == reads.n_pairs


class CountingEvent:
    """torch.cuda.Event's stand-in: counts the events made, and reads 5
    ms between any two."""
    made = 0

    def __init__(self, enable_timing=False):
        CountingEvent.made += 1

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 5.0


@pytest.fixture
def counting(monkeypatch):
    """torch.cuda.Event and torch.profiler.record_function counted."""
    made = {"rf": 0}
    real_rf = torch.profiler.record_function

    def rf(name, *args):
        made["rf"] += 1
        return real_rf(name, *args)
    CountingEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    spans.records(clear=True)
    return made


def test_off_makes_no_event_range_or_record(sim_dir, tmp_path, counting):
    assert not spans.on()
    res = run_pipeline(sim_cfg(sim_dir[0], tmp_path), device="cpu")
    assert res.stats["stage_seconds"]["kmer_build"] > 0
    # spans given a CUDA device, off: a clock read at most
    cuda = torch.device("cuda")
    with spans.span("x", device=cuda, timed=True) as s:
        with spans.span("x.y", device=cuda):
            pass
    assert s.seconds >= 0
    with spans.Steps("z", device=cuda, seconds={}) as steps:
        steps.step("a")
        steps.step("b")
    assert CountingEvent.made == 0 and counting["rf"] == 0
    assert spans.records() == []


def test_on_makes_events_ranges_and_device_seconds(counting):
    cuda = torch.device("cuda")
    with spans.recording():
        with spans.span("x", device=cuda) as s:
            s.add(items=3)
            with spans.span("x.y"):
                pass
        with spans.Steps("z", device=cuda) as steps:
            steps.step("a")
            steps.step("b")
    recs = spans.records(clear=True)
    assert [r["name"] for r in recs] == ["x.y", "x", "z.a", "z.b"]
    # two events a span; the steps share their boundaries' events
    assert CountingEvent.made == 2 + 3
    assert counting["rf"] == 4
    x = recs[1]
    assert x["device_s"] == 0.005 and x["counts"] == {"items": 3}
    assert recs[0]["device_s"] is None       # no device given
    assert recs[0]["parent"] == x["id"] and recs[2]["parent"] is None


def test_steps_seconds_marks_and_split(counting):
    marks, seconds = [], {}
    with spans.Steps("k", device=torch.device("cuda"), seconds=seconds,
                     events=True, mark=marks.append) as steps:
        for name in ("a", "b", "a", "c"):
            steps.step(name)
    assert marks == ["a", "b", "a", "c"]
    assert set(seconds) == {"a", "b", "c"} and all(
        v >= 0 for v in seconds.values())
    # one event a boundary: five boundaries, each step 5 ms
    assert CountingEvent.made == 5
    assert steps.device_ms() == {"a": 10.0, "b": 5.0, "c": 5.0}
    assert spans.records() == []


def test_profiler_sees_the_spans_nested_as_recorded(traced_sample):
    _, recs, events = traced_sample
    ids = by_id(recs)
    main = recs[-1]["thread"]          # the root's
    mine = {r["name"] for r in recs}
    want = collections.Counter(
        (r["name"], ids[r["parent"]]["name"] if r["parent"] else None)
        for r in recs if r["thread"] == main)
    # the profile was started on the root's thread and records ranges
    # there (other threads' with profile_all_threads=True)
    thread = next(ev.thread for ev in events if ev.name == "pipeline")
    got = collections.Counter()
    for ev in events:
        if ev.name not in mine or ev.thread != thread:
            continue
        p = ev.cpu_parent
        while p is not None and p.name not in mine:
            p = p.cpu_parent
        got[(ev.name, p.name if p is not None else None)] += 1
    assert want and got == want


def test_recording_stops_with_the_profile(sim_dir):
    d, sim = sim_dir
    contigs = formalize_contigs(str(d / "contigs.fa"))
    ca = ContigAligner(np.asarray(sim.reference, np.int8), Config(),
                       device="cpu")
    spans.records(clear=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        assert spans.on()
        ca.align(contigs)
    n = len(spans.records())
    assert n > 10 and not spans.on()
    ca.align(contigs)
    assert len(spans.records(clear=True)) == n


def test_store_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "STORE", 4)
    monkeypatch.setattr(spans, "_REC", spans._Recorder())
    with spans.recording():
        for i in range(6):
            with spans.span(f"s{i}"):
                pass
    assert [r["name"] for r in spans.records()] == ["s2", "s3", "s4", "s5"]
    spans.records(clear=True)
    assert spans.records() == []


# stage (5)'s stats keys, as remove_misassembly has always kept them
MASB_STATS = {"index_s", "reads_s", "read_records", "reads_wait_s",
              "reads_copy_out_s", "reads_concat_s", "coverage_s",
              "contig_index_s", "contigs_s", "placements", "finalize_s",
              "finalize_split", "finalize_counts", "contigs_layer_s",
              "placement_loops_s", "sweep_split_s", "contigs_in",
              "whole_safe", "contigs_split", "pieces_out", "whole_safe_ids",
              "split_ids"}
MASB_STEPS = ("index", "reads", "coverage", "contig_index", "contigs",
              "placement_loops", "sweep_split")


def check_masb_root(recs, root, stats, which, written):
    """One `misassembly` span: its counts, its children, and stats as a
    view of them."""
    ids = by_id(recs)
    mine = [r for r in recs if r["sample"] == root["sample"]
            and root in ancestors(r, ids)]
    child = {r["name"]: r for r in mine if r["parent"] == root["id"]}
    assert set(child) == {f"misassembly.{s}" for s in MASB_STEPS} | {
        "misassembly.formalize", "misassembly.write"}
    assert any(r["name"] == "formalize.contigs"
               and r["parent"] == child["misassembly.formalize"]["id"]
               for r in mine)
    for step in MASB_STEPS:
        assert close(stats[f"{step}_s"],
                     child[f"misassembly.{step}"]["host_s"]), step
    ids_out, seqs_out = written
    assert root["counts"] == dict(
        contigs_in=stats["contigs_in"], bases_in=root["counts"]["bases_in"],
        read_records=stats["read_records"], placements=stats["placements"],
        whole_safe=stats["whole_safe"], contigs_split=stats["contigs_split"],
        pieces_out=stats["pieces_out"],
        bases_out=sum(len(s) for s in seqs_out[:stats["pieces_out"]]),
        which=which)
    assert stats["pieces_out"] <= len(ids_out)
    reads = child["misassembly.reads"]["counts"]
    assert reads["records"] == stats["read_records"] and reads["pairs"] > 0
    assert set(stats) == MASB_STATS


def test_misassembly_root_span(sim_dir, tmp_path):
    from aligngraph_tpu_torch.pipeline.misassembly import remove_misassembly

    d, sim = sim_dir
    reads = formalize_reads(str(d / "r1.fa"), str(d / "r2.fa"))
    contigs = formalize_contigs(str(d / "contigs.fa"))
    cfg = Config(distance_low=300, distance_high=700)
    stats = {}
    spans.records(clear=True)
    with spans.recording():
        out = remove_misassembly(str(d / "contigs.fa"), cfg,
                                 np.asarray(sim.reference, np.int8), reads,
                                 "extended", out_path=str(tmp_path / "c.fa"),
                                 device="cpu", stats=stats)
    recs = spans.records(clear=True)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["misassembly"]
    check_masb_root(recs, roots[0], stats, 0, read_fasta(out))
    assert roots[0]["counts"]["bases_in"] == sum(len(s) for s in
                                                 contigs.seqs)
    assert reads.n_pairs == next(r for r in recs if r["name"] ==
                                 "misassembly.reads")["counts"]["pairs"]


def test_misassembly_spans_under_run_pipeline(sim_dir, tmp_path):
    import dataclasses

    d = sim_dir[0]
    cfg = dataclasses.replace(sim_cfg(d, tmp_path), misassembly_removal=True)
    spans.records(clear=True)
    with spans.recording():
        res = run_pipeline(cfg, device="cpu")
    recs = spans.records(clear=True)
    assert [r["name"] for r in recs if r["parent"] is None] == ["pipeline"]
    ids = by_id(recs)
    stage = next(r for r in recs if r["name"] == "pipeline.misassembly")
    roots = [r for r in recs if r["name"] == "misassembly"]
    assert [ids[r["parent"]] for r in roots] == [stage, stage]
    masb = res.stats["misassembly"]
    for root, which in zip(roots, ("extended", "remaining")):
        out = tmp_path / f"corrected_{which}.fa"
        check_masb_root(recs, root, masb[which],
                        0 if which == "extended" else 1, read_fasta(out))
    assert close(res.stats["stage_seconds"]["misassembly_removal"],
                 stage["host_s"])
