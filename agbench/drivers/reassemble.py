"""The whole reassembly, one sample after another (closed loop, one
sample at a time, as a user's jobs run).

Set-up makes the sample from the seed (reads in memory, as
bench_pipeline.py holds them; the reference genome and the drafts as
FASTA files in a directory of the run's TMPDIR), loads the port's
kernels and runs one sample to warm up.  A step is one
pipeline.driver.run_pipeline on the card: the contigs and the genome
formalized from their files, the k-mer layer built where
graph_build_for puts it (on the card), outputs written into a work
directory of its own, which is deleted when the sample is done.  Every
sample of a run has the same inputs.

The check holds every sample of the window to the plain reference's
reassembly of the sample (reference/reassembly.py), which runs once
after the window: the alignment stage's read records of
cell["check"]["read_batches"] of its batches and the placements of
cell["check"]["drafts"] drafts (drawn from the seed), the graph after
the traversal (a digest of each array: the contig layer, the k-mer layer
and its edges), and the output contigs, extended and remaining.  The
step keeps references to the program's records, placements and graph
as it makes them and reads them after its clock stops.
"""

from __future__ import annotations

import os
import time

from agbench import common, trace
from agbench.reference import reassembly

# the stages of run_pipeline that a traced run puts in benchmark spans
SPANS = (("aligngraph_tpu_torch.io.formalize", "formalize_contigs"),
         ("aligngraph_tpu_torch.io.formalize", "formalize_genome")) + tuple(
    ("aligngraph_tpu_torch.pipeline.driver", f) for f in (
        "run_pipeline", "_align", "_graph_part", "build_contig_layer",
        "build_kmer_layer_device", "extend_and_scaffold",
        "_write_stage_files", "refine", "_trim", "_write_out",
        "_write_remaining"))


def setup(run) -> dict:
    from aligngraph_tpu_torch.io.formalize import Reads
    from aligngraph_tpu_torch.pipeline import driver

    clock = common.Clock(run.setup_split)
    s = common.sample(run, clock)
    inputs = common.temp_dir("agbench_inputs_")
    genome, contigs = (os.path.join(inputs, f) for f in
                       ("genome.fa", "contigs.fa"))
    common.write_fasta(genome, ["chr"], [s["ref"]])
    common.write_fasta(contigs, [f"c{i}" for i in range(len(s["drafts"]))],
                       s["drafts"])
    data, lens = s["data"], s["lens"]
    st = dict(run=run, sample=s, inputs=inputs, genome=genome,
              contigs=contigs, got=[], driver=driver,
              reads=Reads(len(lens), data.shape[1], data, lens),
              batches=common.read_batches(run, len(lens)),
              drafts=common.draft_sample(run, len(s["drafts"])))
    clock.lap("files")
    common.load_program(run.device)
    clock.lap("load")
    # references to the alignment stage's answers and to the graph after
    # the traversal, which step() reads once its clock has stopped
    align, walk = driver._align, driver.extend_and_scaffold

    def captured_align(*args, **kwargs):
        st["ali"] = align(*args, **kwargs)
        return st["ali"]

    def captured_walk(g, *args, **kwargs):
        st["graph"] = g
        return walk(g, *args, **kwargs)
    st["saved"] = (align, walk)
    driver._align, driver.extend_and_scaffold = captured_align, captured_walk
    for _ in range(int(run.cell.get("warm_steps", 1))):
        step(st)
    st["got"].clear()
    clock.lap("warm")
    return st


def step(st) -> dict:
    from aligngraph_tpu_torch.io.formalize import (formalize_contigs,
                                                   formalize_genome)
    from aligngraph_tpu_torch.pipeline import driver

    run = st["run"]
    work = common.temp_dir("agbench_sample_")
    cfg = common.program_config(
        run.config, read1="-", read2="-", contig=st["contigs"],
        genome=st["genome"],
        extended_contig=os.path.join(work, "extended.fa"),
        remaining_contig=os.path.join(work, "remaining.fa"),
        work_dir=os.path.join(work, "tmp"))
    pipe = run.config["pipeline"]
    common.sync(run.device)
    t0 = time.perf_counter()
    res = driver.run_pipeline(
        cfg, reads=st["reads"], contigs=formalize_contigs(cfg.contig),
        genome=formalize_genome(cfg.genome, cfg.part), device=run.device,
        auto_graph_build=pipe["auto_graph_build"])
    common.sync(run.device)
    seconds = time.perf_counter() - t0
    with trace.keeping():
        common.remove_tree(work)
        rali, cali = st.pop("ali")
        st["got"].append(dict(
            reads=common.take_records(rali, st["batches"]),
            placements=common.take_placements(cali, st["drafts"]),
            graph=reassembly.graph_digest(st.pop("graph")),
            extended=list(zip(res.extended_ids, res.extended_seqs)),
            remaining=list(zip(res.remaining_ids, res.remaining_seqs))))
        del rali, cali
    return dict(seconds=seconds, units={"samples": 1},
                stats=dict(stage_seconds=dict(res.stats["stage_seconds"]),
                           graph_build=res.stats.get("graph_build"),
                           extended=len(res.extended_ids),
                           remaining=len(res.remaining_ids)))


def finish(st) -> dict:
    st["driver"]._align, st["driver"].extend_and_scaffold = st["saved"]
    common.remove_tree(st["inputs"])
    return dict(sample=st["sample"], got=st["got"], batches=st["batches"],
                drafts=st["drafts"])


def reference(run, s: dict, gapless: bool = False) -> dict:
    """The plain reference's reassembly of the sample, with the ids the
    program reads from the FASTA files."""
    return reassembly.reassemble(
        s["ref"], "chr", s["drafts"],
        [f"c{i}" for i in range(len(s["drafts"]))], s["data"], s["lens"],
        run.config, run.device, gapless=gapless)


def answers(run, want: dict, batches: list, drafts) -> dict:
    """The reference's answers in the form step() keeps the program's."""
    bp = run.config["aligner"]["batch_pairs"]
    return dict(reads=[want["records"][start // bp]
                       for start, _, _ in batches],
                placements=common.take_placements(want["placements"],
                                                  drafts),
                graph=want["graph"], extended=want["extended"],
                remaining=want["remaining"])


def check(run, kept, control=False) -> tuple:
    s = kept["sample"]
    want = answers(run, reference(run, s), kept["batches"], kept["drafts"])
    got = kept["got"]
    if control:
        got = [answers(run, reference(run, s, gapless=True),
                       kept["batches"], kept["drafts"])]
    sums = dict(read_records_diff=0, placements_diff=0, graph_fields_diff=0,
                contigs_diff=0)
    bad = 0
    for g in got:
        d = dict(
            read_records_diff=sum(
                common.diff_rows(a, b, common.READ_FIELDS)
                for a, b in zip(g["reads"], want["reads"])),
            placements_diff=common.diff_rows(
                g["placements"], want["placements"],
                common.PLACEMENT_FIELDS),
            graph_fields_diff=sum(g["graph"].get(f) != v
                                  for f, v in want["graph"].items()),
            contigs_diff=reassembly.outputs_diff(
                g["extended"], want["extended"])
            + reassembly.outputs_diff(g["remaining"], want["remaining"]))
        for k, v in d.items():
            sums[k] += int(v)
        bad += any(v > 0 for v in d.values())
    return [dict(name=k, value=v, limit=0) for k, v in sums.items()], bad
