"""The contig aligner over a whole draft set, one call after another.

Set-up makes the sample from the seed, writes the drafts as FASTA and
formalizes them as run_pipeline's stage (0) does, builds the seed index
on the card and the ContigAligner on it as stage (1) builds its contig
aligner (the default join gap and the loadContiAli acceptance), and
warms up with one whole call.  A step is one ContigAligner.align of
every draft, the placements copied to the host.

The check compares, for every call of the window, the placements of
cell["check"]["drafts"] drafts (drawn from the seed) with the plain
reference.
"""

from __future__ import annotations

import os
import time

import numpy as np

from agbench import common, trace

SPANS = tuple(("aligngraph_tpu_torch.align.contig_aligner", f) for f in (
    "ContigAligner.align", "query_segments", "contig_seed_hits",
    "cluster_hits", "chain_clusters", "build_tile_jobs",
    "ContigAligner._run_tile_jobs", "finalize_placements"))


def setup(run) -> dict:
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
    from aligngraph_tpu_torch.io.formalize import formalize_contigs
    from aligngraph_tpu_torch.ops.seeding import build_index

    clock = common.Clock(run.setup_split)
    s = common.sample(run, clock)
    drafts = s["drafts"]
    inputs = common.temp_dir("agbench_inputs_")
    path = os.path.join(inputs, "contigs.fa")
    common.write_fasta(path, [f"c{i}" for i in range(len(drafts))], drafts)
    contigs = formalize_contigs(path)
    common.remove_tree(inputs)
    if contigs.n_chunks != len(drafts) or not np.array_equal(
            contigs.chunk_real, np.arange(len(drafts))):
        raise ValueError("the drafts must be one chunk each, none chaff")
    clock.lap("files")
    common.load_program(run.device)
    clock.lap("load")
    cfg = common.program_config(run.config)
    index = build_index(s["ref"], cfg.seed_len, device=run.device)
    aligner = ContigAligner(s["ref"], cfg, index=index, device=run.device)
    del index
    common.sync(run.device)
    clock.lap("index")
    st = dict(run=run, sample=s, aligner=aligner, contigs=contigs, got=[],
              bases=int(np.sum(contigs.chunk_len)),
              drafts=common.draft_sample(run, len(drafts)))
    for _ in range(int(run.cell.get("warm_steps", 1))):
        step(st)
    st["got"].clear()
    clock.lap("warm")
    return st


def step(st) -> dict:
    run, aligner = st["run"], st["aligner"]
    common.sync(run.device)
    t0 = time.perf_counter()
    pa = aligner.align(st["contigs"])
    common.sync(run.device)
    seconds = time.perf_counter() - t0
    with trace.keeping():
        st["got"].append(common.take_placements(pa, st["drafts"]))
    return dict(seconds=seconds, units={"bases": st["bases"], "calls": 1},
                stats=dict(layer_s=dict(aligner.layer_s),
                           finalize_s=aligner.finalize_s,
                           placements=pa.n))


def finish(st) -> dict:
    return dict(sample=st["sample"], got=st["got"], drafts=st["drafts"])


def check(run, kept, control=False) -> tuple:
    s = kept["sample"]
    ref = common.Reference(s["ref"], run.config, run.device)
    sub = [s["drafts"][i] for i in kept["drafts"]]
    got = kept["got"]
    if control:
        got = [ref.placements(sub, gapless=True)]
    want = ref.placements(sub)
    bad = [common.diff_rows(g, want, common.PLACEMENT_FIELDS) for g in got]
    return ([dict(name="placements_diff", value=sum(bad), limit=0)],
            sum(b > 0 for b in bad))
