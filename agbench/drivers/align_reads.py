"""The PE read aligner over a whole library, one call after another.

Set-up makes the sample from the seed, builds the seed index on the card
and the ReadAligner on it as stage (1) of run_pipeline builds its read
aligner (ReadAligner.from_index, batches of the deployment's
batch_pairs, the C13 filter on), and warms up with cell["warm_steps"]
whole calls: after one, the first timed call still grew the host heap
for its 6 GB of records (concatenation 2.5 s against 1.0-1.4 s).  A
step is one ReadAligner.align of every pair of the library, the records
copied to the host; once its clock has stopped they are dropped and the
heap trimmed (common.trim_heap), so that every call starts from the same
host state.

The check compares, for every call of the window, the records of
cell["check"]["read_batches"] of its batches (drawn from the seed, the
short last batch always among them) with the plain reference.
"""

from __future__ import annotations

import time

from agbench import common, trace

SPANS = tuple(("aligngraph_tpu_torch.align.read_aligner", f) for f in (
    "ReadAligner.align", "ReadAligner._enqueue", "_align_core", "compact",
    "_expand_dense", "_expand_packed", "_row_table", "_wait", "_copy_out"))


def setup(run) -> dict:
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner
    from aligngraph_tpu_torch.io.formalize import Reads
    from aligngraph_tpu_torch.ops.seeding import build_index

    clock = common.Clock(run.setup_split)
    s = common.sample(run, clock)
    common.load_program(run.device)
    clock.lap("load")
    cfg = common.program_config(run.config)
    index = build_index(s["ref"], cfg.seed_len, device=run.device)
    aligner = ReadAligner.from_index(
        s["ref"], index, cfg,
        batch_pairs=run.config["aligner"]["batch_pairs"], device=run.device)
    del index
    common.sync(run.device)
    clock.lap("index")
    data, lens = s["data"], s["lens"]
    st = dict(run=run, sample=s, aligner=aligner, got=[],
              reads=Reads(len(lens), data.shape[1], data, lens),
              batches=common.read_batches(run, len(lens)))
    for _ in range(int(run.cell.get("warm_steps", 1))):
        step(st)
    st["got"].clear()
    clock.lap("warm")
    return st


def step(st) -> dict:
    run, aligner = st["run"], st["aligner"]
    common.sync(run.device)
    t0 = time.perf_counter()
    recs = aligner.align(st["reads"])
    common.sync(run.device)
    seconds = time.perf_counter() - t0
    n, records = st["reads"].n_pairs, recs.n
    with trace.keeping():
        st["got"].append(common.take_records(recs, st["batches"]))
        del recs
        common.trim_heap()
    split = dict(aligner.split)
    return dict(seconds=seconds, units={"pairs": n, "calls": 1},
                stats=dict(split=split, records=records, pairs=n,
                           host_s=split["copy_out_s"] + split["concat_s"],
                           transfer=dict(aligner.transfer)))


def finish(st) -> dict:
    return dict(sample=st["sample"], got=st["got"], batches=st["batches"])


def check(run, kept, control=False) -> tuple:
    s = kept["sample"]
    ref = common.Reference(s["ref"], run.config, run.device)
    got = kept["got"]
    if control:
        got = [[ref.records(s["data"], s["lens"], b, gapless=True)
                for b in kept["batches"]]]
    bad = [0] * len(got)
    for j, b in enumerate(kept["batches"]):
        want = ref.records(s["data"], s["lens"], b)
        for i, g in enumerate(got):
            bad[i] += common.diff_rows(g[j], want, common.READ_FIELDS)
    return ([dict(name="read_records_diff", value=sum(bad), limit=0)],
            sum(b > 0 for b in bad))
