"""Misassembly removal (stage (5), --misassemblyRemoval) of a whole draft
set, one call after another (closed loop, as a user corrects one
sample's drafts after another).

Set-up makes the sample from the seed, writes its drafts once as FASTA
(ids c0, c1, ...), loads the port's kernels and runs cell["warm_steps"]
calls to warm up.  A step is one pipeline.misassembly.remove_misassembly
of that file, called as stage (5) of run_pipeline calls it: the port's
Config of the deployment, the genome's codes, the sample's reads (host
arrays, as run_pipeline holds them), the file "extended" and no chaff,
on the card.  It formalizes the drafts, aligns every pair to them, sums
their coverage, places them on the genome, splits them, and writes the
corrected FASTA into a work directory of its own, which is deleted once
the step's clock has stopped; the heap is then trimmed
(common.trim_heap), so that every call starts from the same host.
Every step of a run has the same inputs.

The check holds every step of the window to the plain reference's
stage (5) (reference/misassembly.py), which runs once after the window:
the corrected records (id and bases), each draft's per-base coverage,
each draft's final placements, and the records of the read align (the
C13 filter off) of cell["check"]["read_batches"] of its batches, drawn
from the seed.  The step keeps references to the coverage and the
placements as the program makes them (_coverage_from_reads and
_placements wrapped) and reads them after its clock has stopped.  The
sampled batches' records come from the program's read aligner as stage
(5) builds it (ReadAligner.from_index wrapped to keep its genome axis
and settings), each batch aligned alone once the window has closed: a
batch's records follow from its own pairs alone, and nothing of the
check runs inside a step's clock.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
import types

import numpy as np

from agbench import common, trace
from agbench.reference import misassembly as reference_masb

# the steps of remove_misassembly that a traced run puts in benchmark spans
SPANS = tuple(("aligngraph_tpu_torch.pipeline.misassembly", f) for f in (
    "remove_misassembly", "formalize_contigs", "_coverage_from_reads",
    "span_coverage", "_placements", "write_fasta")) + (
    ("aligngraph_tpu_torch.align.read_aligner", "ReadAligner.align"),
    ("aligngraph_tpu_torch.align.contig_aligner", "ContigAligner.align"))


def batches(run, n_pairs: int) -> list:
    """The read align's batches whose records the check compares: (start,
    cnt, P) of cell["check"]["read_batches"] of stage (5)'s batches,
    drawn from the seed, the short last one among them."""
    shim = types.SimpleNamespace(
        config={"aligner": {"batch_pairs": reference_masb.BATCH_PAIRS}},
        cell=run.cell, seed=run.seed)
    return common.read_batches(shim, n_pairs)


def digest(a) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).data).hexdigest()


def read_pieces(path: str) -> list:
    """The records of a FASTA file -> [(id, SHA-1 of its bases)]."""
    out, cid, seq = [], None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if cid is not None:
                    out.append((cid, hashlib.sha1(b"".join(seq)).hexdigest()))
                cid, seq = line[1:].decode(), []
            else:
                seq.append(line)
    if cid is not None:
        out.append((cid, hashlib.sha1(b"".join(seq)).hexdigest()))
    return out


def placement_rows(positions) -> list:
    """The program's placements (_CPos lists) as reference tuples."""
    return [[(p.target_id, p.source_start, p.source_end, p.target_start,
              p.target_end, p.fr) for p in plist] for plist in positions]


def setup(run) -> dict:
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner
    from aligngraph_tpu_torch.io.formalize import Reads
    from aligngraph_tpu_torch.pipeline import misassembly

    clock = common.Clock(run.setup_split)
    s = common.sample(run, clock)
    inputs = common.temp_dir("agbench_inputs_")
    contigs = os.path.join(inputs, "contigs.fa")
    common.write_fasta(contigs, [f"c{i}" for i in range(len(s["drafts"]))],
                       s["drafts"])
    data, lens = s["data"], s["lens"]
    st = dict(run=run, sample=s, inputs=inputs, contigs=contigs, got=[],
              reads=Reads(len(lens), data.shape[1], data, lens),
              batches=batches(run, len(lens)),
              cfg=common.program_config(run.config, contig=contigs))
    clock.lap("files")
    common.load_program(run.device)
    clock.lap("load")
    cover, place = misassembly._coverage_from_reads, misassembly._placements
    from_index = ReadAligner.__dict__["from_index"]

    def captured_cover(*args, **kwargs):
        st["cov"] = cover(*args, **kwargs)
        return st["cov"]

    def captured_place(*args, **kwargs):
        st["pos"] = place(*args, **kwargs)
        return st["pos"]

    def captured_from_index(cls, genome_codes, index, cfg, *args, **kwargs):
        st["read_aligner"] = (genome_codes, cfg, args, kwargs)
        return from_index.__func__(cls, genome_codes, index, cfg, *args,
                                   **kwargs)
    st["saved"] = (misassembly, cover, place, ReadAligner, from_index)
    misassembly._coverage_from_reads = captured_cover
    misassembly._placements = captured_place
    ReadAligner.from_index = classmethod(captured_from_index)
    for _ in range(int(run.cell.get("warm_steps", 1))):
        step(st)
    st["got"].clear()
    clock.lap("warm")
    return st


def step(st) -> dict:
    from aligngraph_tpu_torch.pipeline.misassembly import remove_misassembly

    run = st["run"]
    work = common.temp_dir("agbench_masb_")
    out = os.path.join(work, "corrected_contigs.fa")
    stats: dict = {}
    common.sync(run.device)
    t0 = time.perf_counter()
    remove_misassembly(st["contigs"], st["cfg"], st["sample"]["ref"],
                       st["reads"], "extended", None, out,
                       device=run.device, stats=stats)
    common.sync(run.device)
    seconds = time.perf_counter() - t0
    with trace.keeping():
        st["got"].append(dict(
            pieces=read_pieces(out),
            coverage=[digest(c) for c in st.pop("cov")],
            placements=placement_rows(st.pop("pos"))))
        common.remove_tree(work)
        common.trim_heap()
    return dict(seconds=seconds, units={"samples": 1},
                stats={k: v for k, v in stats.items()
                       if isinstance(v, (int, float))})


def sampled_records(st) -> list:
    """The records of each sampled batch, aligned alone by the program's
    read aligner built as stage (5) built it -> [{field: array}] a
    batch, pair ids numbered in the library."""
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner
    from aligngraph_tpu_torch.io.formalize import Reads
    from aligngraph_tpu_torch.ops.seeding import build_index

    axis, cfg, args, kwargs = st["read_aligner"]
    index = build_index(axis, cfg.seed_len, device=st["run"].device)
    aligner = ReadAligner.from_index(axis, index, cfg, *args, **kwargs)
    reads, out = st["reads"], []
    for start, cnt, _ in st["batches"]:
        recs = aligner.align(Reads(
            cnt, reads.max_len, reads.data[2 * start:2 * (start + cnt)],
            reads.lengths[start:start + cnt]))
        got = {f: getattr(recs, f) for f in common.READ_FIELDS}
        got["pair_id"] = got["pair_id"] + np.int32(start)
        out.append(got)
    return out


def finish(st) -> dict:
    misassembly, cover, place, ReadAligner, from_index = st["saved"]
    misassembly._coverage_from_reads = cover
    misassembly._placements = place
    ReadAligner.from_index = from_index
    records = sampled_records(st)
    for g in st["got"]:
        g["records"] = records
    common.remove_tree(st["inputs"])
    return dict(sample=st["sample"], got=st["got"], batches=st["batches"])


def answers(ref: dict, picked: list) -> dict:
    """The reference's stage (5) in the form step() keeps the program's."""
    return dict(
        pieces=[(cid, hashlib.sha1(common.ALPHABET[np.asarray(
            seq, np.int64)].tobytes()).hexdigest()) for cid, seq in
            ref["pieces"]],
        coverage=[digest(c) for c in ref["coverage"]],
        placements=ref["placements"],
        records=[ref["records"][start] for start, _, _ in picked])


def reference(run, s: dict, picked: list, gapless: bool = False) -> dict:
    t0 = time.perf_counter()
    ref = reference_masb.remove_misassembly(
        s["ref"], s["drafts"], [f"c{i}" for i in range(len(s["drafts"]))],
        s["data"], s["lens"], run.config, run.device,
        keep_batches=tuple(start for start, _, _ in picked),
        gapless=gapless)
    print(f"# reference stage (5) {time.perf_counter() - t0} s"
          f"{' (gapless)' if gapless else ''}", file=sys.stderr, flush=True)
    return answers(ref, picked)


def listed_diff(got: list, want: list) -> int:
    """Entries that differ between two lists in one order, plus those the
    longer has beyond the shorter."""
    n = min(len(got), len(want))
    return sum(a != b for a, b in zip(got[:n], want[:n])) + \
        abs(len(got) - len(want))


def check(run, kept, control=False) -> tuple:
    s = kept["sample"]
    picked = batches(run, len(s["lens"]))
    want = reference(run, s, picked)
    got = kept["got"]
    if control:
        got = [reference(run, s, picked, gapless=True)]
    sums = dict(masb_pieces_diff=0, coverage_diff=0, placements_diff=0,
                read_records_diff=0)
    bad = 0
    for g in got:
        d = dict(
            masb_pieces_diff=listed_diff(g["pieces"], want["pieces"]),
            coverage_diff=listed_diff(g["coverage"], want["coverage"]),
            placements_diff=listed_diff(g["placements"],
                                        want["placements"]),
            read_records_diff=sum(
                common.diff_rows(a, b, common.READ_FIELDS)
                for a, b in zip(g["records"], want["records"])))
        for k, v in d.items():
            sums[k] += int(v)
        bad += any(v > 0 for v in d.values())
    return [dict(name=k, value=v, limit=0) for k, v in sums.items()], bad
