"""Misassembly removal — C26 (`removeMisassembly` + `removeMasb` +
`loadContigAlignment(contigs,id)`, AlignGraph.cpp:4281-4297, 4147-4279,
4003-4145, 3853-3984).

Per output file (extended / remaining):
  1. re-formalize its contigs (>200bp kept, 1Mb chunking; sub-200 pieces
     silently dropped — the reference writes them to an unopened stream)
  2. in-engine read->contig alignment (replacing bowtie2 -k 1); per-base
     coverage += over both mates' [targetStart, targetEnd) spans for
     pairs with both mates mapped (AlignGraph.cpp:3968-3974)
  3. contig->genome placements (replacing blat/nucmer) with de-chunked
     source coordinates, MIN_THRESHOLD (0.1) filters, conflict/close
     resolution, cross-chromosome dedup, then overlap/adjacency splits at
     minimum-coverage bases (AlignGraph.cpp:4093-4141)
  4. removeMasb: regions aligned >=0.8 of the contig => whole contig
     safe; otherwise covered spans safe and uncovered spans with average
     read coverage < --coverage removed; split at removed spans, drop
     pieces <= 200bp, emit `<id> : partN` headers; chaff appended for the
     remaining file (AlignGraph.cpp:4147-4279)

PyTorch port: a copy of aligngraph_tpu/pipeline/misassembly.py (which
imports the JAX aligners) with the port's ReadAligner, ContigAligner and
span_coverage on `device`.  Step 2 aligns the reads a batch a call
and keeps of each batch only its first records' target spans
(_first_spans), where the JAX file holds every record of the library
at once.  Step 4's region sweep and split find run boundaries with
numpy (_runs, _sweep), where the JAX file walks every base;
remove_misassembly reports its seconds and counts through `stats` and
through its spans (utils/spans.py): the root `misassembly` a call, with
its counts, and its steps below it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

import torch

from aligngraph_tpu_torch.config import MIN_THRESHOLD, Config
from aligngraph_tpu_torch.graph.traverse import _overlap
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import Contigs, Reads, formalize_contigs
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.ops.seeding import build_index
from aligngraph_tpu_torch.evaluate.evaluate import _close, _conflict
from aligngraph_tpu_torch.parallel.coverage import span_coverage
from aligngraph_tpu_torch.utils import spans

SEP_N = 64
# Per-group cap on the concatenated contig axis for device span coverage:
# bounds the O(axis) delta vector and keeps int32 coordinates exact
# (patchable in tests to force multi-group splitting).
_COV_CHUNK = 1 << 28
NONE = -1
# the root span's counts that stats holds too
ROOT_COUNTS = ("contigs_in", "read_records", "placements", "whole_safe",
               "contigs_split", "pieces_out")


@dataclasses.dataclass
class _CPos:
    target_id: int
    source_start: int
    source_end: int
    target_start: int
    target_end: int
    fr: int


def _first_spans(aligner: ReadAligner, reads: Reads) -> tuple:
    """The read align of every pair, one batch of aligner.batch_pairs
    pairs a call (a call's batch is the one a whole-library call aligns:
    the batch shape follows its pair count alone), kept down to each
    aligned pair's first record (the bowtie2 -k 1 analog) -> (its
    target_start, its target_end: [pairs, 2] int32 each, the records,
    the aligner's host seconds by step summed over the calls).  A
    batch's records, pos_map included (2L int32 a record), are dropped
    once its spans are taken, so the host never holds the library's
    records at once nor concatenates them."""
    ts, te, n = [], [], 0
    split: Dict[str, float] = {}
    for start in range(0, reads.n_pairs, aligner.batch_pairs):
        stop = min(start + aligner.batch_pairs, reads.n_pairs)
        ali = aligner.align(Reads(stop - start, reads.max_len,
                                  reads.data[2 * start:2 * stop],
                                  reads.lengths[start:stop]))
        pid = ali.pair_id
        first = np.concatenate([[True], pid[1:] != pid[:-1]]) if ali.n \
            else np.zeros(0, bool)
        ts.append(ali.target_start[first])
        te.append(ali.target_end[first])
        n += ali.n
        for k, v in aligner.split.items():
            split[k] = split.get(k, 0.0) + v
    return np.concatenate(ts), np.concatenate(te), n, split


def _coverage_from_reads(reads: Reads, contigs: Contigs, cfg: Config,
                         device, stats: Dict):
    """Steps 1-2: per-base read coverage over de-chunked contigs; the
    index build's, the align's and the coverage's seconds and the records
    go to stats."""
    # concat chunk axis with separators
    pieces, offs = [], []
    cursor = 0
    sep = np.full(SEP_N, 4, np.int8)
    for c in range(contigs.n_chunks):
        offs.append(cursor)
        s = np.asarray(contigs.chunk_seq(c), np.int8)
        pieces.append(s)
        pieces.append(sep)
        cursor += len(s) + SEP_N
    axis = np.concatenate(pieces) if pieces else np.zeros(0, np.int8)
    offs_a = np.array(offs, np.int64)
    cov = [np.zeros(len(s), np.int32) for s in contigs.seqs]
    if len(axis) < cfg.seed_len or reads.n_pairs == 0:
        return cov
    # raw records: the reference's coverage loader (AlignGraph.cpp:
    # 3940-3984) has no C13 ratio filter
    with spans.span("misassembly.index", device=device, timed=True) as s:
        index = build_index(axis, cfg.seed_len, device=device)
    stats["index_s"] = s.seconds
    with spans.span("misassembly.reads", device=device, timed=True) as s:
        aligner = ReadAligner.from_index(axis, index, cfg, c13=False,
                                         device=device)
        del index
        ts, te, n_records, split = _first_spans(aligner, reads)
        s.add(pairs=reads.n_pairs, records=n_records)
    stats["reads_s"] = s.seconds
    stats["read_records"] = n_records
    stats.update({f"reads_{k}": v for k, v in split.items()})
    del aligner
    with spans.span("misassembly.coverage", device=device, timed=True) as s:
        # vectorized span coverage on the device (replaces the reference's
        # sequential cov[lo:hi] += 1 loop, AlignGraph.cpp:3940-3984): map each
        # span into DE-CHUNKED real-contig coordinates (spans from a mid-chunk
        # of a >1 Mb contig may run past the chunk into the next chunk of the
        # same real contig, exactly like the host loop's min(hi, len(real))
        # clip), accumulate once over the concatenated real axis, slice back.
        ts = ts.reshape(-1).astype(np.int64)
        te = te.reshape(-1).astype(np.int64)
        chunk = np.searchsorted(offs_a, ts, side="right") - 1
        okc = (chunk >= 0) & (chunk < contigs.n_chunks)
        chunk_c = np.clip(chunk, 0, max(contigs.n_chunks - 1, 0))
        real_of = np.asarray(contigs.chunk_real, np.int64)[chunk_c]
        base_of = np.asarray(contigs.chunk_start, np.int64)[chunk_c]
        real_len = np.array([len(c) for c in cov], np.int64)
        real_offs = np.concatenate([[0], np.cumsum(real_len)])
        lo_r = ts - offs_a[chunk_c] + base_of
        hi_r = np.minimum(te - offs_a[chunk_c] + base_of, real_len[real_of])
        lo_r = np.maximum(lo_r, 0)
        starts2 = (real_offs[real_of] + lo_r)[okc]
        ends2 = (real_offs[real_of] + np.maximum(hi_r, lo_r))[okc]
        G = int(real_offs[-1])
        if len(starts2) and G:
            # Chunk the concatenated axis so int32 coordinates cannot wrap and
            # the O(axis) device delta vector stays bounded (<=1 GB int32).
            # Groups split on whole-contig boundaries; spans never cross a real
            # contig, so per-group accumulation is exact.
            CHUNK = _COV_CHUNK
            r0 = 0
            while r0 < contigs.n_real:
                r1 = r0 + 1
                while (r1 < contigs.n_real
                       and real_offs[r1 + 1] - real_offs[r0] <= CHUNK):
                    r1 += 1
                base = int(real_offs[r0])
                g = int(real_offs[r1]) - base
                m = (starts2 >= base) & (starts2 < base + g)
                if m.any() and g:
                    covax = span_coverage(
                        torch.from_numpy((starts2[m] - base).astype(np.int32)
                                         ).to(device),
                        torch.from_numpy((np.minimum(ends2[m], base + g)
                                          - base).astype(np.int32)).to(device),
                        G=g).cpu().numpy()
                    for r in range(r0, r1):
                        o = int(real_offs[r]) - base
                        cov[r] += covax[o:o + len(cov[r])]
                r0 = r1
    stats["coverage_s"] = s.seconds
    return cov


def _placements(contigs: Contigs, genome_codes: np.ndarray, cfg: Config,
                cov: List[np.ndarray], device,
                stats: Dict) -> List[List[_CPos]]:
    """Step 3: de-chunked contig->genome placements with splits; the index
    build's, the align's (and of it _finalize's, by step) and the loops'
    seconds, the placements and _finalize's counts go to stats."""
    positions: List[List[_CPos]] = [[] for _ in range(contigs.n_real)]
    if contigs.n_real == 0:
        return positions
    # small join gap: chimera junctions must NOT be chained into one
    # placement (the reference's pblat -fastMap does not chain introns);
    # relaxed acceptance — this loader's own MIN_THRESHOLD filter applies
    with spans.span("misassembly.contig_index", device=device,
                    timed=True) as s:
        index = build_index(np.asarray(genome_codes, np.int8), cfg.seed_len,
                            device=device)
    stats["contig_index_s"] = s.seconds
    with spans.span("misassembly.contigs", device=device, timed=True) as s:
        aligner = ContigAligner(genome_codes, cfg, index=index,
                                max_join_gap=2000, accept=(0.0, 0.0, 0),
                                device=device)
        ali = aligner.align(contigs)
        del index
    stats["contigs_s"] = s.seconds
    stats["placements"] = ali.n
    stats.update(finalize_s=aligner.finalize_s,
                 finalize_split=aligner.finalize_split,
                 finalize_counts=aligner.finalize_counts,
                 contigs_layer_s=dict(aligner.layer_s))
    del aligner
    with spans.span("misassembly.placement_loops", timed=True) as s:
        for r in range(ali.n):
            chunk = int(ali.chunk_id[r])
            real = int(contigs.chunk_real[chunk])
            off = int(contigs.chunk_start[chunk])
            ss = int(ali.source_start[r]) + off
            se = int(ali.source_end[r]) + off
            sgap = int(ali.source_gap[r])
            ts, te = int(ali.target_start[r]), int(ali.target_end[r])
            tgap = int(ali.target_gap[r])
            if not (se - ss >= 100
                    and (se - ss - sgap) / (se - ss) >= MIN_THRESHOLD
                    and te - ts > 0
                    and (te - ts - tgap) / (te - ts) >= MIN_THRESHOLD):
                continue
            keep = True
            for p in positions[real]:
                if p.target_id != NONE and p.target_id == 0 and \
                        _conflict(ss, se, p.source_start, p.source_end):
                    if se - ss < p.source_end - p.source_start:
                        keep = False
                    else:
                        p.target_id = NONE
            if keep:
                positions[real].append(_CPos(0, ss, se, ts, te,
                                             int(ali.fr[r])))

        # close-merge (AlignGraph.cpp:4068-4081)
        for plist in positions:
            for pp in range(len(plist)):
                ppp = 0
                while ppp < len(plist):
                    a, b = plist[pp], plist[ppp]
                    if (ppp != pp and a.target_id != NONE
                            and b.target_id != NONE
                            and a.target_id == b.target_id
                            and _close(a.source_end, b.source_start,
                                       abs(a.source_end - a.source_start)
                                       // 10)
                            and _close(a.target_end, b.target_start,
                                       abs(a.target_end - a.target_start)
                                       // 10)
                            and a.fr == b.fr):
                        a.source_end = b.source_end
                        a.target_end = b.target_end
                        b.target_id = NONE
                        ppp = 0
                    ppp += 1

        # cross-chromosome dedup (AlignGraph.cpp:4083-4091)
        for plist in positions:
            for pp in range(len(plist)):
                for ppp in range(pp + 1, len(plist)):
                    a, b = plist[pp], plist[ppp]
                    if a.target_id != NONE and b.target_id != NONE and \
                            _conflict(a.source_start, a.source_end,
                                      b.source_start, b.source_end):
                        if a.source_end - a.source_start > \
                                b.source_end - b.source_start:
                            b.target_id = NONE
                        else:
                            a.target_id = NONE

        # overlap / adjacency splits at minimum-coverage base
        # (AlignGraph.cpp:4093-4141)
        for real, plist in enumerate(positions):
            c = cov[real]
            for pp in range(len(plist)):
                for ppp in range(pp + 1, len(plist)):
                    a, b = plist[pp], plist[ppp]
                    if a.target_id == NONE or b.target_id == NONE:
                        continue
                    if _overlap(a.source_start, a.source_end,
                                b.source_start, b.source_end):
                        if a.source_start <= b.source_start:
                            start, end = b.source_start, a.source_end - 1
                        else:
                            start, end = a.source_start, b.source_end - 1
                        start = max(0, min(start, len(c) - 1))
                        end = max(0, min(end, len(c) - 1))
                        if end >= start:
                            span = c[start:end + 1]
                            mp = start + int(np.argmin(span))
                        else:
                            mp = start
                        if a.source_start <= b.source_start:
                            a.source_end = mp
                            b.source_start = mp + 1
                        else:
                            b.source_end = mp
                            a.source_start = mp + 1
                    elif a.source_end == b.source_start and \
                            0 < a.source_end <= len(c):
                        if c[a.source_end - 1] < c[min(b.source_start,
                                                      len(c) - 1)]:
                            a.source_end -= 1
                        else:
                            b.source_start += 1
                    elif b.source_end == a.source_start and \
                            0 < b.source_end <= len(c):
                        if c[b.source_end - 1] < c[min(a.source_start,
                                                       len(c) - 1)]:
                            b.source_end -= 1
                        else:
                            a.source_start += 1
    stats["placement_loops_s"] = s.seconds
    return positions


def _runs(mask: np.ndarray):
    """The maximal runs of True in a bool vector -> (starts, ends) int64,
    each run [start, end)."""
    edges = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0,
                                   append=0))
    return edges[0::2], edges[1::2]


def _sweep(state: np.ndarray, coverage) -> np.ndarray:
    """The region sweep (AlignGraph.cpp:4172-4210) over one contig's
    state (-1 on placed bases, else the base's read coverage): a maximal
    run of unplaced bases whose mean coverage is below `coverage` is
    removed, any other is kept -> bool, True on the bases kept.  The
    means are a cumulative sum's differences over the run lengths: the
    integer sums are exact, so each mean is the float64 that
    state[start:end].mean() gives."""
    unsafe = state != -1
    starts, ends = _runs(unsafe)
    cum = np.concatenate([[0], np.cumsum(np.where(unsafe, state, 0))])
    keep = ~((cum[ends] - cum[starts]) / (ends - starts) < coverage)
    mark = np.zeros(len(state) + 1, np.int8)
    mark[starts[keep]] = 1
    mark[ends[keep]] = -1
    return ~unsafe | (np.cumsum(mark[:-1]) > 0)


def remove_misassembly(file_path: str, cfg: Config,
                       genome_codes: np.ndarray, reads: Reads,
                       which: str,
                       chaff: Optional[tuple] = None,
                       out_path: Optional[str] = None, *, device,
                       stats: Optional[Dict] = None) -> str:
    """Correct one output file; returns the corrected path.

    stats, when given, gets the seconds of each step (index_s, reads_s,
    coverage_s, contig_index_s, contigs_s, placement_loops_s,
    sweep_split_s: the spans misassembly.<step>), the read align's host
    seconds by step (reads_wait_s, reads_copy_out_s, reads_concat_s:
    ReadAligner.split summed over its batches), of the contig align's
    _finalize (finalize_s) and of its steps (finalize_split), the contig
    align's layers (contigs_layer_s, ContigAligner.layer_s), the read
    records, the placements and _finalize's counts (finalize_counts), and
    the counts:
    contigs_in (the contigs over 200 bp), whole_safe (kept whole: a
    placement covers >= 0.8 of it), contigs_split (written as two or more
    ": part<N>" pieces), pieces_out (the records written before the
    chaff), and the ids of the contigs kept whole and of those split
    (whole_safe_ids, split_ids).

    The call is the span "misassembly" (a root outside run_pipeline);
    its steps are its children misassembly.<step>, and formalize and
    write its file steps.  The root counts contigs_in, bases_in,
    read_records, placements, whole_safe, contigs_split, pieces_out,
    bases_out (the bases of those pieces) and which (0 for the extended
    file, 1 for the remaining one)."""
    stats = {} if stats is None else stats
    with spans.span("misassembly") as root:
        with spans.span("misassembly.formalize"):
            contigs = formalize_contigs(file_path)
        cov = _coverage_from_reads(reads, contigs, cfg, device, stats)
        positions = _placements(contigs, genome_codes, cfg, cov, device,
                                stats)

        with spans.span("misassembly.sweep_split", timed=True) as s:
            corrected_ids: List[str] = []
            corrected_seqs: List[bytes] = []
            whole_safe_ids: List[str] = []
            split_ids: List[str] = []
            for real in range(contigs.n_real):
                seq = contigs.seqs[real]
                cid = contigs.ids[real]
                plist = [p for p in positions[real] if p.target_id != NONE]
                if any((p.source_end - p.source_start) / len(seq) >= 0.8
                       for p in plist):
                    safe = np.ones(len(seq), bool)             # all safe
                    whole_safe_ids.append(cid)
                else:
                    state = cov[real].astype(np.int64)        # raw coverage
                    for p in plist:
                        state[max(0, p.source_start):min(len(seq),
                                                         p.source_end)] = -1
                    safe = _sweep(state, cfg.coverage)
                # split at removed spans (AlignGraph.cpp:4228-4254)
                starts, ends = _runs(safe)
                long = ends - starts > 200
                pieces = [seq[i:j] for i, j in zip(starts[long], ends[long])]
                if len(pieces) == 1:
                    corrected_ids.append(cid)
                    corrected_seqs.append(decode(pieces[0]))
                else:
                    if pieces:
                        split_ids.append(cid)
                    for spn, piece in enumerate(pieces):
                        corrected_ids.append(f"{cid} : part{spn}")
                        corrected_seqs.append(decode(piece))
        stats.update(sweep_split_s=s.seconds, contigs_in=contigs.n_real,
                     whole_safe=len(whole_safe_ids),
                     contigs_split=len(split_ids),
                     pieces_out=len(corrected_ids),
                     whole_safe_ids=whole_safe_ids, split_ids=split_ids)

        out = out_path or _corrected_path(file_path)
        with spans.span("misassembly.write"):
            with open(out, "wb") as f:
                write_fasta(f, corrected_ids, corrected_seqs)
                if which == "remaining" and chaff is not None:
                    write_fasta(f, chaff[0], chaff[1])
        root.add(**{k: stats.get(k, 0) for k in ROOT_COUNTS},
                 bases_in=sum(len(x) for x in contigs.seqs),
                 bases_out=sum(len(x) for x in corrected_seqs),
                 which=int(which == "remaining"))
    return out


def _corrected_path(file_path: str) -> str:
    import os
    d, b = os.path.split(file_path)
    return os.path.join(d, "corrected_" + b)
