"""Misassembly removal (stage (5), --misassemblyRemoval) of the plain
reference, on one file of draft contigs.

AlignGraph's removeMisassembly (AlignGraph.cpp:4281-4297) corrects an
output file in four steps, written here afresh from the C++
(loadReadAlignment(preContigs,id) :3940-3984, loadContigAlignment(
contigs,id) :4003-4145, conflict / close :3986-4001, removeMasb
:4147-4279):

  1. the contigs of the file longer than 200 bases;
  2. every read pair aligned to them (bowtie2 -k 1: the first record of
     a pair, no ratio filter), and each contig's per-base coverage: +1
     over [targetStart, targetEnd) of both mates of every aligned pair;
  3. the contigs placed on the genome (blat / nucmer), each placement
     kept if it spans 100 bases and more and both its ratios reach
     MIN_THRESHOLD (0.1); a placement that conflicts with a kept one
     (>= 100 bases of overlap, or containment) removes the shorter of
     the two; collinear placements closer than a tenth of their span
     merge; of two conflicting placements the shorter is removed again
     (the cross-chromosome pass); two that overlap are split at the
     least covered base of the overlap, two that abut give the less
     covered base away;
  4. removeMasb: a contig with a placement over >= 0.8 of its length is
     kept whole; otherwise its placed bases are safe, and each maximal
     run of unplaced bases is removed where its mean coverage is below
     --coverage (20); the safe runs longer than 200 bases are written,
     a contig cut in two or more as "<id> : part<N>".

The aligners below the steps are the reference's frozen modules:
read_aligner.align_batch with c13=False (the full [P, K] record layout
without the C13 mask) for step 2, and contig_aligner.align_drafts with
max_join_gap=2000 and accept=(0.0, 0.0, 0) for step 3.  This file builds
its own draft axis (each contig followed by 64 N) and seed index.  It
imports nothing of the port.

Departures from AlignGraph.cpp, each the port's, which the benchmark
holds to this file:
  - the aligners are the port's in-engine ones (reference/read_aligner,
    reference/contig_aligner), not bowtie2, blat or nucmer: "the first
    record of a pair" is the read aligner's best pair alignment, and the
    placements are the contig aligner's, with a join gap of 2000 so that
    a chimera's junction is not chained over (pblat -fastMap does not
    chain across it) and no acceptance filter of its own (step 3's
    MIN_THRESHOLD filter is the only one);
  - the read aligner runs in batches of BATCH_PAIRS pairs, the port's
    ReadAligner default, which stage (5) keeps whatever the deployment's
    batch size (a batch's shape decides which candidates it sheds);
  - every contig is one chunk: the 1 Mb chunking of the formalized
    contigs is not written here, and a contig of more than
    LARGE_CHUNK + 60 bases raises;
  - one target (the genome's one sequence): every placement has target
    id 0, so the cross-chromosome pass compares every pair;
  - a contig cut to one piece is written under its own id, without
    ": part0";
  - coordinates are non-negative and under 2^31 here, so the C++'s
    unsigned compares and int casts in overlap() are plain compares;
  - chaff (contigs of 200 bases and less) is not appended: the benchmark
    corrects the extended file, which has none.
"""

from __future__ import annotations

from typing import List

import numpy as np

from agbench.reference import contig_aligner, read_aligner, seeding

MIN_THRESHOLD = 0.1       # AlignGraph.cpp:42
CHAFF = 200               # contigs and pieces of at most this are dropped
LARGE_CHUNK = 1_000_000   # AlignGraph.cpp:40; 60 bases more stay one chunk
SEP_N = 64                # N bases after each contig on the read axis
BATCH_PAIRS = 32768       # the read aligner's batch, as stage (5) builds it
JOIN_GAP = 2000
WHOLE = 0.8               # removeMasb's whole-contig rule
DEAD = -1                 # target id of a removed placement
# placement fields, in the order of a placement tuple
TARGET, SS, SE, TS, TE, FR = range(6)


def read_axis(contigs: List[np.ndarray]) -> tuple:
    """The contigs end to end, each followed by SEP_N N bases -> (axis,
    each contig's offset on it)."""
    offsets = np.zeros(len(contigs), np.int64)
    parts, at = [], 0
    for i, c in enumerate(contigs):
        offsets[i] = at
        parts += [np.asarray(c, np.int8), np.full(SEP_N, 4, np.int8)]
        at += len(c) + SEP_N
    axis = np.concatenate(parts) if parts else np.zeros(0, np.int8)
    return axis, offsets


def stage_batches(n_pairs: int) -> list:
    """(start, cnt, P) of every batch of stage (5)'s read aligner."""
    return [(s, min(BATCH_PAIRS, n_pairs - s),
             read_aligner.batch_shape(min(BATCH_PAIRS, n_pairs - s),
                                      BATCH_PAIRS))
            for s in range(0, n_pairs, BATCH_PAIRS)]


def coverage(contigs: List[np.ndarray], data: np.ndarray, lens: np.ndarray,
             p: dict, device, keep: tuple = (), gapless: bool = False
             ) -> tuple:
    """Step 2 -> (per-base coverage of each contig, int32; the records of
    the batches whose starts are in `keep`, by start)."""
    axis, offsets = read_axis(contigs)
    sizes = np.array([len(c) for c in contigs], np.int64)
    cov = [np.zeros(n, np.int32) for n in sizes]
    kept = {}
    if len(axis) < p["seed_len"] or len(lens) == 0:
        return cov, kept
    axis_p = read_aligner.genome_padded(axis, device)
    index = seeding.build_index(axis, p["seed_len"], device=device)
    base = np.concatenate([[0], np.cumsum(sizes)])
    starts, ends = [], []
    for start, cnt, P in stage_batches(len(lens)):
        rec = read_aligner.align_batch(axis_p, index, data, lens, start,
                                       cnt, P, p, c13=False,
                                       gapless=gapless)
        if start in keep:
            kept[start] = rec
        pid = rec["pair_id"]
        first = np.ones(len(pid), bool)
        first[1:] = pid[1:] != pid[:-1]
        ts = rec["target_start"][first].reshape(-1).astype(np.int64)
        te = rec["target_end"][first].reshape(-1).astype(np.int64)
        c = np.searchsorted(offsets, ts, side="right") - 1
        lo = np.maximum(ts - offsets[c], 0)
        hi = np.minimum(te - offsets[c], sizes[c])
        on = hi > lo
        starts.append(base[c[on]] + lo[on])
        ends.append(base[c[on]] + hi[on])
    del axis_p, index
    # +1 at each span's start, -1 at its end, over the contigs end to end
    starts, ends = np.concatenate(starts), np.concatenate(ends)
    n = int(base[-1])
    delta = (np.bincount(starts, minlength=n + 1)
             - np.bincount(ends, minlength=n + 1))
    depth = np.cumsum(delta[:n])
    return [depth[base[i]:base[i + 1]].astype(np.int32)
            for i in range(len(contigs))], kept


def conflict(x1, y1, x2, y2) -> bool:
    """AlignGraph.cpp:3986-3993: >= 100 bases of overlap, or one span
    inside the other."""
    if x1 <= x2 <= y1 <= y2 and y1 - x2 >= 100:
        return True
    if x2 <= x1 <= y2 <= y1 and y2 - x1 >= 100:
        return True
    if x1 <= x2 <= y2 <= y1 and y2 - x2 >= 100:
        return True
    if x2 <= x1 <= y1 <= y2 and y1 - x1 >= 100:
        return True
    return (x1 <= x2 and y2 <= y1) or (x2 <= x1 and y1 <= y2)


def overlap(x1, y1, x2, y2) -> bool:
    """overlap() (AlignGraph.cpp:2388-2394): the spans share a base."""
    return ((x1 <= x2 <= y1 <= y2 and y1 > x2)
            or (x2 <= x1 <= y2 <= y1 and y2 > x1)
            or (x1 <= x2 <= y2 <= y1 and y2 > x2)
            or (x2 <= x1 <= y1 <= y2 and y1 > x1))


def close(y1, x2, within) -> bool:
    """AlignGraph.cpp:3995-4001."""
    return abs(x2 - y1) < within


def place(ali, n_contigs: int) -> List[List[list]]:
    """Step 3's MIN_THRESHOLD filter and conflict pass over the contig
    aligner's rows, in their order -> each contig's placements, [target,
    ss, se, ts, te, fr] each."""
    out: List[List[list]] = [[] for _ in range(n_contigs)]
    for r in range(ali.n):
        ss, se = int(ali.source_start[r]), int(ali.source_end[r])
        ts, te = int(ali.target_start[r]), int(ali.target_end[r])
        sgap, tgap = int(ali.source_gap[r]), int(ali.target_gap[r])
        if se - ss < 100 or (se - ss - sgap) / (se - ss) < MIN_THRESHOLD:
            continue
        if te - ts <= 0 or (te - ts - tgap) / (te - ts) < MIN_THRESHOLD:
            continue
        mine = out[int(ali.chunk_id[r])]
        keep = True
        # every kept placement it conflicts with is weighed, the loop
        # does not stop at the first that wins over it
        for q in mine:
            if q[TARGET] == 0 and conflict(ss, se, q[SS], q[SE]):
                if se - ss < q[SE] - q[SS]:
                    keep = False
                else:
                    q[TARGET] = DEAD
        if keep:
            mine.append([0, ss, se, ts, te, int(ali.fr[r])])
    return out


def merge_close(mine: List[list]) -> None:
    """AlignGraph.cpp:4068-4081: placement b that starts where a ends
    (within a tenth of a's span, on the contig and on the genome, the same
    strand) joins a.  After a join the scan restarts, and as in the C++'s
    for loop (ppp = 0, then ppp++) it resumes at the second placement."""
    for i in range(len(mine)):
        a = mine[i]
        j = 0
        while j < len(mine):
            b = mine[j]
            if (j != i and a[TARGET] != DEAD and b[TARGET] != DEAD
                    and a[TARGET] == b[TARGET]
                    and close(a[SE], b[SS], abs(a[SE] - a[SS]) // 10)
                    and close(a[TE], b[TS], abs(a[TE] - a[TS]) // 10)
                    and a[FR] == b[FR]):
                a[SE], a[TE] = b[SE], b[TE]
                b[TARGET] = DEAD
                j = 0
            j += 1


def drop_conflicts(mine: List[list]) -> None:
    """AlignGraph.cpp:4083-4091: of two live placements in conflict the
    shorter goes (the first of the pair on a tie)."""
    for i in range(len(mine)):
        for j in range(i + 1, len(mine)):
            a, b = mine[i], mine[j]
            if a[TARGET] == DEAD or b[TARGET] == DEAD:
                continue
            if conflict(a[SS], a[SE], b[SS], b[SE]):
                if a[SE] - a[SS] > b[SE] - b[SS]:
                    b[TARGET] = DEAD
                else:
                    a[TARGET] = DEAD


def split_at_least_covered(mine: List[list], cov: np.ndarray) -> None:
    """AlignGraph.cpp:4093-4141: two live placements that overlap end at
    the least covered base of the overlap (its first, on a tie), the
    earlier keeping it; two that abut give the less covered of the two
    bases at the junction away."""
    n = len(cov)
    for i in range(len(mine)):
        for j in range(i + 1, len(mine)):
            a, b = mine[i], mine[j]
            if a[TARGET] == DEAD or b[TARGET] == DEAD:
                continue
            if overlap(a[SS], a[SE], b[SS], b[SE]):
                first, second = (a, b) if a[SS] <= b[SS] else (b, a)
                lo = min(max(second[SS], 0), n - 1)
                hi = min(max(first[SE] - 1, 0), n - 1)
                cut = lo
                if hi >= lo:
                    best = cov[lo]
                    for k in range(lo + 1, hi + 1):
                        if cov[k] < best:
                            best, cut = cov[k], k
                first[SE] = cut
                second[SS] = cut + 1
            elif a[SE] == b[SS] and 0 < a[SE] <= n:
                if cov[a[SE] - 1] < cov[min(b[SS], n - 1)]:
                    a[SE] -= 1
                else:
                    b[SS] += 1
            elif b[SE] == a[SS] and 0 < b[SE] <= n:
                if cov[b[SE] - 1] < cov[min(a[SS], n - 1)]:
                    b[SE] -= 1
                else:
                    a[SS] += 1


def safe_bases(seq_len: int, live: List[list], cov: np.ndarray,
               min_cov) -> np.ndarray:
    """removeMasb's safe bases of one contig -> bool [seq_len]."""
    if any((q[SE] - q[SS]) / seq_len >= WHOLE for q in live):
        return np.ones(seq_len, bool)
    placed = np.zeros(seq_len, bool)
    for q in live:
        placed[max(0, q[SS]):min(seq_len, q[SE])] = True
    safe = placed.copy()
    # each maximal run of unplaced bases, by its edges
    edge = np.flatnonzero(np.diff(np.concatenate(
        [[1], placed.view(np.int8), [1]])))
    for lo, hi in zip(edge[0::2], edge[1::2]):
        total = int(cov[lo:hi].sum(dtype=np.int64))
        if not total / (hi - lo) < min_cov:
            safe[lo:hi] = True
    return safe


def pieces(cid: str, seq: np.ndarray, safe: np.ndarray) -> list:
    """The safe runs longer than CHAFF bases -> [(id, bases)]."""
    edge = np.flatnonzero(np.diff(np.concatenate(
        [[0], safe.view(np.int8), [0]])))
    runs = [(lo, hi) for lo, hi in zip(edge[0::2], edge[1::2])
            if hi - lo > CHAFF]
    if len(runs) == 1:
        return [(cid, seq[runs[0][0]:runs[0][1]])]
    return [(f"{cid} : part{k}", seq[lo:hi])
            for k, (lo, hi) in enumerate(runs)]


def remove_misassembly(genome: np.ndarray, drafts: List[np.ndarray],
                       draft_ids: List[str], data: np.ndarray,
                       lens: np.ndarray, config: dict, device, *,
                       keep_batches: tuple = (),
                       gapless: bool = False) -> dict:
    """Stage (5) on the drafts (int8 codes) with the reads (data int8
    [2n, L] mate-interleaved, lens [n]) against the genome -> {"pieces":
    [(id, int8 bases)] as written, "coverage": each contig's int32
    coverage, "placements": each contig's final placements as tuples
    (target, ss, se, ts, te, fr), "records": the c13-off records of the
    batches starting at keep_batches, by start}.  gapless: both aligners
    take the gapless shortcut (the check's control)."""
    p = config["aligner"]
    min_cov = config["pipeline"]["coverage"]
    kept = [i for i, d in enumerate(drafts) if len(d) > CHAFF]
    ids = [draft_ids[i] for i in kept]
    contigs = [np.asarray(drafts[i], np.int8) for i in kept]
    if any(len(c) > LARGE_CHUNK + 60 for c in contigs):
        raise ValueError("a contig of more than one 1 Mb chunk")
    cov, records = coverage(contigs, data, lens, p, device,
                            tuple(keep_batches), gapless)
    genome_p = read_aligner.genome_padded(genome, device)
    index = seeding.build_index(genome, p["seed_len"], device=device)
    ali = contig_aligner.align_drafts(
        genome_p, index, contigs, fast_map=p["fast_map"],
        max_join_gap=JOIN_GAP, accept=(0.0, 0.0, 0), gapless=gapless)
    del genome_p, index
    placed = place(ali, len(contigs))
    for mine in placed:
        merge_close(mine)
    for mine in placed:
        drop_conflicts(mine)
    for mine, c in zip(placed, cov):
        split_at_least_covered(mine, c)
    out = []
    for cid, seq, mine, c in zip(ids, contigs, placed, cov):
        live = [q for q in mine if q[TARGET] != DEAD]
        out += pieces(cid, seq, safe_bases(len(seq), live, c, min_cov))
    return dict(pieces=out, coverage=cov,
                placements=[[tuple(q) for q in mine] for mine in placed],
                records=records)
