"""Assembly evaluation — the Eval-AlignGraph equivalent (E1-E6,
Eval-AlignGraph/Eval-AlignGraph.cpp), PyTorch port.

A copy of aligngraph_tpu/evaluate/evaluate.py (which imports the JAX
contig aligner) with the port's ContigAligner on `device`; the metrics
equal the JAX package's.

Metrics (`analyze`, Eval-AlignGraph.cpp:310-399): #contigs, #true contigs
(one placement covering >= 80% of the contig), N50 over true aligned
lengths, covered genome length (bitmap), average/maximum aligned length,
MPMB (misassemblies per Mb of contig bases: errors-1 per multi-placement
contig), average identity (alignedBases-weighted).

Placement resolution mirrors `loadContigsAlignment`
(Eval-AlignGraph.cpp:213-308): IDENTITY 0.1 filters, >=100bp spans,
conflict resolution keeping the larger placement, collinear merge within
10% of span (`close`), cross-chromosome dedup.

Formalization (E2): contigs >= CUTOFF (1000bp) kept; > 1Mb split into
`id.frag` chunks of SIZE (1e6) with coordinates de-chunked after
alignment (Eval-AlignGraph.cpp:452-531; note: no tail-merge rule here,
unlike the assembler's chunker).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.fasta import encode, read_fasta
from aligngraph_tpu_torch.io.formalize import Contigs
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.ops.seeding import SeedIndex, build_index

CUTOFF = 1000      # Eval-AlignGraph.cpp:24
SIZE = 1_000_000   # Eval-AlignGraph.cpp:25
IDENTITY = 0.1     # Eval-AlignGraph.cpp:23
NONE = -1


@dataclasses.dataclass
class _Pos:
    target_id: int
    source_start: int
    source_end: int
    target_start: int
    target_end: int
    source_gap: int
    target_gap: int
    fr: int
    aligned_bases: int


def _conflict(x1, y1, x2, y2) -> bool:
    """Eval-AlignGraph.cpp:122-129: >=100bp overlap or containment."""
    return bool(
        (x1 <= x2 <= y1 <= y2 and int(y1) - int(x2) >= 100)
        or (x2 <= x1 <= y2 <= y1 and int(y2) - int(x1) >= 100)
        or (x1 <= x2 <= y2 <= y1 and int(y2) - int(x2) >= 100)
        or (x2 <= x1 <= y1 <= y2 and int(y1) - int(x1) >= 100)
        or (x1 <= x2 and y2 <= y1) or (x2 <= x1 and y1 <= y2))


def _close(y1, x2, threshold) -> bool:
    return abs(int(x2) - int(y1)) < threshold


def _chunk_eval(seq: np.ndarray) -> List[np.ndarray]:
    return [seq[i:i + SIZE] for i in range(0, len(seq), SIZE)]


def eval_queries(craw) -> Contigs:
    """E2: the contigs (FASTA strings) of at least CUTOFF bases, encoded,
    cut into chunks of SIZE: Eval's query set."""
    init: List[np.ndarray] = []
    chunk_real, chunk_start, chunk_len = [], [], []
    for s in craw:
        if len(s) < CUTOFF:
            continue
        e = encode(s)
        rid = len(init)
        init.append(e)
        for f, piece in enumerate(_chunk_eval(e)):
            chunk_real.append(rid)
            chunk_start.append(f * SIZE)
            chunk_len.append(len(piece))
    return Contigs(ids=[str(i) for i in range(len(init))], seqs=init,
                   chaff_ids=[], chaff_seqs=[],
                   chunk_real=np.array(chunk_real, np.int32),
                   chunk_start=np.array(chunk_start, np.int64),
                   chunk_len=np.array(chunk_len, np.int64))


def genome_index(genome_path, cfg: Optional[Config] = None, *,
                 device) -> SeedIndex:
    """The seed index that evaluate's aligner builds over genome_path's
    records end to end, built on `device`: built once, it serves several
    evaluate(..., index=) calls on one genome."""
    cfg = cfg or Config()
    return build_index(np.concatenate(
        [encode(s) for s in read_fasta(genome_path)[1]]), cfg.seed_len,
        device=device)


def evaluate(genome_path, contigs_path, out_path: Optional[str] = None,
             cfg: Optional[Config] = None, *, device,
             index: Optional[SeedIndex] = None,
             stats: Optional[Dict] = None) -> Dict[str, float]:
    """The metrics of contigs_path's contigs against genome_path.  index,
    when given, is genome_index(genome_path, cfg, device=) on the device
    or the CPU.  stats, when given, gets the contig aligner's seconds:
    index_s (its index build, or the index's upload), align_s and, of it,
    finalize_s, split by step in finalize_split; _finalize's counts,
    finalize_counts (contig_aligner.finalize_placements); and the align's
    seconds by layer, layer_s (ContigAligner.layer_s)."""
    cfg = cfg or Config()
    stats = {} if stats is None else stats
    gids, gseqs = read_fasta(genome_path)
    cids, craw = read_fasta(contigs_path)
    genome_enc = [encode(s) for s in gseqs]

    q = eval_queries(craw)
    init = q.seqs
    chunk_real, chunk_start = q.chunk_real.tolist(), q.chunk_start.tolist()

    metrics: Dict[str, float] = {"n_contigs": len(init)}
    if not init:
        metrics.update(n_true_contigs=0, n50=0, covered_length=0,
                       average_length=0, maximum_length=0, mpmb=0.0,
                       average_identity=0.0)
        return _emit(metrics, out_path)

    # E3: contig -> genome alignment (in-engine; relaxed acceptance, the
    # IDENTITY=0.1 filter below is the eval loader's own)
    gcat = np.concatenate(genome_enc)
    gstart = np.concatenate(
        [[0], np.cumsum([len(s) for s in genome_enc])]).astype(np.int64)
    t = time.perf_counter()
    aligner = ContigAligner(gcat, cfg, index=index, accept=(0.0, 0.0, 0),
                            device=device)
    stats["index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ali = aligner.align(q)
    stats["align_s"] = time.perf_counter() - t
    stats.update(finalize_s=aligner.finalize_s,
                 finalize_split=aligner.finalize_split,
                 finalize_counts=aligner.finalize_counts,
                 layer_s=dict(aligner.layer_s))
    del aligner

    # E4/E5: per real contig placement lists with conflict resolution
    positions: List[List[Optional[_Pos]]] = [[] for _ in init]
    for r in range(ali.n):
        chunk = int(ali.chunk_id[r])
        rid = chunk_real[chunk]
        frag_off = chunk_start[chunk]
        ss = int(ali.source_start[r]) + frag_off
        se = int(ali.source_end[r]) + frag_off
        sgap = int(ali.source_gap[r])
        gts, gte = int(ali.target_start[r]), int(ali.target_end[r])
        tid = int(np.searchsorted(gstart, gts, side="right")) - 1
        ts = gts - int(gstart[tid])
        te = min(gte, int(gstart[tid + 1])) - int(gstart[tid])
        tgap = int(ali.target_gap[r])
        ab = int(ali.score[r])         # aligned bases = sum of block sizes
        if not (se - ss >= 100
                and (se - ss - sgap) / (se - ss) >= IDENTITY
                and te - ts > 0
                and (te - ts - tgap) / (te - ts) >= IDENTITY):
            continue
        keep = True
        plist = positions[rid]
        for p in plist:
            if p.target_id != NONE and p.target_id == tid and \
                    _conflict(ss, se, p.source_start, p.source_end):
                if se - ss < p.source_end - p.source_start:
                    keep = False
                else:
                    _invalidate(p)
        if keep:
            plist.append(_Pos(tid, ss, se, ts, te, sgap, tgap,
                              int(ali.fr[r]), ab))

    # collinear merge (Eval-AlignGraph.cpp:269-288)
    for plist in positions:
        for j in range(len(plist)):
            k = 0
            while k < len(plist):
                pj, pk = plist[j], plist[k]
                if (k != j and pj.target_id != NONE and pk.target_id != NONE
                        and pj.target_id == pk.target_id
                        and _close(pj.source_end, pk.source_start,
                                   abs(pj.source_end - pj.source_start)
                                   // 10)
                        and _close(pj.target_end, pk.target_start,
                                   abs(pj.target_end - pj.target_start)
                                   // 10)
                        and pj.fr == pk.fr):
                    pj.source_end = pk.source_end
                    pj.target_end = pk.target_end
                    pj.source_gap += pk.source_gap
                    pj.target_gap += pk.target_gap
                    pj.aligned_bases += pk.aligned_bases
                    _invalidate(pk)
                    k = 0
                k += 1

    # cross-chromosome dedup (Eval-AlignGraph.cpp:290-304)
    for plist in positions:
        for j in range(len(plist)):
            for k in range(j + 1, len(plist)):
                pj, pk = plist[j], plist[k]
                if pj.target_id != NONE and pk.target_id != NONE and \
                        _conflict(pj.source_start, pj.source_end,
                                  pk.source_start, pk.source_end):
                    if pj.source_end - pj.source_start > \
                            pk.source_end - pk.source_start:
                        _invalidate(pk)
                    else:
                        _invalidate(pj)
                        break

    # E6: analyze (Eval-AlignGraph.cpp:310-399)
    bitmap = [np.zeros(len(s), bool) for s in genome_enc]
    true_lengths: List[int] = []
    identity: List[float] = []
    max_len = 0
    misassembly = 0
    for i, plist in enumerate(positions):
        true_hit = False
        for p in plist:
            if p.target_id != NONE and \
                    (p.source_end - p.source_start) / len(init[i]) >= 0.8:
                _tally(p, bitmap, true_lengths, identity)
                max_len = max(max_len, p.source_end - p.source_start)
                true_hit = True
                break
        if true_hit:
            continue
        errors = 0
        for p in plist:
            if p.target_id != NONE:
                _tally(p, bitmap, true_lengths, identity)
                max_len = max(max_len, p.source_end - p.source_start)
                errors += 1
        if errors >= 1:
            misassembly += max(errors - 1, 1) if errors >= 2 else 1

    total_length = sum(true_lengths)
    sorted_l = sorted(true_lengths)
    n50 = 0
    s = 0
    for i in range(len(sorted_l) - 1, -1, -1):
        s += sorted_l[i]
        if s > total_length // 2:
            n50 = sorted_l[i]
            break
    covered = int(sum(b.sum() for b in bitmap))
    contig_bases = sum(len(c) for c in init)
    metrics.update(
        # reference prints trueContigLengths.size() — the number of TALLIED
        # placements (one per true contig, plus every non-null placement of
        # a misassembled contig), Eval-AlignGraph.cpp:371
        n_true_contigs=len(true_lengths),
        n50=n50,
        covered_length=covered,
        average_length=total_length // max(len(true_lengths), 1),
        maximum_length=max_len,
        mpmb=misassembly / (contig_bases / 1e6) if contig_bases else 0.0,
        average_identity=(sum(identity) / total_length
                          if total_length else 0.0),
    )
    return _emit(metrics, out_path)


def _invalidate(p: _Pos) -> None:
    p.target_id = NONE
    p.source_start = p.source_end = p.target_start = p.target_end = -1
    p.source_gap = p.target_gap = p.aligned_bases = -1
    p.fr = -1


def _tally(p: _Pos, bitmap, true_lengths, identity) -> None:
    ln = p.source_end - p.source_start
    true_lengths.append(ln)
    bm = bitmap[p.target_id]
    lo = max(p.target_start, 0)
    hi = min(p.target_end, len(bm))
    bm[lo:hi] = True
    total = p.target_end - p.target_start + p.target_gap
    identity.append(p.aligned_bases * ln / max(total, 1))


def _emit(metrics: Dict, out_path: Optional[str]) -> Dict:
    if out_path:
        names = [("#contigs", "n_contigs"),
                 ("#true contigs", "n_true_contigs"),
                 ("N50", "n50"),
                 ("covered length", "covered_length"),
                 ("average length", "average_length"),
                 ("maximum length", "maximum_length"),
                 ("MPMB", "mpmb"),
                 ("average identity", "average_identity")]
        with open(out_path, "w") as f:
            for label, key in names:
                f.write(f"{label:<21}{metrics.get(key, 0)}\n")
    return metrics
