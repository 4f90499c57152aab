"""The whole reassembly of one sample, one part (--part 1): the reads'
and the drafts' alignments, the graph (contig layer, k-mer layer), the
traversal and scaffolds, and the refinement that picks the outputs.

The order of the stages and the glue between them are frozen from
aligngraph_tpu_torch/pipeline/driver.py (run_pipeline, _graph_part) and
pipeline/refinement.py (refine) at commit 5fa5dc4; every stage is the
reference's own (read_aligner, contig_aligner, graph, kmer_layer,
traverse).  A run of the benchmark hands the same genome, reads and
drafts, and the same FASTA ids, to the program and to reassemble().
"""

from __future__ import annotations

import hashlib
import types
from typing import List, Tuple

import numpy as np

from agbench.reference import contig_aligner, read_aligner, seeding
from agbench.reference.graph import GraphTensors, build_contig_layer, \
    initial_contigs
from agbench.reference.kmer_layer import build_kmer_layer
from agbench.reference.traverse import extend_and_scaffold

THRESHOLD = 0.6               # AlignGraph.cpp:34 (read-pair ratio filter)
SMALL_CHUNK = 20_000          # AlignGraph.cpp:41 (refinement truncation)
SEP_N = 64                    # N-run between concatenated extended contigs
# the GraphTensors arrays that graph_digest hashes
GRAPH_FIELDS = ("base", "cm_cnt", "cm_contig", "cm_coff", "cm_next",
                "cm_nitem", "cm_base", "km_cnt", "km_trav", "km_contig",
                "km_coff", "km_contig0", "km_coff0", "km_mate", "km_cov",
                "km_votes", "km_s", "km_slen", "ed_cnt", "ed_pos",
                "ed_item")


def graph_digest(g) -> dict:
    """{field: hex digest} of a GraphTensors' arrays and sizes (the
    program's or the reference's: both have these names)."""
    out = {f: hashlib.sha1(np.ascontiguousarray(getattr(g, f)).data
                           ).hexdigest() for f in GRAPH_FIELDS}
    out["sizes"] = f"{g.part_len} {g.overflow_cap} {g.overflow_used}"
    return out


def all_batches(n_pairs: int, batch_pairs: int) -> list:
    """(start, cnt, P) of every batch of the read aligner."""
    return [(s, min(batch_pairs, n_pairs - s),
             read_aligner.batch_shape(min(batch_pairs, n_pairs - s),
                                      batch_pairs))
            for s in range(0, n_pairs, batch_pairs)]


def ratio_ok(r, threshold: float) -> np.ndarray:
    """The C13 read filter (AlignGraph.cpp:1261) on both mates:
    (se-ss-I)/size >= t and (te-ts-D)/(te-ts) >= t."""
    span = np.maximum(r.target_end - r.target_start, 1)
    ok = ((r.source_end - r.source_start - r.source_gap)
          / np.maximum(r.source_size, 1) >= threshold) & \
        ((r.target_end - r.target_start - r.target_gap) / span >= threshold)
    return ok.all(axis=1)


def refine(genome_id: str, draft_ids: List[str], initials, extended,
           p: dict, device, gapless: bool = False) -> tuple:
    """C24 on one part: each initial contig's first SMALL_CHUNK bases
    aligned to the extended contigs, the acceptance filters, and the
    outputs -> (extended ids, extended seqs, remaining ids, remaining
    seqs)."""
    n_real = len(draft_ids)
    init_tags = np.zeros(n_real, np.int64)
    ext_ids: List[str] = []
    ext_seqs: List[np.ndarray] = []
    ext_init: List[List[int]] = [[] for _ in extended]
    ext_tags = np.zeros(len(extended), np.int64)
    axis = np.zeros(0, np.int8)
    if extended and initials:
        sep = np.full(SEP_N, 4, np.int8)
        axis = np.concatenate([x for e in extended
                               for x in (np.asarray(e, np.int8), sep)])
        offsets = np.cumsum([0] + [len(e) + SEP_N for e in extended])[:-1]
        lens = np.array([len(e) for e in extended], np.int64)
    if len(axis) >= p["seed_len"]:
        sids = [r for r, _ in initials]
        rsizes = [len(s) for _, s in initials]
        queries = [np.asarray(s[:SMALL_CHUNK], np.int8) for _, s in initials]
        ali = contig_aligner.align_drafts(
            read_aligner.genome_padded(axis, device),
            seeding.build_index(axis, p["seed_len"], device=device),
            queries, fast_map=p["fast_map"], gapless=gapless)
        for r in range(ali.n):
            k = int(ali.chunk_id[r])
            src_size, real_size = int(ali.source_size[r]), rsizes[k]
            ss, se = int(ali.source_start[r]), int(ali.source_end[r])
            ts, te = int(ali.target_start[r]), int(ali.target_end[r])
            tgt = int(np.searchsorted(offsets, ts, side="right")) - 1
            if tgt < 0 or tgt >= len(extended):
                continue
            local_ts = ts - int(offsets[tgt])
            local_te = min(te - int(offsets[tgt]), int(lens[tgt]))
            if local_te <= local_ts:
                continue
            tsize, span = int(lens[tgt]), local_te - local_ts
            if not ((se - ss - int(ali.source_gap[r])) / src_size >= 0.8
                    and (span - int(ali.target_gap[r])) / span >= 0.8
                    and tsize > real_size + 100
                    and real_size > tsize / 100):
                continue
            # without --uniqueExtension every accepted placement tags
            ext_tags[tgt] = 1
            init_tags[sids[k]] = 1
            ext_init[tgt].append(sids[k])
    for j in range(len(extended)):
        if ext_tags[j] > 0:
            ext_ids.append(f"AlignGraph{len(ext_ids)} @ {genome_id} : "
                           + "".join(f"{draft_ids[s]} ; "
                                     for s in ext_init[j]))
            ext_seqs.append(np.asarray(extended[j], np.int8))
    rem = [i for i in range(n_real) if init_tags[i] == 0]
    return ext_ids, ext_seqs, [draft_ids[i] for i in rem], rem


def reassemble(genome: np.ndarray, genome_id: str,
               drafts: List[np.ndarray], draft_ids: List[str],
               data: np.ndarray, lens: np.ndarray, config: dict, device, *,
               gapless: bool = False) -> dict:
    """The reference's reassembly of one sample -> {"records": [one dict
    of the read records a batch], "placements": the drafts' placements,
    "graph": graph_digest after the traversal, "extended": [(id, seq)],
    "remaining": [(id, seq)]}.  gapless: both aligners take the gapless
    shortcut, the refinement's too (the check's control)."""
    p, q = config["aligner"], config["pipeline"]
    if q["part"] != 1 or q.get("unique_extension", False):
        raise ValueError("the reference reassembles --part 1 without "
                         "--uniqueExtension only")
    genome_p = read_aligner.genome_padded(genome, device)
    index = seeding.build_index(genome, p["seed_len"], device=device)
    batches = [read_aligner.align_batch(genome_p, index, data, lens, s, c, P,
                                        p, gapless=gapless)
               for s, c, P in all_batches(len(lens), p["batch_pairs"])]
    cali = contig_aligner.align_drafts(genome_p, index, drafts,
                                       fast_map=p["fast_map"],
                                       gapless=gapless)
    del genome_p, index
    rali = types.SimpleNamespace(**{
        f: np.concatenate([b[f] for b in batches]) for f in batches[0]})
    rali.n = len(rali.pair_id)
    # stage (3), the one part [0, len(genome)): the C13-accepted records
    # with both mates in it
    accepted = np.flatnonzero(ratio_ok(rali, THRESHOLD))
    ts = rali.target_start[accepted]
    part_rows = accepted[(ts >= 0).all(1) & (ts < len(genome)).all(1)]
    g = GraphTensors.create(genome)
    keep = (cali.target_start >= 0) & (cali.target_start < len(genome))
    part_cali = types.SimpleNamespace(
        n=int(keep.sum()), chunk_id=cali.chunk_id[keep], fr=cali.fr[keep],
        pos_map=[m for m, k in zip(cali.pos_map, keep) if k])
    initials = initial_contigs(drafts, build_contig_layer(g, drafts,
                                                          part_cali))
    build_kmer_layer(g, rali, data, q["k_mer"], q["insert_variation"],
                     part_rows, device=device)
    scaffolds = extend_and_scaffold(g, q["coverage"], q["k_mer"])
    digest = graph_digest(g)
    del g
    ext_ids, ext_seqs, rem_ids, rem = refine(genome_id, draft_ids, initials,
                                             scaffolds, p, device, gapless)
    return dict(records=batches, placements=cali, graph=digest,
                extended=list(zip(ext_ids, ext_seqs)),
                remaining=[(rem_ids[i], np.asarray(drafts[r], np.int8))
                           for i, r in enumerate(rem)])


def outputs_diff(got: List[Tuple[str, np.ndarray]],
                 want: List[Tuple[str, np.ndarray]]) -> int:
    """Output contigs that differ (id or bases) between two lists in one
    order, plus those the longer has beyond the shorter."""
    n = min(len(got), len(want))
    bad = sum(a[0] != b[0] or not np.array_equal(np.asarray(a[1], np.int8),
                                                 np.asarray(b[1], np.int8))
              for a, b in zip(got[:n], want[:n]))
    return int(bad) + abs(len(got) - len(want))
