"""Refinement / final output selection — C24 (`refinement`,
AlignGraph.cpp:2864-3195).

Pipeline: initial contigs truncated to SMALL_CHUNK (20kb) prefixes ->
aligned against that part's extended contigs (in-engine long-query aligner
replaces the reference's pblat/nucmer subprocess) -> acceptance filters
(both ratios >= 0.8, targetSize > realSourceSize + 100, realSourceSize >
targetSize/100, AlignGraph.cpp:3059) -> extended contigs that extend some
initial contig are emitted with `>AlignGraph<N> @ <genomeId> : <ids> ;`
headers; untagged initial contigs + chaff become the remaining output.

The `--uniqueExtension` largest-extension-wins state machine
(AlignGraph.cpp:3061-3081) is preserved exactly, including its reliance on
PSL line order (our placements are emitted in deterministic query-major
order like pblat's).

PyTorch port: a copy of aligngraph_tpu/pipeline/refinement.py (which
imports the JAX contig aligner) with the port's ContigAligner on `device`.

Quirk preserved: the reference indexes `genomeIds[i]` by *part* number
(AlignGraph.cpp:3102) even though genomeIds has one entry per input
chromosome — with --part > 1 the header genome ids drift exactly as the
reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from aligngraph_tpu_torch.config import Config, SMALL_CHUNK
from aligngraph_tpu_torch.io.formalize import Contigs, Genome
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner

SEP_N = 64   # N-run separator between concatenated extended contigs


@dataclasses.dataclass
class RefinementResult:
    extended_ids: List[str]          # output headers (extendedContig file)
    extended_seqs: List[np.ndarray]
    remaining_ids: List[str]
    remaining_seqs: List[np.ndarray]
    init_tags: np.ndarray            # per real contig: 1 = extended


def _short_initials(initials: List[Tuple[int, np.ndarray]]):
    """Truncate to SMALL_CHUNK prefixes; keep (init_id, real_size)."""
    ids, sizes, seqs = [], [], []
    for rid, seq in initials:
        ids.append(rid)
        sizes.append(len(seq))
        seqs.append(seq[:SMALL_CHUNK])
    return ids, sizes, seqs


def refine(cfg: Config, genome: Genome, contigs: Contigs,
           per_part_initials: List[List[Tuple[int, np.ndarray]]],
           per_part_extended: List[List[np.ndarray]], *,
           device) -> RefinementResult:
    n_real = contigs.n_real
    init_tags = np.zeros(n_real, np.int64)
    ext_out_ids: List[str] = []
    ext_out_seqs: List[np.ndarray] = []
    seq_id = 0

    # Reference quirk (AlignGraph.cpp:3031-3105): `extdInitMap` is NEVER
    # cleared between chromosomes (extdContigs/extdTags are) while being
    # indexed by the PER-CHROMOSOME extended-contig id — so ids of initial
    # contigs accepted in earlier chromosomes leak into later chromosomes'
    # headers whenever their extended ids collide.  Preserved for byte
    # parity (test_golden_flag_matrix[multichrom_iterativeMap]).
    ext_init_map: List[List[int]] = []

    for part in range(genome.n_parts):
        extd = per_part_extended[part]
        initials = per_part_initials[part]
        ext_tags = np.zeros(len(extd), np.int64)
        # one appended entry per extended contig read (AlignGraph.cpp:3035)
        ext_init_map.extend([] for _ in extd)
        if not extd or not initials:
            continue

        # concatenated extended-contig axis with N separators
        off = []
        pieces = []
        cursor = 0
        sep = np.full(SEP_N, 4, np.int8)
        for eseq in extd:
            off.append(cursor)
            pieces.append(np.asarray(eseq, np.int8))
            pieces.append(sep)
            cursor += len(eseq) + SEP_N
        axis = np.concatenate(pieces) if pieces else np.zeros(0, np.int8)
        offsets = np.array(off, np.int64)
        lens = np.array([len(e) for e in extd], np.int64)

        sids, rsizes, sseqs = _short_initials(initials)
        q = Contigs(
            ids=[str(s) for s in sids],
            seqs=[np.asarray(s, np.int8) for s in sseqs],
            chaff_ids=[], chaff_seqs=[],
            chunk_real=np.arange(len(sseqs), dtype=np.int32),
            chunk_start=np.zeros(len(sseqs), np.int64),
            chunk_len=np.array([len(s) for s in sseqs], np.int64),
        )
        if len(axis) < cfg.seed_len:
            continue
        aligner = ContigAligner(axis, cfg, device=device)
        ali = aligner.align(q)

        # process placements in deterministic (query, order) sequence —
        # the analog of PSL line order
        target_id_bak = -1
        for r in range(ali.n):
            k = int(ali.chunk_id[r])
            src_size = int(ali.source_size[r])       # truncated size
            real_size = rsizes[k]
            ss, se = int(ali.source_start[r]), int(ali.source_end[r])
            sgap = int(ali.source_gap[r])
            ts, te = int(ali.target_start[r]), int(ali.target_end[r])
            tgap = int(ali.target_gap[r])
            # map to a single extended contig (separators make spanning
            # alignments impossible in practice; clamp defensively)
            tgt = int(np.searchsorted(offsets, ts, side="right")) - 1
            if tgt < 0 or tgt >= len(extd):
                continue
            local_ts = ts - int(offsets[tgt])
            local_te = te - int(offsets[tgt])
            if local_te > int(lens[tgt]):
                local_te = int(lens[tgt])
            if local_te <= local_ts:
                continue
            tsize = int(lens[tgt])
            span = local_te - local_ts
            if not ((se - ss - sgap) / src_size >= 0.8
                    and (span - tgap) / span >= 0.8
                    and tsize > real_size + 100
                    and real_size > tsize / 100):
                continue
            src = sids[k]                 # real contig index
            if cfg.unique_extension:
                if init_tags[src] > 0 and target_id_bak != -1:
                    if ext_tags[target_id_bak] < tsize:
                        ext_tags[target_id_bak] = 0
                        if ext_init_map[target_id_bak]:
                            ext_init_map[target_id_bak].pop()
                        ext_tags[tgt] = tsize
                        init_tags[src] = 1
                        ext_init_map[tgt].append(src)
                else:
                    ext_tags[tgt] = tsize
                    init_tags[src] = 1
                    ext_init_map[tgt].append(src)
                target_id_bak = tgt
            else:
                ext_tags[tgt] = 1
                init_tags[src] = 1
                ext_init_map[tgt].append(src)

        # emit tagged extended contigs for this part
        gid = genome.ids[part] if part < len(genome.ids) else \
            genome.ids[-1]     # reference quirk: genomeIds indexed by part
        for j in range(len(extd)):
            if ext_tags[j] > 0:
                # reference appends "<id> ; " after every id, INCLUDING a
                # trailing " ; " (AlignGraph.cpp:3102-3105) — keep the
                # trailing space for byte parity (test_golden_parity)
                header = f"AlignGraph{seq_id} @ {gid} : " + "".join(
                    f"{contigs.ids[s]} ; " for s in ext_init_map[j])
                ext_out_ids.append(header)
                ext_out_seqs.append(np.asarray(extd[j], np.int8))
                seq_id += 1

    # remaining = untagged initial contigs (original ids) + chaff verbatim
    rem_ids: List[str] = []
    rem_seqs: List[np.ndarray] = []
    for i in range(n_real):
        if init_tags[i] == 0:
            rem_ids.append(contigs.ids[i])
            rem_seqs.append(contigs.seqs[i])
    return RefinementResult(ext_out_ids, ext_out_seqs, rem_ids, rem_seqs,
                            init_tags)
