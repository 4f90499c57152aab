"""Contig-layer graph build — C17 (`updateGenomeWithContig`,
AlignGraph.cpp:884-1217).

Semantics preserved exactly (SI=SD=0 build: only the "large" indel paths
are live):
 - per chunk, placements processed in order; a placement is skipped when
   (a) its base-0 offset is within chunk-length of ANY earlier placement's
       base-0 offset (uint32 wraparound arithmetic, AlignGraph.cpp:903), or
   (b) any of its aligned positions (except the last base) already holds
       >= 2 ContiMers (AlignGraph.cpp:914)
 - ordinary base: ContiMer(next=cur+1); genome deletion: next skips the
   deleted span; unaligned run (insertion to genome): novel bases appended
   to the position axis (overflow segment) chained through
 - terminal ContiMer with next=-1 carrying the *genome* nucleotide
   (AlignGraph.cpp:1121-1148)
 - "initial contigs": real contigs whose fraction of chunks with >= 1
   surviving placement >= CONTIG_THRESHOLD, in original orientation
   (AlignGraph.cpp:1188-1216)

Ordinary runs are vectorized; only block-boundary events (indels,
placement bookkeeping) loop in Python — events are O(#blocks), not
O(#bases).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from aligngraph_tpu_torch.align.types import ContigAlignments
from aligngraph_tpu_torch.config import CONTIG_THRESHOLD
from aligngraph_tpu_torch.graph.model import NONE32, S_CM, GraphTensors
from aligngraph_tpu_torch.io.formalize import Contigs

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def _revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq][::-1]


def _u32_absdiff_lt(a: int, b: int, limit: int) -> bool:
    """abs((int32)(uint32(a) - uint32(b))) < limit, reference quirk."""
    d = (int(a) - int(b)) & 0xFFFFFFFF
    if d >= 2**31:
        d -= 2**32
    return abs(d) < limit


def _push_cm(g: GraphTensors, pos: int, contig: int, coff: int, base: int,
             nxt: int, nitem: int) -> None:
    c = g.cm_cnt[pos]
    if c >= S_CM:
        g.dropped_cm += 1
        return
    g.cm_contig[pos, c] = contig
    g.cm_coff[pos, c] = coff & 0xFFFFFFFF
    g.cm_base[pos, c] = base
    g.cm_next[pos, c] = nxt & 0xFFFFFFFF
    g.cm_nitem[pos, c] = nitem & 0xFFFFFFFF
    g.cm_cnt[pos] += 1


def _push_cm_bulk(g: GraphTensors, pos: np.ndarray, contig: int,
                  coff: np.ndarray, base: np.ndarray, nxt: np.ndarray,
                  nitem: np.ndarray) -> None:
    """Vectorized push at distinct positions."""
    ok = g.cm_cnt[pos] < S_CM
    g.dropped_cm += int((~ok).sum())
    p = pos[ok]
    c = g.cm_cnt[p].astype(np.int64)
    g.cm_contig[p, c] = contig
    g.cm_coff[p, c] = coff[ok].astype(np.uint32)
    g.cm_base[p, c] = base[ok]
    g.cm_next[p, c] = nxt[ok].astype(np.uint32)
    g.cm_nitem[p, c] = nitem[ok].astype(np.uint32)
    g.cm_cnt[p] += 1


def build_contig_layer(g: GraphTensors, contigs: Contigs,
                       ali: ContigAlignments,
                       part_offset: int = 0) -> Dict[int, bool]:
    """Apply all contig placements of one part to the graph tensors.

    ali.target_* are global genome coordinates; part_offset converts to
    part-local positions.  Returns {chunk_id: outputted flag}.
    """
    # group placement indices per chunk, preserving aligner output order
    per_chunk: Dict[int, List[int]] = {}
    for i in range(ali.n):
        per_chunk.setdefault(int(ali.chunk_id[i]), []).append(i)

    outputted: Dict[int, bool] = {}
    for chunk, rows in per_chunk.items():
        chunk_seq = np.asarray(contigs.chunk_seq(chunk), np.int8)
        clen = len(chunk_seq)
        prior_base0: List[int] = []
        for r in rows:
            pm = ali.pos_map[r]
            pm_local = np.where(pm >= 0, pm - part_offset, -1).astype(np.int64)
            # Lossy --part cut (AlignGraph.cpp:3347-3418): the reference
            # aligns contigs against each part file separately, so an
            # alignment can never reach past the part end — bases beyond
            # the cut are simply unaligned.  Our demux assigns a global
            # placement to the part holding target_start; positions past
            # the boundary are masked to match that semantics (and to not
            # index past the part's tensors).
            pm_local = np.where((pm_local >= 0) & (pm_local < g.part_len),
                                pm_local, -1)
            base0 = pm_local[0] if pm_local[0] >= 0 else -1
            # (a) near-duplicate placement skip
            skip = any(_u32_absdiff_lt(base0, pb, clen) for pb in prior_base0)
            prior_base0.append(base0)
            if skip:
                continue
            # (b) >=2 ContiMers occupancy skip (all but last base)
            al = pm_local[:-1]
            alp = al[al >= 0]
            if np.any(g.cm_cnt[alp] >= 2):
                continue
            outputted[chunk] = True
            seq = _revcomp(chunk_seq) if ali.fr[r] else chunk_seq
            _apply_placement(g, chunk, seq, pm_local)
    return outputted


def _apply_placement(g: GraphTensors, sp: int, seq: np.ndarray,
                     pm: np.ndarray) -> None:
    n = len(pm)
    cur = pm[:-1]
    nxt = pm[1:]
    aligned = cur >= 0
    ordinary = aligned & (nxt == cur + 1)
    # events: aligned bases whose successor is not simply cur+1
    event_idx = np.nonzero(aligned & ~ordinary)[0]

    # nitem values are the PRE-placement ContiMer counts at the successor
    # (each position is pushed at most once per placement, monotone pos_map,
    # so the reference's "count at time of creation" == pre-placement count)
    snap = np.where(pm >= 0, g.cm_cnt[np.clip(pm, 0, None)], 0).astype(
        np.int64)

    # --- vectorized ordinary pushes ---
    oi = np.nonzero(ordinary)[0]
    if len(oi):
        pos = cur[oi]
        _push_cm_bulk(g, pos, sp, oi, seq[oi], pos + 1, snap[oi + 1])

    # --- events, fully vectorized (within one placement each position is
    # pushed at most once, so bulk pushes are order-safe; overflow blocks
    # are allocated in event order exactly like the sequential loop) ---
    ev = event_idx.astype(np.int64)
    if len(ev):
        ins_m = nxt[ev] < 0
        del_ev = ev[~ins_m]
        if len(del_ev):
            # deletion from genome (SD=0 -> always "large")
            _push_cm_bulk(g, cur[del_ev], sp, del_ev, seq[del_ev],
                          nxt[del_ev], snap[del_ev + 1])
        ins_ev = ev[ins_m]
        if len(ins_ev):
            # insertion to genome: next aligned base npp > i+1 (one
            # suffix scan instead of a per-event nonzero slice)
            big = np.int64(n + 1)
            rev = np.where(pm[::-1] >= 0,
                           np.arange(n - 1, -1, -1, dtype=np.int64), big)
            na = np.minimum.accumulate(rev)[::-1]
            na = np.concatenate([na, np.full(2, big)])
            npp = na[ins_ev + 2]
            ok = npp < n          # trailing unaligned run: no emission
            ins_ev, npp = ins_ev[ok], npp[ok]
        if len(ins_ev):
            m = npp - ins_ev - 2
            start0 = g.alloc_overflow(int((m + 1).sum()))
            offs = start0 + np.concatenate(
                [[0], np.cumsum(m + 1)[:-1]]).astype(np.int64)
            target = pm[npp]
            _push_cm_bulk(g, cur[ins_ev], sp, ins_ev, seq[ins_ev], offs,
                          np.zeros(len(ins_ev), np.int64))
            # middle inserted bases, flat across events
            if int(m.sum()):
                t_idx = np.repeat(np.arange(len(ins_ev)), m)
                j = (np.arange(len(t_idx), dtype=np.int64)
                     - np.repeat(np.concatenate(
                         [[0], np.cumsum(m)[:-1]]).astype(np.int64), m))
                o = offs[t_idx] + j
                si = ins_ev[t_idx] + 1 + j
                g.base[o] = seq[si]
                _push_cm_bulk(g, o, sp, si, seq[si], o + 1,
                              np.zeros(len(o), np.int64))
            oe = offs + m
            g.base[oe] = seq[npp - 1]
            _push_cm_bulk(g, oe, sp, npp - 1, seq[npp - 1], target,
                          snap[npp])

    # terminal ContiMer (AlignGraph.cpp:1121-1148).  The reference's
    # trailing nextID/nextOffset reduce to: the last base's position if
    # aligned, else -1; the fallback position is the last aligned base
    # processed by the loop (indices [0, n-2]).
    aligned_any = np.nonzero(pm[:-1] >= 0)[0]
    if len(aligned_any) == 0:
        return
    if pm[n - 1] >= 0:
        t = int(pm[n - 1])
        _push_cm(g, t, sp, n - 1, int(g.base[t]), NONE32, NONE32)
    else:
        cpos = int(cur[int(aligned_any[-1])])
        _push_cm(g, cpos, sp, n - 1, int(g.base[cpos]), NONE32, NONE32)


def initial_contigs(contigs: Contigs, outputted: Dict[int, bool]
                    ) -> List[Tuple[int, np.ndarray]]:
    """The reference's tmp/_initial_contigs grouping (AlignGraph.cpp:
    1188-1216): real contigs whose outputted-chunk fraction >= 0.5."""
    n_chunks_per_real: Dict[int, int] = {}
    out_per_real: Dict[int, int] = {}
    for c in range(contigs.n_chunks):
        r = int(contigs.chunk_real[c])
        n_chunks_per_real[r] = n_chunks_per_real.get(r, 0) + 1
        out_per_real[r] = out_per_real.get(r, 0) + int(
            bool(outputted.get(c, False)))
    result = []
    for r in sorted(n_chunks_per_real):
        if out_per_real[r] / n_chunks_per_real[r] >= CONTIG_THRESHOLD:
            result.append((r, contigs.seqs[r]))
    return result
