"""SAM / PSL text emission from in-engine alignment records.

These writers produce exactly the fields the reference's parsers consume
(`parseBOWTIE` AlignGraph.cpp:181-285, `parseBLAT` :406-522), so the
reference binary can be driven by our engine through shim aligner
executables (see compat/bowtie2_cli.py, compat/blat_cli.py) — the basis
of the golden-parity harness (tests/test_golden_parity.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from aligngraph_tpu_torch.align.types import ContigAlignments, PairAlignments


def segments_of(pos_map: np.ndarray) -> List[Tuple[int, int, int]]:
    """pos_map row -> gapless M-blocks [(src_start, tgt_start, size)]."""
    pm = np.asarray(pos_map, np.int64)
    aligned = pm >= 0
    if not aligned.any():
        return []
    prev_a = np.concatenate([[False], aligned[:-1]])
    prev_p = np.concatenate([[-2], pm[:-1]])
    start = aligned & (~prev_a | (pm != prev_p + 1))
    segs = []
    for i in np.nonzero(start)[0]:
        j = i
        while j + 1 < len(pm) and aligned[j + 1] and pm[j + 1] == pm[j] + 1:
            j += 1
        segs.append((int(i), int(pm[i]), int(j - i + 1)))
    return segs


def _cigar(segs, qlen: int) -> str:
    """M-blocks -> CIGAR with leading/trailing soft clips and I/D gaps."""
    out = []
    ss = segs[0][0]
    if ss:
        out.append(f"{ss}S")
    for k, (src, tgt, size) in enumerate(segs):
        if k:
            psrc, ptgt, psize = segs[k - 1]
            di = src - (psrc + psize)
            dd = tgt - (ptgt + psize)
            if di > 0:
                out.append(f"{di}I")
            if dd > 0:
                out.append(f"{dd}D")
        out.append(f"{size}M")
    end = segs[-1][0] + segs[-1][2]
    if qlen - end:
        out.append(f"{qlen - end}S")
    return "".join(out)


def _locate(gpos: int, rec_starts: np.ndarray) -> Tuple[int, int]:
    """Global concatenated-axis position -> (record id, local offset)."""
    r = int(np.searchsorted(rec_starts, gpos, side="right")) - 1
    return r, gpos - int(rec_starts[r])


def sam_lines(pairs: PairAlignments, n_pairs: int, rec_ids: List[str],
              rec_starts: np.ndarray) -> List[str]:
    """PairAlignments (raw, C13 off) -> SAM body in bowtie2 -k layout:
    per pair, each reported pair-alignment is two consecutive lines
    (mate 1, mate 2); unaligned pairs emit one `*` line per mate
    (what `loadReadAli` expects, AlignGraph.cpp:1243-1258)."""
    lines: List[str] = []
    by_pair: dict = {}
    for r in range(pairs.n):
        by_pair.setdefault(int(pairs.pair_id[r]), []).append(r)
    for p in range(n_pairs):
        rows = by_pair.get(p, [])
        if not rows:
            for mate in (0, 1):
                flag = 0x1 | 0x4 | 0x8 | (0x40 if mate == 0 else 0x80)
                lines.append(f"{p}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t*\t*")
            continue
        for r in rows:
            for mate in (0, 1):
                fr = int(pairs.fr[r, mate])
                ofr = int(pairs.fr[r, 1 - mate])
                flag = (0x1 | 0x2 | (0x40 if mate == 0 else 0x80)
                        | (0x10 if fr else 0) | (0x20 if ofr else 0))
                segs = segments_of(pairs.pos_map[r, mate])
                qlen = int(pairs.source_size[r, mate])
                rid, loc = _locate(segs[0][1], rec_starts)
                cig = _cigar(
                    [(s, t - int(rec_starts[rid]), z) for s, t, z in segs],
                    qlen)
                lines.append(
                    f"{p}\t{flag}\t{rec_ids[rid]}\t{loc + 1}\t255\t{cig}"
                    f"\t=\t0\t0\t*\t*")
    return lines


def psl_lines(ali: ContigAlignments, chunk_ids: List[str],
              rec_ids: List[str], rec_starts: np.ndarray,
              rec_lens: np.ndarray) -> List[str]:
    """ContigAlignments -> headerless PSL rows (the 21 standard columns;
    the reference consumes items 5,7,8,9,10,11,12,13,14,15,16,18,19,20)."""
    lines: List[str] = []
    for r in range(ali.n):
        pm = ali.pos_map[r]
        segs = segments_of(pm)
        if not segs:
            continue
        fr = int(ali.fr[r])
        size = int(ali.source_size[r])
        ss, se = int(ali.source_start[r]), int(ali.source_end[r])
        rid, t0 = _locate(segs[0][1], rec_starts)
        base = int(rec_starts[rid])
        m = sum(z for _, _, z in segs)
        q_ins = int(ali.source_gap[r])
        t_ins = int(ali.target_gap[r])
        # cols 11/12 are forward-strand query coords; block qStarts
        # (col 19) stay in aligned-orientation coords (PSL convention)
        q_start, q_end = (size - se, size - ss) if fr else (ss, se)
        bs = ",".join(str(z) for _, _, z in segs) + ","
        qs = ",".join(str(s) for s, _, _ in segs) + ","
        ts = ",".join(str(t - base) for _, t, _ in segs) + ","
        lines.append("\t".join(map(str, [
            m, 0, 0, 0,
            0, q_ins, 0, t_ins,
            "-" if fr else "+",
            chunk_ids[r],
            size, q_start, q_end,
            rec_ids[rid], int(rec_lens[rid]),
            int(ali.target_start[r]) - base,
            int(ali.target_end[r]) - base,
            len(segs), bs, qs, ts,
        ])))
    return lines


def delta_lines(ali: ContigAlignments, chunk_ids: List[str],
                chunk_sizes: List[int], rec_ids: List[str],
                rec_starts: np.ndarray, rec_lens: np.ndarray) -> List[str]:
    """ContigAlignments -> NUCMER .delta body as the reference's
    `delta2psl` reader consumes it (AlignGraph.cpp:588-729): a
    `>tname qname tlen qlen` header per record, a 1-based inclusive
    coordinate line `tStart tEnd sStart sEnd` (sStart > sEnd encodes the
    reverse strand; after the reader's swap the walked source positions
    are aligned-orientation coords, matching our pos_map and the PSL
    qStarts convention), then signed indel offsets: each value b emits
    |b|-1 M columns followed by an I (b > 0, target-only) or D (b < 0,
    source-only) column; trailing M columns are implicit; 0 terminates."""
    lines: List[str] = []
    for r in range(ali.n):
        pm = np.asarray(ali.pos_map[r], np.int64)
        aligned = np.nonzero(pm >= 0)[0]
        if len(aligned) == 0:
            continue
        fr = int(ali.fr[r])
        ss, se = int(aligned[0]), int(aligned[-1]) + 1
        rid, t0 = _locate(int(pm[aligned[0]]), rec_starts)
        base = int(rec_starts[rid])
        t_lo = int(pm[aligned[0]]) - base
        t_hi = int(pm[aligned[-1]]) - base
        qname = chunk_ids[r]
        qlen = int(chunk_sizes[r])
        lines.append(f">{rec_ids[rid]} {qname} {int(rec_lens[rid])} "
                     f"{qlen}")
        if fr:
            coords = f"{t_lo + 1} {t_hi + 1} {se} {ss + 1}"
        else:
            coords = f"{t_lo + 1} {t_hi + 1} {ss + 1} {se}"
        lines.append(coords)
        # M/I/D column walk over [ss, se)
        m_run = 0
        prev_t = int(pm[ss])
        m_run = 1
        for i in range(ss + 1, se):
            t = int(pm[i])
            if t < 0:                       # source-only column: D
                lines.append(str(-(m_run + 1)))
                m_run = 0
                continue
            gap = t - prev_t - 1
            for _ in range(gap):            # target-only columns: I
                lines.append(str(m_run + 1))
                m_run = 0
            prev_t = t
            m_run += 1
        lines.append("0")
    return lines
