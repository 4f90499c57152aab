"""Coverage filter + traversal + merge + scaffold — C20-C23
(`filterLowCoverage` AlignGraph.cpp:1904-1918, `extdContigs1` :1954-2204,
`extdContigs2` :2296-2386, `scaffoldContigs` :2396-2464).

The walk is the reference's exact state machine (k-mer nodes alternating
with ContiMer chains, unique-untraversed-successor following, consensus
base voting with A>C>G>T>N tie priority, `contain` dedup vs the previous
output, and the >100kb skip-ahead heuristic).  This module holds the
pure-Python reference implementation; `aligngraph_tpu_torch.native` provides a
C++ drop-in for the same walk (same arrays in, same outputs).

All anchor offsets use uint32 semantics; the endOffset0 += k-1 wraparound
on -1 anchors (AlignGraph.cpp:2171) is preserved because scaffolding's
`overlap()` arithmetic (AlignGraph.cpp:2388-2394) observes it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from aligngraph_tpu_torch.graph.model import NONE32, GraphTensors
from aligngraph_tpu_torch.graph.kmer_layer import unpack_kmer

U32 = 0xFFFFFFFF
NONEI = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= U32
    return x - 2**32 if x >= 2**31 else x


@dataclasses.dataclass
class PreContig:
    """One pre-extended contig (reference `Contig`, AlignGraph.cpp:123-139;
    header format of tmp/_pre_extended_contigs, :2178)."""
    seq: bytearray            # int8 codes
    extended: int
    start_id: int             # uint32 domain (0 or NONEI)
    start_off: int
    end_id: int
    end_off: int
    start0_id: int
    start0_off: int
    end0_id: int
    end0_off: int


def filter_low_coverage(g: GraphTensors, coverage: int) -> None:
    """C20: read-only k-mers below coverage are pruned (marked traversed)."""
    slot = np.arange(g.km_trav.shape[1])[None, :]
    valid = slot < g.km_cnt[:, None]
    mask = valid & (g.km_contig == NONE32) & (g.km_cov < coverage)
    g.km_trav[mask] = 1


_VOTE_PRIORITY = [0, 1, 2, 3, 4]   # A > C > G > T > N on ties


def _consensus(votes: np.ndarray, genome_base: int) -> int:
    if not votes.any():
        return int(genome_base)   # 'X' fallback (AlignGraph.cpp:1997-2001)
    best, bv = 0, -1
    for b in _VOTE_PRIORITY:
        v = int(votes[b])
        if v > bv:
            best, bv = b, v
    return best


def extd_contigs1(g: GraphTensors, coverage: int, k: int
                  ) -> List[PreContig]:
    """C21: genome-order scan starting walks at untraversed k-mers."""
    filter_low_coverage(g, coverage)
    out: List[PreContig] = []
    bak = dict(sid=NONEI, soff=NONEI, eid=NONEI, eoff=NONEI)
    N = g.n_pos
    cp = 0
    while cp < N:
        for ip in range(int(g.km_cnt[cp])):
            if g.km_trav[cp, ip]:
                continue
            ctg = _walk(g, cp, ip, k)
            if not _contain(bak["sid"], bak["soff"], bak["eid"],
                            bak["eoff"], ctg.start_id, ctg.start_off,
                            ctg.end_id, ctg.end_off):
                out.append(ctg)
                bak = dict(sid=ctg.start_id, soff=ctg.start_off,
                           eid=ctg.end_id, eoff=ctg.end_off)
        # skip-ahead heuristic (AlignGraph.cpp:2194-2202)
        if (bak["eoff"] - bak["soff"]) & U32 > 100000 and \
                bak["eid"] != NONEI:
            if bak["eid"] == 0 and cp + 1000 < bak["eoff"]:
                cp += 1000
            else:
                cp += 1
        else:
            cp += 1
    return out


def _contain(s1, so1, e1, eo1, s2, so2, e2, eo2) -> bool:
    """reference `contain` (AlignGraph.cpp:1897-1902), unsigned compares."""
    return (s1 == s2 and e1 == e2 and (so1 & U32) <= (so2 & U32)
            and (eo1 & U32) >= (eo2 & U32))


def _walk(g: GraphTensors, cp: int, ip: int, k: int) -> PreContig:
    cpp, ipp = cp, ip
    tag = 1
    seq = bytearray()
    extended = 0
    start0 = int(g.km_mate[cp, ip])
    ctg = PreContig(
        seq=seq, extended=0,
        start_id=0, start_off=cp,
        end_id=NONEI, end_off=NONEI,
        start0_id=0 if start0 != NONEI else NONEI, start0_off=start0,
        end0_id=NONEI, end0_off=NONEI)
    s_bak_pack, s_bak_len = 0, 0
    cpp_bak, ipp_bak = cpp, ipp

    while (tag == 1 and not g.km_trav[cpp, ipp]) or tag == 0:
        if tag == 0:
            seq.append(int(g.cm_base[cpp, ipp]))
            extended = 1
        else:
            b = _consensus(g.km_votes[cpp, ipp], g.base[cpp])
            seq.append(b)
            if g.km_coff[cpp, ipp] != NONE32:
                extended = 1

        if tag == 1:
            g.km_trav[cpp, ipp] = 1
            s_bak_pack = int(g.km_s[cpp, ipp])
            s_bak_len = int(g.km_slen[cpp, ipp])
            # count untraversed successors
            n_count, nxt = 0, -1
            for e in range(int(g.ed_cnt[cpp, ipp])):
                tp = int(g.ed_pos[cpp, ipp, e])
                ti = int(g.ed_item[cpp, ipp, e])
                if tp != NONEI and not g.km_trav[tp, ti]:
                    n_count += 1
                    nxt = e
            if n_count == 1:
                cpp_bak = int(g.ed_pos[cpp, ipp, nxt])
                ipp_bak = int(g.ed_item[cpp, ipp, nxt])
                cpp, ipp = cpp_bak, ipp_bak
                tag = 1
            elif g.cm_cnt[cpp] == 1 and g.cm_next[cpp, 0] != NONE32:
                cpp_bak = int(g.cm_next[cpp, 0])
                ipp_bak = int(g.cm_nitem[cpp, 0])
                cpp, ipp = cpp_bak, ipp_bak
                tag = 0
            else:
                tag = -1
        else:
            if g.cm_next[cpp, ipp] != NONE32:
                cpp_bak = int(g.cm_next[cpp, ipp])
                ipp_bak = int(g.cm_nitem[cpp, ipp])
                cpp, ipp = cpp_bak, ipp_bak
                tag = 0
            else:
                # ContiMer chain end: through the single untraversed k-mer
                count, item = 0, -1
                for i3 in range(int(g.km_cnt[cpp])):
                    if not g.km_trav[cpp, i3]:
                        count += 1
                        item = i3
                n_count, nxt = 0, -1
                if count == 1:
                    for e in range(int(g.ed_cnt[cpp, item])):
                        tp = int(g.ed_pos[cpp, item, e])
                        ti = int(g.ed_item[cpp, item, e])
                        if tp != NONEI and not g.km_trav[tp, ti]:
                            n_count += 1
                            nxt = e
                if n_count == 1:
                    cpp_bak = int(g.ed_pos[cpp, item, nxt])
                    ipp_bak = int(g.ed_item[cpp, item, nxt])
                    cpp, ipp = cpp_bak, ipp_bak
                    tag = 1 if not g.km_trav[cpp, ipp] else -2
                else:
                    tag = -2

    # end coordinates (AlignGraph.cpp:2142-2162)
    if tag == 1:
        ctg.end_id, ctg.end_off = 0, cpp_bak
    else:
        ctg.end_id, ctg.end_off = 0, cpp
    if tag in (1, -1):
        m = int(g.km_mate[cpp, ipp])
        ctg.end0_id = 0 if m != NONEI else NONEI
        ctg.end0_off = m
    else:
        ctg.end0_id, ctg.end0_off = NONEI, NONEI
    if tag in (1, -1):
        if s_bak_len > 1:
            seq.extend(unpack_kmer(s_bak_pack, s_bak_len)[1:])
        ctg.end_off = (ctg.end_off + max(s_bak_len - 1, 0)) & U32
        ctg.end0_off = (ctg.end0_off + max(s_bak_len - 1, 0)) & U32
    ctg.extended = extended
    ctg.seq = seq
    return ctg


def extd_contigs2(contigs: List[PreContig]) -> None:
    """C22: containment sweeps + unique-successor joins (in place)."""
    n = len(contigs)
    # forward containment sweep
    for cp in range(n):
        if contigs[cp].extended != 1:
            continue
        for cpp in range(cp + 1, n):
            if _contain(contigs[cp].start_id, contigs[cp].start_off,
                        contigs[cp].end_id, contigs[cp].end_off,
                        contigs[cpp].start_id, contigs[cpp].start_off,
                        contigs[cpp].end_id, contigs[cpp].end_off):
                contigs[cpp].extended = 2
            elif contigs[cp].end_id != contigs[cpp].start_id or \
                    (contigs[cp].end_off & U32) < \
                    (contigs[cpp].start_off & U32):
                break
    # backward sweep
    for cp in range(n - 1, -1, -1):
        if contigs[cp].extended != 1:
            continue
        for cpp in range(cp - 1, -1, -1):
            if _contain(contigs[cp].start_id, contigs[cp].start_off,
                        contigs[cp].end_id, contigs[cp].end_off,
                        contigs[cpp].start_id, contigs[cpp].start_off,
                        contigs[cpp].end_id, contigs[cpp].end_off):
                contigs[cpp].extended = 2
            elif contigs[cpp].end_id != contigs[cp].start_id or \
                    (contigs[cpp].end_off & U32) < \
                    (contigs[cp].start_off & U32):
                break
    # join pass (AlignGraph.cpp:2342-2378)
    for cp in range(n):
        while contigs[cp].extended == 1:
            buf = []
            for cpp in range(cp + 1, n):
                if contigs[cpp].extended == 2:
                    continue
                if (contigs[cp].end_off & U32) >= \
                        (contigs[cpp].start_off & U32):
                    buf.append(cpp)
                elif (contigs[cp].end_off & U32) < \
                        (contigs[cpp].start_off & U32):
                    break
            if len(buf) != 1:
                break
            j = buf[0]
            contigs[j].extended = 2
            cut = (contigs[cp].end_off - contigs[j].start_off + 1) & U32
            if cut < len(contigs[j].seq):
                contigs[cp].seq.extend(contigs[j].seq[cut:])
            contigs[cp].end_id = contigs[j].end_id
            contigs[cp].end_off = contigs[j].end_off
            contigs[cp].end0_id = contigs[j].end0_id
            contigs[cp].end0_off = contigs[j].end0_off


def _overlap(x1, y1, x2, y2) -> bool:
    """reference `overlap` (AlignGraph.cpp:2388-2394): unsigned compares,
    int32-cast differences."""
    x1, y1, x2, y2 = x1 & U32, y1 & U32, x2 & U32, y2 & U32
    return bool(
        (x1 <= x2 <= y1 <= y2 and _i32(y1) - _i32(x2) > 0)
        or (x2 <= x1 <= y2 <= y1 and _i32(y2) - _i32(x1) > 0)
        or (x1 <= x2 <= y2 <= y1 and _i32(y2) - _i32(x2) > 0)
        or (x2 <= x1 <= y1 <= y2 and _i32(y1) - _i32(x1) > 0))


def scaffold_contigs(g: GraphTensors, contigs: List[PreContig]
                     ) -> List[np.ndarray]:
    """C23: PE-anchor scaffolding with >=50%-covered reference gap fill."""
    scaffolds: List[bytearray] = []
    n = len(contigs)
    # NOTE: the reference reuses the loop variable for joins (cp = cp0,
    # AlignGraph.cpp:2440), so after a join the outer loop resumes from the
    # last joined contig + 1 — unconsumed contigs in the jumped-over range
    # never start scaffolds.  Preserved exactly.
    cp = -1
    while cp + 1 < n:
        cp += 1
        c = contigs[cp]
        if c.start_id == NONEI or c.extended != 1:
            continue
        cur = bytearray(c.seq)
        c.start_id = NONEI   # consume
        cont = True
        while contigs[cp].start0_id == contigs[cp].end0_id and cont:
            cont = False
            for cp0 in range(cp + 1, n):
                c0 = contigs[cp0]
                if (cp0 != cp and contigs[cp].end0_id == c0.start_id
                        and c0.start_id == c0.end_id
                        and _overlap(contigs[cp].start0_off,
                                     contigs[cp].end0_off,
                                     c0.start_off, c0.end_off)
                        and c0.extended == 1):
                    e_off = contigs[cp].end_off & U32
                    s_off = c0.start_off & U32
                    if s_off > e_off:
                        gap = s_off - e_off - 1
                        covered = 0
                        for i in range(gap):
                            p = e_off + i + 1
                            if p < g.n_pos and (g.km_cnt[p] > 0
                                                or g.cm_cnt[p] > 0):
                                covered += 1
                        if gap != 0 and covered / gap >= 0.5 or gap == 0:
                            for i in range(gap):
                                p = e_off + i + 1
                                cur.append(int(g.base[p]) if p < g.n_pos
                                           else 4)
                        else:
                            continue
                    cur.extend(c0.seq)
                    c0.start_id = NONEI
                    cp = cp0
                    cont = True
                    break
        scaffolds.append(cur)
    return [np.frombuffer(bytes(s), dtype=np.int8) for s in scaffolds]


def extd_contigs1_dispatch(g: GraphTensors, coverage: int, k: int,
                           force_python: bool = False) -> List[PreContig]:
    """Prefer the C++ native walk (identical semantics, ~1000x faster);
    fall back to the Python oracle."""
    if not force_python:
        try:
            from aligngraph_tpu_torch import native
            out = native.extd_contigs1_native(g, coverage, k)
            if out is not None:
                return out
        except Exception:
            pass
    return extd_contigs1(g, coverage, k)


def extend_and_scaffold(g: GraphTensors, coverage: int, k: int,
                        force_python: bool = False, pre_snapshot=None):
    """C21+C22+C23 composed (reference `extendContigs` + `scaffoldContigs`).

    Returns (scaffold sequences, pre-extended contig list).  The
    reference writes tmp/_pre_extended_contigs DURING pass 1, before the
    merge pass mutates extended flags / splices suffixes — pass a list
    as `pre_snapshot` to receive pass-1-state copies for that artifact."""
    pre = extd_contigs1_dispatch(g, coverage, k, force_python=force_python)
    if pre_snapshot is not None:
        pre_snapshot.extend(
            dataclasses.replace(c, seq=bytearray(c.seq)) for c in pre)
    extd_contigs2(pre)
    scaffolds = scaffold_contigs(g, pre)
    return scaffolds, pre
