"""Read/k-mer-layer graph build — C18/C19 (`updateGenomeWithRead` +
`updateKMer`, AlignGraph.cpp:1635-1870, 1353-1624).

The reference's per-read-base `updateKMer` is a first-fit merge of
candidate k-mer annotations into per-position k-mer lists, with
`compatible()` (AlignGraph.cpp:1293-1312) deciding merges.  Tensorized
re-design (arrays + sort/segment ops, no per-base host loop):

  phase 0  normalize accepted pair records: orientation (revcomp the fr=1
           mate), leftmost-mate swap (AlignGraph.cpp:1672-1679), duplicate
           -placement skip (:1650-1655, uint32 quirk preserved)
  phase 1  tuple emission, vectorized over [records, bases]: ordinary /
           large-deletion / small-insertion cases exactly as
           AlignGraph.cpp:1681-1858 (SI=0/SD=0 build: small-indel branches
           dead; same-chromosome gaps always take the "small insertion"
           path chaining through intermediate genome positions)
  phase 2  candidate expansion: cross product of own-position ContiMers x
           mate-position ContiMers (up to 2x2; the contig layer caps
           occupancy at 2, AlignGraph.cpp:914)
  phase 3  exact grouping: rows with identical (pos, anchor signature)
           collapse into one group — first-fit decisions depend only on
           the signature (slots are append-only, anchors immutable), so
           grouping is lossless
  phase 4  first-fit merge via assign/create rounds: each round assigns
           every pending group to its first compatible slot (vectorized
           across positions), then the earliest pending group per
           position creates one new slot — reproducing the reference's
           sequential per-emission scan exactly; `compatible()`
           thresholds exact incl. the OPTIMIZATION cross-contig-join rule
  phase 5  edges: k1-candidate x k2-candidate pairs, slot-level dedup
           (`nextCompatible`) + the contig-anchor edge gate
           (AlignGraph.cpp:1600-1615; note: no genome-anchor clause there)

Coverage/votes: each k1 row contributes coverage 1 and a vote for its
string's first base (`updateKBases`); k2 rows only ensure the target slot
exists (coverage 0, no vote) — reference :1484-1506.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.config import EP
from aligngraph_tpu_torch.graph.model import E_ED, K_KM, NONE32, GraphTensors
from aligngraph_tpu_torch.io.formalize import Reads

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)
NONE = np.int64(-1)
CPO = 2             # own-ContiMer cross-product cap
CPM = 2             # mate-ContiMer cross-product cap


@dataclasses.dataclass
class KmerBuildStats:
    tuples: int = 0
    rows: int = 0
    groups: int = 0
    dropped_rank: int = 0     # always 0 since round 5 (the rank cap was
                              # removed with the exact first-fit rounds);
                              # kept for stats-schema stability
    dropped_slots: int = 0    # groups beyond K_KM slots
    dropped_edges: int = 0


def _pack(seqrows: np.ndarray) -> np.ndarray:
    """[N, k] int8 -> uint32 3-bit packed (codes 0-4 incl. N; k <= 10)."""
    n, k = seqrows.shape
    assert k <= 10, "k-mer size must be <= 10 (3-bit uint32 packing)"
    out = np.zeros(n, np.uint32)
    for i in range(k):
        c = seqrows[:, i].astype(np.uint32)
        out = (out << np.uint32(3)) | np.where(c > 4, 4, c)
    return out


def unpack_kmer(packed: int, length: int) -> np.ndarray:
    """uint32 3-bit packed -> int8 codes."""
    out = np.zeros(length, np.int8)
    p = int(packed)
    for i in range(length - 1, -1, -1):
        out[i] = p & 7
        p >>= 3
    return out


def normalize_records(pairs: PairAlignments, reads: Reads, k: int,
                      part_offset: int = 0, part_len: Optional[int] = None):
    """Phase 0: returns (p1, p2, s1, lens, keep_mask) with mate1 = leftmost.

    p1/p2: [M, L] int64 part-local positions (-1 unaligned);
    s1: [M, L] int8 oriented mate-1 (leftmost) sequence.
    """
    M = pairs.n
    L = pairs.pos_map.shape[2]
    lens = pairs.source_size[:, 0].astype(np.int64)
    p = pairs.pos_map.astype(np.int64)
    p = np.where(p >= 0, p - part_offset, -1)
    if part_len is not None:
        p = np.where((p >= 0) & (p < part_len), p, -1)
    # oriented sequences for both mates
    seqs = np.empty((M, 2, L), np.int8)
    for mate in (0, 1):
        raw = reads.data[2 * pairs.pair_id + mate]
        if raw.shape[1] < L:
            pad = np.full((M, L - raw.shape[1]), 4, np.int8)
            raw = np.concatenate([raw, pad], axis=1)
        rc = _COMP[raw[:, ::-1]]
        # left-align the revcomp of the length-l prefix
        sh = (L - lens)[:, None]
        idx = np.arange(L)[None, :] + sh
        rc_shifted = np.take_along_axis(rc, np.clip(idx, 0, L - 1), axis=1)
        rc_shifted = np.where(np.arange(L)[None, :] < lens[:, None],
                              rc_shifted, 4)
        seqs[:, mate] = np.where(pairs.fr[:, mate, None] == 1,
                                 rc_shifted, raw[:, :L])

    # duplicate-placement skip per pair (reference :1650-1655): a record is
    # dropped when ANY earlier record of the same pair (dropped or not —
    # the reference appends unconditionally) has |int32(b - pb)| < len.
    # Vectorized over (pair-group, rank): groups are the stable pair_id
    # sort runs, ranks are bounded by the aligner's -k cap, so a dense
    # [n_groups, max_rank] compare grid replaces the per-record loop.
    keep = np.ones(M, bool)
    if M:
        base0 = np.where(p[:, 0, 0] >= 0, p[:, 0, 0],
                         0xFFFFFFFF).astype(np.int64)
        order = np.argsort(pairs.pair_id, kind="stable")
        pid_s = pairs.pair_id[order]
        newg = np.ones(M, bool)
        newg[1:] = pid_s[1:] != pid_s[:-1]
        starts = np.nonzero(newg)[0]
        runlen = np.diff(np.concatenate([starts, [M]]))
        rank = np.arange(M) - np.repeat(starts, runlen)
        Rk = int(rank.max()) + 1
        ngrp = len(starts)
        gid = np.cumsum(newg) - 1
        b_d = np.zeros((ngrp, Rk), np.int64)
        l_d = np.zeros((ngrp, Rk), np.int64)
        b_d[gid, rank] = base0[order]
        l_d[gid, rank] = lens[order]
        drop_d = np.zeros((ngrp, Rk), bool)
        for r in range(1, Rk):
            d = (b_d[:, r:r + 1] - b_d[:, :r]) & 0xFFFFFFFF
            d[d >= 2**31] -= 2**32
            # ranks j < r always exist when rank r does (contiguous runs),
            # so no existence mask is needed
            hit = np.abs(d) < l_d[:, r:r + 1]
            drop_d[:, r] = hit.any(axis=1)
        keep[order] = ~drop_d[gid, rank]

    # orientation validity: exactly one fr (pairing guarantees it)
    keep &= pairs.fr[:, 0] != pairs.fr[:, 1]
    # both mates must touch this part
    keep &= (p[:, 0] >= 0).any(axis=1) & (p[:, 1] >= 0).any(axis=1)

    p1, p2 = p[:, 0], p[:, 1]
    s1, s2 = seqs[:, 0].copy(), seqs[:, 1].copy()
    # leftmost-mate swap: first index < len-k where both aligned and
    # m1 > m2 -> swap (reference :1672-1679)
    i_idx = np.arange(L)[None, :]
    both = (p1 >= 0) & (p2 >= 0) & (i_idx < (lens - k)[:, None])
    gt = both & (p1 > p2)
    lt = both & (p1 < p2)
    first_gt = np.where(gt.any(1), gt.argmax(1), L)
    first_lt = np.where(lt.any(1), lt.argmax(1), L)
    do_swap = first_gt < first_lt
    p1s = np.where(do_swap[:, None], p2, p1)
    p2s = np.where(do_swap[:, None], p1, p2)
    s1s = np.where(do_swap[:, None], s2, s1)
    return p1s, p2s, s1s, lens, keep


def emit_tuples(p1, p2, s1, lens, keep, k: int):
    """Phase 1: returns flat tuple arrays.

    Output dict of 1-D arrays (length T): cur, nxt, mate_cur, mate_nxt,
    s_pack, s_len, ns_pack, ns_len, arrival.
    """
    M, L = p1.shape
    i_idx = np.arange(L - k)[None, :]
    cur = p1[:, : L - k]
    nxt = p1[:, 1: L - k + 1]
    mc = p2[:, : L - k]
    mn = p2[:, 1: L - k + 1]
    in_range = keep[:, None] & (i_idx < (lens - k)[:, None]) & (cur >= 0)

    # next-aligned index from each position: na[j] = min index >= j aligned
    big = L + 1
    rev = np.where(p1[:, ::-1] >= 0, np.arange(L - 1, -1, -1)[None, :], big)
    na = np.minimum.accumulate(rev, axis=1)[:, ::-1]  # [M, L]
    na = np.concatenate([na, np.full((M, 2), big)], axis=1)
    npp = na[:, 2:][:, : L - k]                        # next aligned > i+1
    npp_ok = npp < L
    tgt = np.take_along_axis(p1, np.clip(npp, 0, L - 1), axis=1)
    mate_tgt = np.take_along_axis(p2, np.clip(npp, 0, L - 1), axis=1)

    ordinary = in_range & (nxt == cur + 1)
    deletion = in_range & (nxt >= 0) & (nxt != cur + 1)
    insertion = in_range & (nxt < 0) & npp_ok
    ins_a1 = insertion & (tgt == cur + 1)
    ins_a2 = insertion & (tgt != cur + 1)

    # jump masking: bases inside (i, npp) are unaligned already; nothing to do

    # packed k-mers at every base
    win = np.lib.stride_tricks.sliding_window_view(s1, k, axis=1)  # [M,L-k+1,k]
    packs = np.zeros((M, L), np.uint32)
    packs[:, : L - k + 1] = _pack(win.reshape(-1, k)).reshape(M, -1)

    rows = []

    def arr(rec, i, sub):
        return ((rec.astype(np.int64) * L + i) * 4 + sub)

    rr, ii = np.nonzero(ordinary | deletion)
    if len(rr):
        rows.append(dict(
            cur=cur[rr, ii], nxt=np.where(ordinary[rr, ii],
                                          cur[rr, ii] + 1, nxt[rr, ii]),
            mate_cur=mc[rr, ii], mate_nxt=mn[rr, ii],
            s_pack=packs[rr, ii], s_len=np.full(len(rr), k),
            ns_pack=packs[rr, ii + 1], ns_len=np.full(len(rr), k),
            s0=s1[rr, ii], ns0=s1[rr, ii + 1],
            arrival=arr(rr, ii, 0)))

    rr, ii = np.nonzero(ins_a1)
    if len(rr):
        np_i = npp[rr, ii]
        ns_len = np.minimum(np_i + k, lens[rr]) - np_i
        rows.append(dict(
            cur=cur[rr, ii], nxt=cur[rr, ii] + 1,
            mate_cur=mc[rr, ii], mate_nxt=mate_tgt[rr, ii],
            s_pack=packs[rr, ii], s_len=np.full(len(rr), k),
            ns_pack=packs[rr, np.clip(np_i, 0, L - 1)],
            ns_len=ns_len, s0=s1[rr, ii],
            ns0=s1[rr, np.clip(np_i, 0, L - 1)],
            arrival=arr(rr, ii, 0)))

    rr, ii = np.nonzero(ins_a2)
    if len(rr):
        np_i = npp[rr, ii]
        t = tgt[rr, ii]
        c = cur[rr, ii]
        # (i)  cur -> cur+1 with s, empty nextS, k2 anchors none
        rows.append(dict(
            cur=c, nxt=c + 1, mate_cur=mc[rr, ii],
            mate_nxt=np.full(len(rr), NONE),
            s_pack=packs[rr, ii], s_len=np.full(len(rr), k),
            ns_pack=np.zeros(len(rr), np.uint32),
            ns_len=np.zeros(len(rr), np.int64),
            s0=s1[rr, ii], ns0=np.full(len(rr), 4, np.int8),
            arrival=arr(rr, ii, 0)))
        # (ii) bridge tuples through intermediate genome positions
        br_cur, br_arr = [], []
        for rj, ij, cj, tj in zip(rr, ii, c, t):
            span = np.arange(cj + 1, tj - 1, dtype=np.int64)
            br_cur.append(span)
            br_arr.append(np.full(len(span), arr(np.int64(rj),
                                                 np.int64(ij), 1)))
        if br_cur:
            bc = np.concatenate(br_cur) if br_cur else np.zeros(0, np.int64)
            ba = np.concatenate(br_arr) if br_arr else np.zeros(0, np.int64)
            if len(bc):
                z = np.zeros(len(bc), np.int64)
                rows.append(dict(
                    cur=bc, nxt=bc + 1,
                    mate_cur=np.full(len(bc), NONE),
                    mate_nxt=np.full(len(bc), NONE),
                    s_pack=z.astype(np.uint32), s_len=z,
                    ns_pack=z.astype(np.uint32), ns_len=z,
                    s0=np.full(len(bc), 4, np.int8),
                    ns0=np.full(len(bc), 4, np.int8),
                    arrival=ba))
        # (iii) (target-1) -> target with empty s, nextS from npp
        ns_len = np.minimum(np_i + k, lens[rr]) - np_i
        rows.append(dict(
            cur=t - 1, nxt=t, mate_cur=np.full(len(rr), NONE),
            mate_nxt=mate_tgt[rr, ii],
            s_pack=np.zeros(len(rr), np.uint32),
            s_len=np.zeros(len(rr), np.int64),
            ns_pack=packs[rr, np.clip(np_i, 0, L - 1)], ns_len=ns_len,
            s0=np.full(len(rr), 4, np.int8),
            ns0=s1[rr, np.clip(np_i, 0, L - 1)],
            arrival=arr(rr, ii, 2)))

    if not rows:
        return None
    out = {key: np.concatenate([r[key] for r in rows])
           for key in rows[0]}
    order = np.argsort(out["arrival"], kind="stable")
    return {key: v[order] for key, v in out.items()}


def _expand_candidates(g: GraphTensors, pos, mate, arrival, kind,
                       s_pack, s_len, s0):
    """Phase 2: cross-product anchor candidates for one endpoint kind.

    Returns flat row dict + (tuple_index, combo_index) back-pointers.
    Flat formulation: per-tuple combo counts -> repeat/arange indices ->
    two slot gathers, instead of materializing dense [T, CPO, CPM] grids
    (which cost ~4x the flat row count in memory traffic)."""
    T = len(pos)
    posc = np.clip(pos, 0, g.n_pos - 1)
    c_cm = np.minimum(g.cm_cnt[posc], CPO).astype(np.int64)
    matec = np.clip(mate, 0, g.n_pos - 1)
    m_cm = np.where(mate >= 0, np.minimum(g.cm_cnt[matec], CPM), 0)
    n_own = np.maximum(c_cm, 1)       # 0 ContiMers -> one no-anchor cand
    n_mate = np.maximum(m_cm, 1)
    n_combo = n_own * n_mate
    t_idx = np.repeat(np.arange(T, dtype=np.int64), n_combo)
    off = np.zeros(T + 1, np.int64)
    np.cumsum(n_combo, out=off[1:])
    r = np.arange(len(t_idx), dtype=np.int64) - off[t_idx]
    nm_t = n_mate[t_idx]
    jj = r // nm_t
    jj0 = r - jj * nm_t
    own_has = c_cm[t_idx] > 0
    mate_has = m_cm[t_idx] > 0
    p_t = posc[t_idx]
    m_t = matec[t_idx]
    contig = np.where(own_has, g.cm_contig[p_t, jj].astype(np.int64), NONE)
    coff = np.where(own_has, g.cm_coff[p_t, jj].astype(np.int64), NONE)
    contig0 = np.where(mate_has, g.cm_contig[m_t, jj0].astype(np.int64),
                       NONE)
    coff0 = np.where(mate_has, g.cm_coff[m_t, jj0].astype(np.int64), NONE)
    gpos0 = mate[t_idx]
    return dict(
        pos=pos[t_idx], arrival=arrival[t_idx] * 2 + kind,
        weight=np.full(len(t_idx), 1 - kind, np.int64),
        s_pack=s_pack[t_idx], s_len=s_len[t_idx], s0=s0[t_idx],
        contig=contig, coff=coff,
        contig0=contig0, coff0=coff0,
        gpos0=np.where(gpos0 >= 0, gpos0, NONE),
        t_idx=t_idx, combo=jj * CPM + jj0)


def _pack_keys(keys):
    """Bit-pack int64 key fields (values >= -1) into as few int64 words
    as their runtime ranges allow; lexsort order is preserved (fields
    packed major-to-minor, each shifted by +1 to make -1 sortable).

    keys are ordered most-major LAST (np.lexsort convention); the
    returned tuple keeps that convention."""
    bits = []
    for kk in keys:
        mx = int(kk.max()) if len(kk) else 0
        bits.append(max(1, int(mx + 2).bit_length()))
    words: list = []
    used = 0
    cur = None
    # walk from most-major (last) to least-major so each word holds a
    # contiguous major-to-minor run
    for kk, b in zip(reversed(keys), reversed(bits)):
        if cur is None or used + b > 62:
            if cur is not None:
                words.append(cur)
            cur = kk + 1
            used = b
        else:
            cur = (cur << np.int64(b)) | (kk + 1)
            used += b
    if cur is not None:
        words.append(cur)
    # words[0] is most-major -> np.lexsort wants it LAST
    return tuple(reversed(words))


def _compat_vec(gc, gf, gc0, gf0, gg0, sc, sf, sc0, sf0, sg0, win):
    """Vectorized `compatible()` (AlignGraph.cpp:1293-1312), OPTIMIZATION
    build: incompatible only when same-id anchors are too far apart."""
    bad1 = (gc >= 0) & (sc >= 0) & (gc == sc) & (np.abs(gf - sf) > 5 * EP)
    bad2 = (gc0 >= 0) & (sc0 >= 0) & (gc0 == sc0) & (np.abs(gf0 - sf0) > win)
    bad3 = (gg0 >= 0) & (sg0 >= 0) & (np.abs(gg0 - sg0) > win)
    return ~(bad1 | bad2 | bad3)


def build_kmer_layer(g: GraphTensors, pairs: PairAlignments, reads: Reads,
                     k: int, insert_variation: int, part_offset: int = 0,
                     chunk_records: int = 16384,
                     stats: Optional[KmerBuildStats] = None
                     ) -> KmerBuildStats:
    """Apply all accepted pair alignments of one part to the k-mer layer."""
    st = stats or KmerBuildStats()
    if pairs.n == 0:
        return st
    p1, p2, s1, lens, keep = normalize_records(
        pairs, reads, k, part_offset, g.part_len)
    for s in range(0, pairs.n, chunk_records):
        e = min(s + chunk_records, pairs.n)
        tup = emit_tuples(p1[s:e], p2[s:e], s1[s:e], lens[s:e],
                          keep[s:e], k)
        if tup is None:
            continue
        _merge_chunk(g, tup, insert_variation, st)
    return st


def _merge_chunk(g: GraphTensors, tup, insert_variation: int,
                 st: KmerBuildStats) -> None:
    win = 2 * insert_variation + 5 * EP
    T = len(tup["cur"])
    st.tuples += T

    k1 = _expand_candidates(g, tup["cur"], tup["mate_cur"], tup["arrival"],
                            0, tup["s_pack"], tup["s_len"], tup["s0"])
    k2 = _expand_candidates(g, tup["nxt"], tup["mate_nxt"], tup["arrival"],
                            1, tup["ns_pack"], tup["ns_len"], tup["ns0"])
    rows = {key: np.concatenate([k1[key], k2[key]])
            for key in ("pos", "arrival", "weight", "s_pack", "s_len", "s0",
                        "contig", "coff", "contig0", "coff0", "gpos0")}
    n1 = len(k1["pos"])
    R = len(rows["pos"])
    st.rows += R
    if R == 0:
        return

    # ---- phase 3: exact grouping ----
    # arrival is the MOST-MINOR sort key: the first row of each sorted
    # group is its first-arrival representative (no ufunc.at reductions).
    # Keys are the EXACT anchor signature — rows with identical anchors
    # always make the same first-fit decision (slots are append-only and
    # slot anchors immutable, so "first compatible slot index" for a
    # given signature never changes), which keeps the grouped merge
    # bit-identical to the reference's per-emission scan
    # (AlignGraph.cpp:1375-1514).  The 6 group-key fields are bit-packed
    # into as few int64 words as their runtime ranges allow (usually 2).
    keys = (rows["gpos0"], rows["coff0"], rows["contig0"], rows["coff"],
            rows["contig"], rows["pos"])
    packed_keys = _pack_keys(keys)
    order = np.lexsort((rows["arrival"],) + packed_keys)
    sk = [kk[order] for kk in keys]
    newg = np.zeros(R, bool)
    newg[0] = True
    for kk in sk:
        newg[1:] |= kk[1:] != kk[:-1]
    gid_sorted = np.cumsum(newg) - 1
    G = int(gid_sorted[-1]) + 1
    st.groups += G
    gid = np.empty(R, np.int64)
    gid[order] = gid_sorted
    starts = np.nonzero(newg)[0]

    rep_row = order[starts]                 # first-arrival row per group
    g_first = rows["arrival"][rep_row]
    g_pos = rows["pos"][rep_row]
    g_weight = np.bincount(gid, weights=rows["weight"],
                           minlength=G).astype(np.int64)
    voters = (rows["s_len"] > 0) & (rows["weight"] > 0)
    g_votes = np.bincount(
        gid * 5 + rows["s0"].astype(np.int64),
        weights=voters.astype(np.int64), minlength=G * 5
    ).reshape(G, 5).astype(np.int64)

    def rep(name):
        return rows[name][rep_row]

    g_contig, g_coff = rep("contig"), rep("coff")
    g_contig0, g_coff0 = rep("contig0"), rep("coff0")
    g_gpos0 = rep("gpos0")
    g_spack, g_slen = rep("s_pack"), rep("s_len")

    # ---- phase 4: first-fit merge, assign/create rounds ----
    # Faithful vectorization of the reference's per-emission scan: each
    # round (a) assigns every still-pending group to its FIRST compatible
    # existing slot, then (b) lets the earliest-arrival pending group per
    # position create one new slot.  A pending group always arrives later
    # than any slot it sees (else it would have been that round's
    # creator), so the produced slot list and assignments equal the
    # sequential reference scan (AlignGraph.cpp:1375-1514).  Rounds are
    # bounded by the K_KM slot cap.
    g_slot = np.full(G, -1, np.int64)
    pending = np.lexsort((g_first, g_pos))  # (pos, arrival)-sorted groups
    for _round in range(K_KM + 2):
        if len(pending) == 0:
            break
        pos = g_pos[pending]
        kc = g.km_cnt[pos].astype(np.int64)
        # (a) compare pending groups against all K slots
        comp = np.zeros((len(pending), K_KM), bool)
        for slot in range(K_KM):
            sc = np.where(g.km_contig[pos, slot] == NONE32, NONE,
                          g.km_contig[pos, slot].astype(np.int64))
            sf = g.km_coff[pos, slot].astype(np.int64)
            sc0 = np.where(g.km_contig0[pos, slot] == NONE32, NONE,
                           g.km_contig0[pos, slot].astype(np.int64))
            sf0 = g.km_coff0[pos, slot].astype(np.int64)
            sg0 = np.where(g.km_mate[pos, slot] == NONE32, NONE,
                           g.km_mate[pos, slot].astype(np.int64))
            comp[:, slot] = (slot < kc) & _compat_vec(
                g_contig[pending], g_coff[pending], g_contig0[pending],
                g_coff0[pending], g_gpos0[pending], sc, sf, sc0, sf0,
                sg0, win)
        has = comp.any(axis=1)
        first = np.where(has, comp.argmax(axis=1), -1)
        # merge into existing slot (several groups may share one slot in
        # a round -> unbuffered adds)
        mi = np.nonzero(has)[0]
        if len(mi):
            mp, ms = pos[mi], first[mi]
            np.add.at(g.km_cov, (mp, ms),
                      g_weight[pending[mi]].astype(np.int32))
            np.add.at(g.km_votes, (mp, ms),
                      g_votes[pending[mi]].astype(np.int32))
            g_slot[pending[mi]] = ms
        rem = pending[~has]          # still (pos, arrival)-sorted
        if len(rem) == 0:
            break
        # (b) earliest pending group per position creates a slot;
        # capped positions drop all their pending groups (the reference
        # has no cap — drops are counted determinism diagnostics)
        posr = g_pos[rem]
        is_first = np.zeros(len(rem), bool)
        is_first[0] = True
        is_first[1:] = posr[1:] != posr[:-1]
        at_cap = g.km_cnt[posr].astype(np.int64) >= K_KM
        st.dropped_slots += int(at_cap.sum())
        pending = rem[~at_cap]
        crt = rem[is_first & ~at_cap]
        if len(crt):
            gi = crt
            ap = g_pos[gi]
            ac = g.km_cnt[ap].astype(np.int64)
            g.km_contig[ap, ac] = np.where(g_contig[gi] >= 0, g_contig[gi],
                                           NONE32).astype(np.uint32)
            g.km_coff[ap, ac] = (g_coff[gi] & 0xFFFFFFFF).astype(np.uint32)
            g.km_contig0[ap, ac] = np.where(g_contig0[gi] >= 0,
                                            g_contig0[gi],
                                            NONE32).astype(np.uint32)
            g.km_coff0[ap, ac] = (g_coff0[gi] & 0xFFFFFFFF).astype(np.uint32)
            g.km_mate[ap, ac] = np.where(g_gpos0[gi] >= 0, g_gpos0[gi],
                                         NONE32).astype(np.uint32)
            g.km_cov[ap, ac] = g_weight[gi].astype(np.int32)
            g.km_votes[ap, ac] = g_votes[gi].astype(np.int32)
            g.km_s[ap, ac] = g_spack[gi]
            g.km_slen[ap, ac] = g_slen[gi].astype(np.int8)
            g.km_cnt[ap] += 1
            g_slot[gi] = ac
            pending = pending[g_slot[pending] < 0]

    # ---- phase 5: edges ----
    # tuple t combo (j, j0): row index in k1/k2 block; need slot per row
    row_slot = np.full(R, -1, np.int64)
    vmask = g_slot[gid] >= 0
    row_slot[vmask] = g_slot[gid[vmask]]
    k1_slot = row_slot[:n1]
    k2_slot = row_slot[n1:]
    # edge candidates: for each tuple, every (k1 row of t) x (k2 row of t)
    t1 = k1["t_idx"]
    t2 = k2["t_idx"]
    # build per-tuple row lists via sorted positions
    # (small combo grid: regroup with searchsorted)
    e_src_list, e_dst_list, e_arr_list = [], [], []
    o1 = np.argsort(t1, kind="stable")
    o2 = np.argsort(t2, kind="stable")
    st1 = np.searchsorted(t1[o1], np.arange(T))
    en1 = np.searchsorted(t1[o1], np.arange(T), side="right")
    st2 = np.searchsorted(t2[o2], np.arange(T))
    en2 = np.searchsorted(t2[o2], np.arange(T), side="right")
    c1 = en1 - st1
    c2 = en2 - st2
    # expand pairs (c1*c2 per tuple, both <= CPO*CPM=4)
    maxc = CPO * CPM
    for a in range(maxc):
        for b in range(maxc):
            sel = np.nonzero((c1 > a) & (c2 > b))[0]
            if len(sel) == 0:
                continue
            r1 = o1[st1[sel] + a]
            r2 = o2[st2[sel] + b]
            e_src_list.append(r1)
            e_dst_list.append(r2)
            e_arr_list.append(tup["arrival"][sel] * maxc * maxc
                              + a * maxc + b)
    if not e_src_list:
        return
    er1 = np.concatenate(e_src_list)
    er2 = np.concatenate(e_dst_list)
    ea = np.concatenate(e_arr_list)
    ok = (k1_slot[er1] >= 0) & (k2_slot[er2] >= 0)
    er1, er2, ea = er1[ok], er2[ok], ea[ok]
    src_pos = k1["pos"][er1]
    src_slot = k1_slot[er1]
    dst_pos = k2["pos"][er2]
    dst_slot = k2_slot[er2]
    # dedup new edges by (src_pos, src_slot, dst_pos, dst_slot), keep
    # first arrival order
    eorder = np.lexsort(
        (ea,) + _pack_keys((dst_slot.astype(np.int64),
                            dst_pos.astype(np.int64),
                            src_slot.astype(np.int64),
                            src_pos.astype(np.int64))))
    sp_, ss_, dp_, ds_ = (src_pos[eorder], src_slot[eorder],
                          dst_pos[eorder], dst_slot[eorder])
    uniq = np.zeros(len(sp_), bool)
    if len(sp_):
        uniq[0] = True
        uniq[1:] = ((sp_[1:] != sp_[:-1]) | (ss_[1:] != ss_[:-1])
                    | (dp_[1:] != dp_[:-1]) | (ds_[1:] != ds_[:-1]))
    sp_, ss_, dp_, ds_ = sp_[uniq], ss_[uniq], dp_[uniq], ds_[uniq]
    ea_u = ea[eorder][uniq]

    # edge gate (AlignGraph.cpp:1600-1615): contig-anchor clauses between
    # the two SLOT kmers (no genome-anchor clause)
    def slotv(arr, p, s):
        v = arr[p, s].astype(np.int64)
        return np.where(arr[p, s] == NONE32, NONE, v)

    a_c = slotv(g.km_contig, sp_, ss_)
    a_f = g.km_coff[sp_, ss_].astype(np.int64)
    a_c0 = slotv(g.km_contig0, sp_, ss_)
    a_f0 = g.km_coff0[sp_, ss_].astype(np.int64)
    b_c = slotv(g.km_contig, dp_, ds_)
    b_f = g.km_coff[dp_, ds_].astype(np.int64)
    b_c0 = slotv(g.km_contig0, dp_, ds_)
    b_f0 = g.km_coff0[dp_, ds_].astype(np.int64)
    bad1 = (a_c >= 0) & (b_c >= 0) & (a_c == b_c) & \
        (np.abs(a_f - b_f) > 5 * EP)
    bad2 = (a_c0 >= 0) & (b_c0 >= 0) & (a_c0 == b_c0) & \
        (np.abs(a_f0 - b_f0) > win)
    gate = ~(bad1 | bad2)
    sp_, ss_, dp_, ds_, ea_u = (sp_[gate], ss_[gate], dp_[gate], ds_[gate],
                                ea_u[gate])

    # check against existing edges, then append in arrival order
    aorder = np.lexsort((ea_u, ss_, sp_))
    sp_, ss_, dp_, ds_ = sp_[aorder], ss_[aorder], dp_[aorder], ds_[aorder]
    exists = np.zeros(len(sp_), bool)
    for e in range(E_ED):
        exists |= (e < g.ed_cnt[sp_, ss_]) & \
            (g.ed_pos[sp_, ss_, e] == dp_.astype(np.uint32)) & \
            (g.ed_item[sp_, ss_, e] == ds_.astype(np.uint8))
    sp_, ss_, dp_, ds_ = sp_[~exists], ss_[~exists], dp_[~exists], \
        ds_[~exists]
    if len(sp_) == 0:
        return
    # vectorized append: per-(pos,slot) run rank -> target edge index
    # (arrays are sorted by (pos, slot, arrival))
    same_ps = np.zeros(len(sp_), bool)
    same_ps[1:] = (sp_[1:] == sp_[:-1]) & (ss_[1:] == ss_[:-1])
    starts = np.nonzero(~same_ps)[0]
    runlen = np.diff(np.concatenate([starts, [len(sp_)]]))
    rrank = np.arange(len(sp_)) - np.repeat(starts, runlen)
    eidx = g.ed_cnt[sp_, ss_].astype(np.int64) + rrank
    ok = eidx < E_ED
    st.dropped_edges += int((~ok).sum())
    g.ed_pos[sp_[ok], ss_[ok], eidx[ok]] = dp_[ok].astype(np.uint32)
    g.ed_item[sp_[ok], ss_[ok], eidx[ok]] = ds_[ok].astype(np.uint8)
    np.add.at(g.ed_cnt, (sp_[starts], ss_[starts]),
              np.minimum(runlen, E_ED - np.minimum(
                  g.ed_cnt[sp_[starts], ss_[starts]], E_ED)).astype(np.int8))
