"""In-engine PE short-read aligner (the bowtie2 replacement), PyTorch port.

Counterpart of aligngraph_tpu/align/read_aligner.py; its output equals the
JAX ReadAligner.align field by field.  Reference invocation replaced
(AlignGraph.cpp:3601-3609):
  bowtie2 -f --no-mixed -k 5 --local --mp 3,1 --rdg 2,1 --rfg 2,1
          --score-min G,5,2 -I distanceLow -X distanceHigh
          --no-discordant --reorder

Per batch of P pairs, on the aligner's device:
  1. both orientations of every mate (revcomp_padded)
  2. seed lookup in the canonical k-mer genome index (ops/seeding.py)
  3. candidate diagonals by clustered seed votes, then a rank-major
     validity compaction to TOP rows
  4. banded affine local SW + traceback (ops/banded_sw.py; the CUDA
     kernels for CUDA tensors)
  5. per-candidate parse quantities (parseBOWTIE equivalents)
  6. PE pairing: opposite strands, facing orientation, fragment length in
     [distanceLow, distanceHigh], per-mate score >= 5 + 2*ln(len), top-K
     pairs by combined score, deterministic tie-break (fragment start)
  7. the C13 ratio filter (c13_mask), then the accepted records compacted
     into one int32 buffer: dense per pair (pack_dense) when L <= 255 and
     distance_high <= 32,000, else per slot (pack_records)
  8. the buffer's decode (unpack_dense + _expand_dense, or unpack_records
     + _expand_packed: fixed capacities, the records in (pair, k) order,
     the parse quantities and pos_map rebuilt from the M-block segments)
     into one int32 block of record rows, header first (count, overflow
     flag; _row_table), and the block's copy into pinned host memory
and on the host only the wait for the block, the copy of its records out
(_copy_out) and the batches' concatenation.  A batch whose records
overflow the buffer's capacities is decoded again on the device from the
full [P, K] layout (_expand_full), which stays there until its flag is
read, and its records come down in a second block.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.utils import spans
from aligngraph_tpu_torch.utils.hostmem import tune_host_malloc
from aligngraph_tpu_torch.ops.banded_sw import banded_sw_posmap_auto
from aligngraph_tpu_torch.ops.seeding import (
    INVALID_DIAG, SeedIndex, build_index, lookup_seeds_bucketed,
    pack_query_seeds, rc_packed, select_candidates, sort_pairs,
)

SCORE_MIN_CONST = 5.0   # bowtie2 --score-min G,5,2
SCORE_MIN_COEFF = 2.0
MAX_PAIR_HITS = 5       # bowtie2 -k 5
MAXSEG = 8              # M-block segments per alignment record
# 4s on both flanks of the device genome: window starts are clipped to
# [-GENOME_PAD, G], and a window (L + 2*band_pad <= 32767 bases, see
# align) never reaches past the back flank
GENOME_PAD = 32768

def revcomp_padded(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse-complement padded reads on their device: rc[i] =
    comp(seq[len-1-i]) for i < len, pad 4 beyond; comp maps 0-3 to 3-0
    and every other code to 4 (the JAX package's clamped table gather)."""
    R, L = seqs.shape
    i = torch.arange(L, dtype=torch.int64, device=seqs.device)
    idx = lens.long()[:, None] - 1 - i[None, :]
    vals = torch.gather(seqs, 1, idx.clamp(0, L - 1))
    comp = torch.where((vals >= 0) & (vals < 4), 3 - vals, 4)
    return torch.where(idx >= 0, comp, 4).to(torch.int8)


def score_min_table(L: int) -> np.ndarray:
    """--score-min G,5,2 per read length 0..L: ceil(5 + 2*ln max(len, 2))
    in float32, as the JAX device formula computes it."""
    x = np.maximum(np.arange(L + 1), 2).astype(np.float32)
    return np.ceil(np.float32(SCORE_MIN_CONST)
                   + np.float32(SCORE_MIN_COEFF) * np.log(x)).astype(np.int32)


def window_slices(genome_p: torch.Tensor, start: torch.Tensor,
                  WL: int) -> torch.Tensor:
    """out[i] = genome[start[i] : start[i] + WL], 4 outside the genome;
    genome_p is the genome with GENOME_PAD 4s on both flanks."""
    G = genome_p.shape[0] - 2 * GENOME_PAD
    lo = torch.clamp(start, -GENOME_PAD, G).long() + GENOME_PAD
    j = torch.arange(WL, dtype=torch.int64, device=start.device)
    return genome_p[lo[:, None] + j]


def _candidate_stats(pos_map, qlens):
    """parseBOWTIE-equivalent quantities from a position map: dict of [B]
    int32 — src_start/src_end/src_gap (I), tgt_start, tgt_end_actual,
    tgt_end (reference formula ts + size + D - I, AlignGraph.cpp:282),
    tgt_gap (D), match count."""
    B, L = pos_map.shape
    aligned = pos_map >= 0
    m = aligned.sum(dim=1, dtype=torch.int32)
    has = m > 0
    idx = torch.arange(L, dtype=torch.int32, device=pos_map.device)[None, :]
    big = 2**30
    ss = torch.where(aligned, idx, big).amin(dim=1)
    se = torch.where(aligned, idx + 1, -1).amax(dim=1)
    ss = torch.where(has, ss, 0)
    se = torch.where(has, se, 0)
    ins = (se - ss) - m
    ts = torch.where(aligned, pos_map, big).amin(dim=1)
    tea = torch.where(aligned, pos_map + 1, -1).amax(dim=1)
    ts = torch.where(has, ts, -1)
    tea = torch.where(has, tea, -1)
    dele = torch.where(has, (tea - ts) - m, 0)
    te_ref = torch.where(has, ts + qlens + dele - ins, -1)
    return dict(match=m, src_start=ss, src_end=se, src_gap=ins,
                tgt_start=ts, tgt_end_actual=tea, tgt_end=te_ref,
                tgt_gap=dele)


def _extract_segments(pm):
    """pos_map rows [B, L] -> M-block segments [B, MAXSEG, 3] (src_start,
    tgt_start, size; -1-filled) + overflow flag [B] (more runs than
    MAXSEG)."""
    B, L = pm.shape
    dev = pm.device
    aligned = pm >= 0
    prev_a = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                        aligned[:, :-1]], dim=1)
    prev_p = torch.cat([torch.full((B, 1), -2, dtype=pm.dtype, device=dev),
                        pm[:, :-1]], dim=1)
    is_start = aligned & (~prev_a | (pm != prev_p + 1))
    run_id = torch.cumsum(is_start.to(torch.int32), dim=1,
                          dtype=torch.int32) - 1
    n_runs = run_id[:, -1] + 1
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    cols = []
    for s in range(MAXSEG):
        in_run = aligned & (run_id == s)
        start_s = is_start & (run_id == s)
        src = torch.where(start_s, idx, -1).amax(dim=1)
        tgt = torch.where(start_s, pm, -1).amax(dim=1)
        size = in_run.sum(dim=1, dtype=torch.int32)
        cols.append(torch.stack([src, tgt, torch.where(size > 0, size, -1)],
                                dim=-1))
    return torch.stack(cols, dim=1), n_runs > MAXSEG


def _align_core(genome_p, index: SeedIndex, seqs, rc, plens, smin_table, *,
                seed_len, stride, pad, C, K, dlow, dhigh, mh):
    """One batch of P pairs (seqs/rc [2P, L] int8, mate-interleaved) ->
    the top-K pair alignments per pair in the full [P, K] layout."""
    R, L = seqs.shape
    P = R // 2
    W = 2 * pad
    dev = seqs.device
    i32 = torch.int32

    def ar(n):
        return torch.arange(n, dtype=i32, device=dev)

    rlens = plens.repeat_interleave(2)                  # [R]
    qseqs = torch.cat([seqs, rc])                       # [2R, L]
    qlens = torch.cat([rlens, rlens])

    # --- seeding: one canonical lookup per read serves both orientations
    packed, offs, valid = pack_query_seeds(seqs, seed_len, stride)
    valid = valid & (offs[None, :] <= (rlens[:, None] - seed_len))
    pk_rc = rc_packed(packed, seed_len)
    qflip = pk_rc < packed
    pcan = torch.minimum(packed, pk_rc)
    pf, ok = lookup_seeds_bucketed(
        index.sorted_kmers, index.sorted_posflip, index.bucket_lo, pcan,
        valid, mh, index.search_steps, index.suffix_bits)
    diag_s, votes_s, orient_s = select_candidates(
        pf, ok, qflip, offs, rlens, seed_len, pad, C)      # [R, C] each
    # single-vote candidates are almost always spurious seed collisions
    diag_s = torch.where(votes_s >= 2, diag_s, INVALID_DIAG)

    # --- validity compaction to TOP rows, rank-major (all rank-0
    # candidates first), so a batch over capacity sheds only its
    # lowest-rank candidates
    diag_f = diag_s.T.reshape(-1)                       # [C*R]
    orient_f = orient_s.T.reshape(-1)
    cvalid_f = diag_f != INVALID_DIAG
    B_full = R * C
    TOP = min(B_full, max(128, (3 * R // 2) // 128 * 128))
    top = torch.sort((~cvalid_f).to(i32), stable=True).indices[:TOP]
    inv = torch.full((B_full,), -1, dtype=i32, device=dev)
    inv[top] = ar(TOP)                                  # full row -> top row
    cvalid = cvalid_f[top]
    diag_safe = torch.where(cvalid, diag_f[top], 0)
    qidx = orient_f[top].long() * R + top % R           # row in qseqs
    windows = window_slices(genome_p, diag_safe - pad, L + W)
    creads = qseqs[qidx]
    clens = qlens[qidx]
    score_min = smin_table[clens.long()]
    sw_score, pos_map = banded_sw_posmap_auto(
        creads, torch.where(cvalid, clens, 0), windows, diag_safe, pad=pad,
        smin=score_min)
    st = _candidate_stats(pos_map, clens)               # [TOP]
    score = torch.where(cvalid, sw_score, -1)
    good = cvalid & (score >= score_min) & (st["match"] > 0)

    # --- per-mate candidate tables [P, 2, C]: full-layout index of
    # (pair p, mate m, cand c) is c*R + (2p + m), through the compaction
    r_ids = 2 * ar(P)[:, None, None] + ar(2)[None, :, None]
    cand_full = (ar(C)[None, None, :] * R + r_ids).long()
    cand = inv[cand_full]                               # top row or -1
    present = cand >= 0
    cand = torch.where(present, cand, 0).long()
    m_fr = orient_f[cand_full].to(torch.int8)
    mt = torch.stack([good.to(i32), score, st["tgt_start"],
                      st["tgt_end_actual"]], dim=-1)
    m_all = mt[cand]                                    # [P, 2, C, 4]
    m_good = (m_all[..., 0] > 0) & present
    m_score = m_all[..., 1]
    m_ts = m_all[..., 2]
    m_tea = m_all[..., 3]
    # dedup identical placements (same tgt_start & fr, earlier slot wins)
    same = ((m_ts[..., None, :] == m_ts[..., :, None])
            & (m_fr[..., None, :] == m_fr[..., :, None])
            & m_good[..., None, :] & m_good[..., :, None])
    j = ar(C)
    earlier = j[None, :] < j[:, None]                   # [C, C] j' < j
    m_good = m_good & ~(same & earlier).any(dim=-1)

    # --- pairing [P, C, C]
    g1, g2 = m_good[:, 0, :, None], m_good[:, 1, None, :]
    fr1, fr2 = m_fr[:, 0, :, None], m_fr[:, 1, None, :]
    ts1, ts2 = m_ts[:, 0, :, None], m_ts[:, 1, None, :]
    te1, te2 = m_tea[:, 0, :, None], m_tea[:, 1, None, :]
    s1, s2 = m_score[:, 0, :, None], m_score[:, 1, None, :]
    ts_fwd = torch.where(fr1 == 0, ts1, ts2)
    ts_rev = torch.where(fr1 == 0, ts2, ts1)
    lo = torch.minimum(ts1, ts2)
    frag = torch.maximum(te1, te2) - lo
    okp = (g1 & g2 & (fr1 != fr2) & (ts_fwd <= ts_rev)
           & (frag >= dlow) & (frag <= dhigh))
    total = torch.where(okp, s1 + s2, -1)
    # rank: total desc, then fragment start asc, then slot (stable)
    big = 2**30
    order = sort_pairs(torch.where(okp, -total, big).reshape(P, -1),
                       torch.where(okp, lo, big).reshape(P, -1),
                       dim=1)[:, :K]

    def pick(a):                                        # [P, C, C] -> [P, K]
        return torch.gather(a.expand(P, C, C).reshape(P, -1), 1, order)

    kvalid = pick(okp)
    both = torch.stack([pick(cand[:, 0, :, None]),
                        pick(cand[:, 1, None, :])], dim=-1)     # [P, K, 2]
    out = {"fr": torch.stack([pick(m_fr[:, 0, :, None]),
                              pick(m_fr[:, 1, None, :])], dim=-1)}
    segs_top, ovf_top = _extract_segments(pos_map)      # [TOP, MAXSEG, 3]
    allcols = torch.cat([
        torch.stack([score, st["src_start"], st["src_end"], st["src_gap"],
                     clens, st["tgt_start"], st["tgt_end"], st["tgt_gap"],
                     ovf_top.to(i32)], dim=-1),
        segs_top.reshape(TOP, MAXSEG * 3)], dim=1)      # [TOP, 9 + 24]
    gsel = allcols[both]                                # [P, K, 2, 33]
    out["valid"] = kvalid & ~(gsel[..., 8] > 0).any(dim=-1)
    out["score"] = gsel[..., 0]
    out["src_start"] = gsel[..., 1]
    out["src_end"] = gsel[..., 2]
    out["src_gap"] = gsel[..., 3]
    out["src_size"] = gsel[..., 4]
    out["tgt_start"] = gsel[..., 5]
    out["tgt_end"] = gsel[..., 6]
    out["tgt_gap"] = gsel[..., 7]
    out["segs"] = gsel[..., 9:].reshape(P, K, 2, MAXSEG, 3)
    return out


def c13_mask(out: dict) -> torch.Tensor:
    """C13 (AlignGraph.cpp:1261) over the full [P, K] layout on its device:
    both mates (se-ss-I)/size >= 0.6 and (te-ts-D)/(te-ts) >= 0.6, exact
    in integers since 0.6 == 3/5 -> [P, K] bool."""
    ss, se, sg = out["src_start"], out["src_end"], out["src_gap"]
    sz = out["src_size"]
    ts, te, tg = out["tgt_start"], out["tgt_end"], out["tgt_gap"]
    ok = ((se - ss - sg) * 5 >= 3 * sz) & ((te - ts - tg) * 5
                                           >= 3 * (te - ts))
    return ok.all(dim=-1)


def _valid_first(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The first n indices of a 1-D bool mask with the set ones first,
    each group in index order (a stable sort of the flag: fixed shapes,
    no host sync) -> int64 [n]."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices[:n]


def _words(a: torch.Tensor) -> torch.Tensor:
    """The bytes of a uint8 / int8 / int16 tensor as int32 words, element
    0 in the low bytes (XLA's bitcast_convert_type of [N, 4] or [N, 2])."""
    return a.contiguous().reshape(-1).view(torch.int32)


def dense_capacities(P: int, K: int = MAX_PAIR_HITS) -> tuple:
    """pack_dense's sparse capacities (E2 extras, E3 segment-overflow
    entries), clamped to the flat source sizes."""
    return (max(P // 8, min(256, P * K)),
            max(P // 4, min(256, P * K * 2 * (MAXSEG - 1))))


def pack_dense(out: dict, P: int, K: int) -> torch.Tensor:
    """Dense-per-pair serialization of the full layout into one int32
    buffer (the JAX package's _pack_dense, word for word).

    Most pairs report one hit with one M-block per mate, so a [P]-dense
    primary record plus small sparse buffers carries them.  Needs L <= 255
    (8-bit ss/sz) and distance_high <= 32000 (int16 mate-1 tgt delta).

    Word layout (P % 128 == 0; E2, E3 = dense_capacities(P, K)):
      [0] n_extras  [1] n_ovf
      [2, 2+P/4)  meta u8 x4:  has | frp<<1 | segovf<<3 | k0<<4
      [+P)        score  [P,2] int16 x2
      [+P)        tgt0   [P]   int32 (mate-0 tgt_start)
      [+P/2)      dt     [P]   int16 x2 (tgt1 - tgt0)
      [+P)        seg    [P]   (ss0, sz0, ss1, sz1) u8 x4
      extras (valid hits beyond the first per pair, in flat (p, k) order):
      [+E2)       ex_id   int32: (p*K + k) | segovf<<30, -1 empty
      [+E2/4)     ex_frp  u8 x4
      [+E2)       ex_score int16 x2
      [+2*E2)     ex_tgt  [E2, 2] int32
      [+E2)       ex_seg  (ss0, sz0, ss1, sz1) u8 x4
      segment-overflow entries (M-blocks beyond the first of any valid hit,
      in flat (p, k, mate, seg) order):
      [+E3)       ov_id   int32: (p*K + k)*16 + mate*8 + seg, -1 empty
      [+E3/2)     ov_ss   (src u8, sz u8) x2
      [+E3/2)     ov_dt   int16 x2 (tgt - hit tgt_base of that mate)
    """
    i32, u8, i16 = torch.int32, torch.uint8, torch.int16
    valid = out["valid"]                          # [P, K] bool
    segs = out["segs"]                            # [P, K, 2, S, 3] int32
    tgt = out["tgt_start"]                        # [P, K, 2]
    S = MAXSEG
    E2, E3 = dense_capacities(P, K)
    karange = torch.arange(K, dtype=i32, device=valid.device)

    has = valid.any(dim=1)
    # the first valid k (JAX's argmax over the bool row), 0 when none
    k0 = torch.where(has, torch.where(valid, karange, K).amin(dim=1), 0)
    pr = torch.arange(P, device=valid.device)
    kl = k0.long()
    p_fr = out["fr"][pr, kl]                      # [P, 2] int8
    p_score = out["score"][pr, kl]                # [P, 2]
    p_tgt = tgt[pr, kl]                           # [P, 2]
    p_segs = segs[pr, kl]                         # [P, 2, S, 3]
    p_ovf = (p_segs[:, :, 1:, 2] > 0).flatten(1).any(dim=1) & has
    frp = (p_fr[:, 0] | (p_fr[:, 1] << 1)).to(i32)
    meta = torch.where(has, 1 | (frp << 1) | (p_ovf.to(i32) << 3)
                       | (k0 << 4), 0)
    sc16 = torch.where(has[:, None], p_score, 0).to(i16)
    tgt0 = torch.where(has, p_tgt[:, 0], -1)
    dt16 = torch.where(has, p_tgt[:, 1] - p_tgt[:, 0], 0).to(i16)
    ss0 = torch.where(has[:, None] & (p_segs[:, :, 0, 2] > 0),
                      p_segs[:, :, 0, 0], 0)
    sz0 = torch.where(has[:, None], p_segs[:, :, 0, 2], 0).clamp_min(0)
    seg8 = torch.stack([ss0[:, 0], sz0[:, 0], ss0[:, 1], sz0[:, 1]],
                       dim=-1).to(u8)

    # extras: valid slots beyond the first, compacted in (p, k) order
    ef = (valid & (karange[None, :] != k0[:, None])).reshape(P * K)
    eorder = _valid_first(ef, E2)
    evalid = ef[eorder]
    e_p, e_k = eorder // K, eorder % K
    e_segs = segs[e_p, e_k]                       # [E2, 2, S, 3]
    e_ovf = (e_segs[:, :, 1:, 2] > 0).flatten(1).any(dim=1)
    ex_id = torch.where(evalid, (e_p * K + e_k).to(i32)
                        | (e_ovf.to(i32) << 30), -1)
    e_fr = out["fr"][e_p, e_k]
    ex_frp = torch.where(evalid, (e_fr[:, 0] | (e_fr[:, 1] << 1)).to(i32),
                         0).to(u8)
    ex_sc = torch.where(evalid[:, None], out["score"][e_p, e_k], 0).to(i16)
    ex_tgt = torch.where(evalid[:, None], tgt[e_p, e_k], -1)
    exs = torch.where(evalid[:, None] & (e_segs[:, :, 0, 2] > 0),
                      e_segs[:, :, 0, 0], 0)
    exz = torch.where(evalid[:, None], e_segs[:, :, 0, 2], 0).clamp_min(0)
    ex_seg = torch.stack([exs[:, 0], exz[:, 0], exs[:, 1], exz[:, 1]],
                         dim=-1).to(u8)

    # segment-overflow entries over every valid hit
    of = (valid[:, :, None, None] & (segs[:, :, :, 1:, 2] > 0)).reshape(-1)
    oorder = _valid_first(of, E3)
    ovalid = of[oorder]
    o_pk, rem = oorder // (2 * (S - 1)), oorder % (2 * (S - 1))
    o_m, o_s = rem // (S - 1), rem % (S - 1) + 1
    o_p, o_k = o_pk // K, o_pk % K
    ov_id = torch.where(ovalid, (o_pk * 16 + o_m * 8 + o_s).to(i32), -1)
    o_row = segs[o_p, o_k, o_m, o_s]              # [E3, 3]
    ov_src = torch.where(ovalid, o_row[:, 0], 0).to(u8)
    ov_sz = torch.where(ovalid, o_row[:, 2], 0).to(u8)
    ov_dt = torch.where(ovalid, o_row[:, 1] - tgt[o_p, o_k, o_m], 0).to(i16)

    return torch.cat([
        torch.stack([ef.sum(dtype=i32), of.sum(dtype=i32)]),
        _words(meta.to(u8)), _words(sc16), tgt0, _words(dt16),
        _words(seg8),
        ex_id, _words(ex_frp), _words(ex_sc), ex_tgt.reshape(-1),
        _words(ex_seg),
        ov_id, _words(torch.stack([ov_src, ov_sz], dim=-1)), _words(ov_dt),
    ])


def record_capacities(P: int) -> tuple:
    """pack_records' capacities (M slots, E segment-overflow entries)."""
    return (3 * P) // 2, max(P // 2, 128)


def pack_records(out: dict, P: int, K: int) -> torch.Tensor:
    """Per-slot serialization of the full layout into one int32 buffer
    (the general layout of the JAX package's _align_pairs_packed, word for
    word): the valid (p, k) slots first, in flat order, then the
    M-blocks beyond each slot's first in a sparse buffer.

    Word layout (M, E = record_capacities(P); M % 4 == 0, E % 4 == 0):
      [0] n_valid  [1] n_ovf
      [2, 2+M)          slot_id        int32
      [+M/4)            frp            uint8 x4/word
      [+M)              score[M,2]     int16 x2/word
      [+2M)             tgt_base[M,2]  int32
      [+2M)             seg1[M,2,2]    int16 x2/word
      [+E)              ovf_slot       int32
      [+E/4)            ovf_ms         int8 x4/word
      [+E/2)            ovf_src        int16 x2/word
      [+E/2)            ovf_dt         int16 x2/word
      [+E/2)            ovf_sz         int16 x2/word
    """
    i32, i16 = torch.int32, torch.int16
    M, E = record_capacities(P)
    S = MAXSEG
    valid_f = out["valid"].reshape(P * K)
    slots = _valid_first(valid_f, M)              # valid slots first
    svalid = valid_f[slots]
    p_ids, k_ids = slots // K, slots % K

    def g(a):
        return a[p_ids, k_ids]

    segs = g(out["segs"])                         # [M, 2, S, 3] int32
    tgt_base = g(out["tgt_start"])                # [M, 2]
    fr = g(out["fr"])
    frp = (fr[:, 0] | (fr[:, 1] << 1)).to(torch.uint8)
    seg1 = torch.stack([segs[:, :, 0, 0], segs[:, :, 0, 2]],
                       dim=-1).to(i16)            # [M, 2, 2] (ss, sz)
    seg1 = torch.where(svalid[:, None, None], seg1, -1)

    # sparse overflow buffer for segments beyond the first
    extra = (segs[:, :, 1:, 2] > 0) & svalid[:, None, None]   # [M,2,S-1]
    ef = extra.reshape(-1)
    eorder = _valid_first(ef, E)
    evalid = ef[eorder]
    e_slot, rem = eorder // (2 * (S - 1)), eorder % (2 * (S - 1))
    e_mate, e_seg = rem // (S - 1), rem % (S - 1) + 1
    e_row = segs[e_slot, e_mate, e_seg]           # [E, 3]
    e_src = e_row[:, 0].to(i16)
    e_dt = (e_row[:, 1] - tgt_base[e_slot, e_mate]).to(i16)
    e_sz = e_row[:, 2].to(i16)
    return torch.cat([
        torch.stack([valid_f.sum(dtype=i32), extra.sum(dtype=i32)]),
        torch.where(svalid, slots.to(i32), -1),
        _words(torch.where(svalid, frp, 255)),
        _words(g(out["score"]).to(i16)),
        tgt_base.reshape(-1),
        _words(seg1),
        torch.where(evalid, e_slot.to(i32), -1),
        _words(torch.where(evalid, e_mate * 8 + e_seg, -1).to(torch.int8)),
        _words(torch.where(evalid, e_src, -1)),
        _words(torch.where(evalid, e_dt, -1)),
        _words(torch.where(evalid, e_sz, -1)),
    ])


def compact(out: dict, P: int, *, c13: bool, dense: bool) -> torch.Tensor:
    """The batch's one transfer buffer: the C13 filter applied to
    out["valid"] in place when c13, then pack_dense or pack_records."""
    if c13:
        out["valid"] = out["valid"] & c13_mask(out)
    return (pack_dense if dense else pack_records)(out, P, MAX_PAIR_HITS)


# PairAlignments' fields in order; pos_map, the widest, is the last
RECORD_FIELDS = tuple(f.name for f in dataclasses.fields(PairAlignments))
ROW_HEAD = 2          # a row block's header: record count, overflow flag


def _field_shape(name: str, L: int) -> tuple:
    """A record's shape of one PairAlignments field."""
    return () if name == "pair_id" else (2, L) if name == "pos_map" else (2,)


def row_width(L: int) -> int:
    """Int32 columns of one record's row: every PairAlignments field's
    values side by side, in field order (19 + 2L)."""
    return sum(int(np.prod(_field_shape(f, L))) for f in RECORD_FIELDS)


def reconstruct_pos_map(segs: torch.Tensor, L: int) -> torch.Tensor:
    """Segments [..., MAXSEG, 3] -> pos_map [..., L] int32 on their
    device; a later segment wins where two would cover one base."""
    idx = torch.arange(L, dtype=torch.int32, device=segs.device)
    pm = torch.full(segs.shape[:-2] + (L,), -1, dtype=torch.int32,
                    device=segs.device)
    for s in range(segs.shape[-2]):
        st = segs[..., s, 0:1]
        ts = segs[..., s, 1:2]
        sz = segs[..., s, 2:3]
        m = (sz > 0) & (idx >= st) & (idx < st + sz)
        pm = torch.where(m, ts + (idx - st), pm)
    return pm


def _record_stats(segs: torch.Tensor, tgt_base: torch.Tensor,
                  qlen: torch.Tensor) -> dict:
    """The parse quantities from the records' full segment tables
    [n, 2, MAXSEG, 3], with the exact integer formulas of
    _candidate_stats -> dict of [n, 2] int32."""
    sz = torch.where(segs[..., 2] > 0, segs[..., 2], 0)
    match = sz.sum(dim=-1)
    nseg = (sz > 0).sum(dim=-1).clamp_min(1)
    last = (nseg - 1)[..., None]
    ss = segs[..., 0, 0]
    src_last = torch.gather(segs[..., 0], -1, last)[..., 0]
    sz_last = torch.gather(sz, -1, last)[..., 0]
    se = src_last + sz_last
    ins = (se - ss) - match
    tea = torch.gather(segs[..., 1], -1, last)[..., 0] + sz_last
    dele = (tea - tgt_base) - match
    i32 = torch.int32
    return dict(source_start=ss.to(i32), source_end=se.to(i32),
                source_gap=ins.to(i32), source_size=qlen.expand(ins.shape),
                target_start=tgt_base,
                target_end=(tgt_base + qlen + dele - ins).to(i32),
                target_gap=dele.to(i32))


def _segment_table(seg1: torch.Tensor, tgt_base: torch.Tensor,
                   first_size: torch.Tensor) -> torch.Tensor:
    """[n + 1, 2, MAXSEG, 3] int32, -1-filled: each record's first
    M-block (seg1 [n, 2, 2] = (ss, sz) per mate) with size `first_size`;
    row n is a spare row that overflow entries of dropped records write."""
    n = seg1.shape[0]
    segs = torch.full((n + 1, 2, MAXSEG, 3), -1, dtype=torch.int32,
                      device=seg1.device)
    segs[:n, :, 0, 0] = seg1[..., 0]
    segs[:n, :, 0, 1] = torch.where(seg1[..., 1] > 0, tgt_base, -1)
    segs[:n, :, 0, 2] = first_size
    return segs


def _put_overflow(segs, tgt_base, orow, omate, oseg, src, dt, size):
    """segs[orow, omate, oseg] = (src, tgt_base[orow, omate] + dt, size)
    for the entries with orow >= 0; the others land in the spare last
    row (fixed shapes, no host sync)."""
    ok = orow >= 0
    spare = segs.shape[0] - 1
    omate = torch.where(ok, omate, 0)
    oseg = torch.where(ok, oseg, 0)
    tgt = tgt_base[orow.clamp_min(0), omate] + dt
    segs[torch.where(ok, orow, spare), omate, oseg] = torch.stack(
        [src, tgt, size], dim=-1)


def unpack_dense(buf: torch.Tensor, P: int) -> dict:
    """The pack_dense buffer's fields as views of it on its device; the
    counts stay 0-d tensors, and "overflow" says whether they pass the
    buffer's capacities."""
    E2, E3 = dense_capacities(P)
    u8, i16 = torch.uint8, torch.int16
    o = 2
    out = {"n_extras": buf[0], "n_ovf": buf[1]}
    out["overflow"] = (buf[0] > E2) | (buf[1] > E3)
    out["meta"] = buf[o:o + P // 4].view(u8); o += P // 4
    out["score"] = buf[o:o + P].view(i16).view(P, 2); o += P
    out["tgt0"] = buf[o:o + P]; o += P
    out["dt"] = buf[o:o + P // 2].view(i16); o += P // 2
    out["seg"] = buf[o:o + P].view(u8).view(P, 4); o += P
    out["ex_id"] = buf[o:o + E2]; o += E2
    out["ex_frp"] = buf[o:o + E2 // 4].view(u8); o += E2 // 4
    out["ex_score"] = buf[o:o + E2].view(i16).view(E2, 2); o += E2
    out["ex_tgt"] = buf[o:o + 2 * E2].view(E2, 2); o += 2 * E2
    out["ex_seg"] = buf[o:o + E2].view(u8).view(E2, 4); o += E2
    out["ov_id"] = buf[o:o + E3]; o += E3
    out["ov_ss"] = buf[o:o + E3 // 2].view(u8).view(E3, 2); o += E3 // 2
    out["ov_dt"] = buf[o:o + E3 // 2].view(i16); o += E3 // 2
    if o != buf.shape[0]:
        raise ValueError(f"dense buffer of {buf.shape[0]} words for "
                         f"P {P}: expected {o}")
    return out


def _expand_dense(res: dict, start: int, cnt: int, L: int,
                  plens: torch.Tensor) -> tuple:
    """The dense-per-pair buffer's records on its device (the JAX
    package's _expand_dense): in ascending (pair, k) order, the parse
    quantities recomputed from the segments.  Fixed capacity cnt + E2
    rows; returns (fields, n): the first n rows are the records."""
    K = MAX_PAIR_HITS
    i32, i64 = torch.int32, torch.int64
    meta = res["meta"]
    P, E2 = meta.shape[0], res["ex_id"].shape[0]
    dev = meta.device
    pr = torch.arange(P, dtype=i64, device=dev)
    has = ((meta & 1) == 1) & (pr < cnt)
    k0 = (meta.to(i64) >> 4) & 7
    ex_pk = res["ex_id"].to(i64) & ((1 << 30) - 1)
    keep = (res["ex_id"] >= 0) & (ex_pk // K < cnt)

    # record table in ascending (pair, k) order: a pair's primary has its
    # lowest valid k, its extras the others; padding keys sort last
    past = P * K
    keys = torch.cat([torch.where(has, pr * K + k0, past),
                      torch.where(keep, ex_pk, past)])
    cap = cnt + E2
    srt = torch.sort(keys, stable=True)
    order, pk_of = srt.indices[:cap], srt.values[:cap]
    real = pk_of < past
    n = real.sum(dtype=i32)
    pair = torch.where(real, torch.cat([pr, ex_pk // K])[order], 0)
    frp = torch.cat([(meta.to(torch.int8) >> 1) & 3,
                     res["ex_frp"].to(torch.int8) & 3])[order]
    fr = torch.stack([frp & 1, (frp >> 1) & 1], dim=-1).to(torch.int8)
    score = torch.cat([res["score"], res["ex_score"]])[order].to(i32)
    tgt0 = res["tgt0"]
    tgt_base = torch.cat([torch.stack([tgt0, tgt0 + res["dt"]], dim=-1),
                          res["ex_tgt"]])[order]
    seg1 = torch.cat([res["seg"], res["ex_seg"]])[order].to(i32).view(
        cap, 2, 2)
    segs = _segment_table(seg1, tgt_base,
                          torch.where(seg1[..., 1] > 0, seg1[..., 1], -1))

    # segment-overflow entries: (p*K + k)*16 + mate*8 + seg -> its row;
    # a padding row's key points past the real ones, one slot each
    rows = torch.arange(cap, dtype=i64, device=dev)
    row_of = torch.full((past + cap,), -1, dtype=i64, device=dev)
    row_of[torch.where(real, pk_of, past + rows)] = rows
    ov_id = res["ov_id"].to(i64)
    orow = torch.where(ov_id >= 0, row_of[(ov_id // 16).clamp(0, past - 1)],
                       -1)
    orem = ov_id % 16
    ov_ss = res["ov_ss"].to(i32)
    _put_overflow(segs, tgt_base, orow, orem // 8, orem % 8, ov_ss[:, 0],
                  res["ov_dt"].to(i32), ov_ss[:, 1])
    segs = segs[:cap]

    qlen = plens[pair][:, None]
    return dict(pair_id=(pair + start).to(i32), fr=fr, score=score,
                **_record_stats(segs, tgt_base, qlen),
                pos_map=reconstruct_pos_map(segs, L)), n


def unpack_records(buf: torch.Tensor, P: int) -> dict:
    """The pack_records buffer's fields as views of it on its device; the
    counts stay 0-d tensors, and "overflow" says whether they pass the
    buffer's capacities."""
    M, E = record_capacities(P)
    i8, u8, i16 = torch.int8, torch.uint8, torch.int16
    o = 2
    out = {"n_valid": buf[0], "n_ovf": buf[1]}
    out["overflow"] = (buf[0] > M) | (buf[1] > E)
    out["slot_id"] = buf[o:o + M]; o += M
    out["frp"] = buf[o:o + M // 4].view(u8); o += M // 4
    out["score"] = buf[o:o + M].view(i16).view(M, 2); o += M
    out["tgt_base"] = buf[o:o + 2 * M].view(M, 2); o += 2 * M
    out["seg1"] = buf[o:o + 2 * M].view(i16).view(M, 2, 2); o += 2 * M
    out["ovf_slot"] = buf[o:o + E]; o += E
    out["ovf_ms"] = buf[o:o + E // 4].view(i8); o += E // 4
    out["ovf_src"] = buf[o:o + E // 2].view(i16); o += E // 2
    out["ovf_dt"] = buf[o:o + E // 2].view(i16); o += E // 2
    out["ovf_sz"] = buf[o:o + E // 2].view(i16); o += E // 2
    if o != buf.shape[0]:
        raise ValueError(f"per-slot buffer of {buf.shape[0]} words for "
                         f"P {P}: expected {o}")
    return out


def _expand_packed(res: dict, start: int, cnt: int, L: int,
                   plens: torch.Tensor) -> tuple:
    """The per-slot buffer's records on its device (the JAX package's
    _expand_packed), the parse quantities recomputed from the segments.
    Fixed capacity M rows; returns (fields, n): the first n rows are the
    records."""
    K = MAX_PAIR_HITS
    i32, i64 = torch.int32, torch.int64
    slot = res["slot_id"]
    M = slot.shape[0]
    keep = (slot >= 0) & (slot // K < cnt)
    sel = _valid_first(keep, M)                   # kept slots first
    n = keep.sum(dtype=i32)
    # compact-row index -> output row (-1 dropped)
    row_of = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
    p_ids = torch.where(keep[sel], slot[sel] // K, 0).to(i64)

    frp = res["frp"][sel].to(torch.int8)
    fr = torch.stack([frp & 1, (frp >> 1) & 1], dim=-1).to(torch.int8)
    score = res["score"][sel].to(i32)
    tgt_base = res["tgt_base"][sel]                          # [M, 2]
    seg1 = res["seg1"][sel].to(i32)                          # [M, 2, 2]
    segs = _segment_table(seg1, tgt_base, seg1[..., 1])
    ovf_slot = res["ovf_slot"]
    orow = torch.where(ovf_slot >= 0, row_of[ovf_slot.clamp_min(0)], -1)
    oms = res["ovf_ms"].to(i64)
    _put_overflow(segs, tgt_base, orow, oms // 8, oms % 8,
                  res["ovf_src"].to(i32), res["ovf_dt"].to(i32),
                  res["ovf_sz"].to(i32))
    segs = segs[:M]

    qlen = plens[p_ids][:, None]
    return dict(pair_id=(p_ids + start).to(i32), fr=fr, score=score,
                **_record_stats(segs, tgt_base, qlen),
                pos_map=reconstruct_pos_map(segs, L)), n


def _expand_full(out: dict, start: int, cnt: int, L: int) -> tuple:
    """The accepted records of the full [P, K] layout on its device
    (pairs past `cnt` are batch padding), in (pair, k) order.  Fixed
    capacity cnt * K rows; returns (fields, n)."""
    valid = out["valid"]
    P, K = valid.shape
    live = (valid & (torch.arange(P, device=valid.device)[:, None]
                     < cnt)).reshape(-1)
    sel = _valid_first(live, cnt * K)
    p_ids, k_ids = sel // K, sel % K

    def g(a):
        return a[p_ids, k_ids]

    return dict(
        pair_id=(p_ids + start).to(torch.int32),
        fr=g(out["fr"]),
        score=g(out["score"]),
        source_start=g(out["src_start"]),
        source_end=g(out["src_end"]),
        source_gap=g(out["src_gap"]),
        source_size=g(out["src_size"]),
        target_start=g(out["tgt_start"]),
        target_end=g(out["tgt_end"]),
        target_gap=g(out["tgt_gap"]),
        pos_map=reconstruct_pos_map(g(out["segs"]), L),
    ), live.sum(dtype=torch.int32)


def _row_table(rec: dict, n, overflow) -> torch.Tensor:
    """One int32 block on the records' device: ROW_HEAD header words (the
    record count n, the overflow flag), then one row a record of capacity
    (row_width columns, every field side by side in field order)."""
    cap = rec["pair_id"].shape[0]
    cols = [rec[f].reshape(cap, int(np.prod(rec[f].shape[1:])))
            for f in RECORD_FIELDS]
    width = sum(c.shape[1] for c in cols)
    blk = torch.empty(ROW_HEAD + cap * width, dtype=torch.int32,
                      device=rec["pair_id"].device)
    blk[0] = n
    blk[1] = overflow
    rows = blk[ROW_HEAD:].view(cap, width)
    col = 0
    for c in cols:
        rows[:, col:col + c.shape[1]] = c
        col += c.shape[1]
    return blk


def _to_host(blk: torch.Tensor) -> tuple:
    """(host block, event): a CUDA block's non-blocking copy into pinned
    host memory, started behind an event; a CPU block as it is (None)."""
    if blk.device.type != "cuda":
        return blk, None
    host = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
    host.copy_(blk, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(blk.device))
    return host, event


def _copy_out(blk: np.ndarray, L: int) -> dict:
    """Host: the first n rows of a row block (n its first header word) as
    PairAlignments' fields, each copied into a numpy array of its own
    (nothing keeps a view of the block): one strided pass for the narrow
    fields' columns, one for pos_map, the last and widest."""
    n = int(blk[0])
    W = row_width(L)
    rows = blk[ROW_HEAD:ROW_HEAD + n * W].reshape(n, W)
    narrow = np.array(rows[:, :W - 2 * L])
    out, col = {}, 0
    for f in RECORD_FIELDS[:-1]:
        shape = _field_shape(f, L)
        w = int(np.prod(shape))
        out[f] = np.array(narrow[:, col:col + w],
                          dtype=np.int8 if f == "fr" else np.int32
                          ).reshape((n,) + shape)
        col += w
    out["pos_map"] = np.array(rows[:, col:]).reshape(n, 2, L)
    return out


@dataclasses.dataclass
class ReadAligner:
    """Holds the genome and its seed index on one device; aligns batches of
    pairs there.

    c13: apply the reference's read-pair ratio filter (C13,
    AlignGraph.cpp:1261, THRESHOLD 0.6) to the records; False keeps the raw
    records (the misassembly-removal coverage loader needs them).
    """
    genome_p: torch.Tensor     # [GENOME_PAD + G + GENOME_PAD] int8
    index: SeedIndex           # on the genome's device
    cfg: Config
    batch_pairs: int = 32768
    c13: bool = True
    # the last align's batches by layout and bytes copied down, and its
    # host seconds by step (see align)
    transfer: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False)
    split: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    @classmethod
    def build(cls, genome_codes: np.ndarray, cfg: Config,
              batch_pairs: int = 32768, c13: bool = True, *,
              device) -> "ReadAligner":
        """Index the genome on `device` and place it there too."""
        return cls.from_index(genome_codes,
                              build_index(genome_codes, cfg.seed_len,
                                          device=device), cfg,
                              batch_pairs=batch_pairs, c13=c13,
                              device=device)

    @classmethod
    def from_index(cls, genome_codes: np.ndarray, index: SeedIndex,
                   cfg: Config, batch_pairs: int = 32768, c13: bool = True,
                   *, device) -> "ReadAligner":
        """An aligner over a seed index built elsewhere: one on `device`
        is used as it is, one elsewhere (SeedIndex.from_numpy carries the
        JAX package's index across onto the CPU) is moved there."""
        if index.seed_len != cfg.seed_len:
            raise ValueError(f"index seed_len {index.seed_len} != "
                             f"cfg.seed_len {cfg.seed_len}")
        if index.genome_len != len(genome_codes):
            raise ValueError(f"index genome_len {index.genome_len} != "
                             f"genome length {len(genome_codes)}")
        # align copies every batch's records out into fresh numpy arrays;
        # with freed pages kept on the heap they are reused
        # warm instead of faulted in afresh (utils/hostmem.py).  The host
        # times in PERF.md are taken with this setting.
        tune_host_malloc()
        gp = np.full(len(genome_codes) + 2 * GENOME_PAD, 4, np.int8)
        gp[GENOME_PAD:GENOME_PAD + len(genome_codes)] = genome_codes
        return cls(genome_p=torch.from_numpy(gp).to(device),
                   index=index.to(device), cfg=cfg, batch_pairs=batch_pairs,
                   c13=c13)

    def align(self, reads: Reads) -> PairAlignments:
        """Align all pairs; returns the accepted pair alignments (host SoA).

        Each batch is aligned, compacted and decoded into one block of
        record rows on the device; the host waits for the block's pinned
        copy, copies its records out and, at the end, concatenates the
        batches.  Batch i + 1 is enqueued before batch i is copied out, so
        at most two batches are in flight.  Afterwards self.transfer holds
        how many batches were decoded from the dense buffer ("dense"), from
        the per-slot buffer ("per_slot") and from the full layout after
        overflowing their buffer ("overflow"), and the bytes of the record
        blocks copied to the host ("host_bytes": every batch's block at its
        capacity, header included, plus an overflowing batch's second
        block); self.split the host seconds, summed over the batches, in
        the wait for a block ("wait_s"), in copying records out of it
        ("copy_out_s") and in the final concatenation ("concat_s").  Both
        are views of the call's spans (utils/spans.py): align.reads, then
        per batch align.reads.enqueue (its device work), align.reads.wait
        and align.reads.copy_out (its counts: the layout, host_bytes,
        records), and align.reads.concat."""
        cfg = self.cfg
        L = max(reads.max_len, cfg.seed_len)
        if L > 32767 - 2 * cfg.band_pad:
            raise ValueError(
                f"read length {L} exceeds the PE read aligner's limit "
                f"({32767 - 2 * cfg.band_pad}); long queries belong to the "
                f"contig aligner")
        smin = torch.from_numpy(score_min_table(L)).to(self.genome_p.device)
        # the dense buffer's 8-bit source fields and int16 mate delta
        dense = L <= 255 and cfg.distance_high <= 32000
        self.transfer = dict(dense=0, per_slot=0, overflow=0, host_bytes=0)
        self.split = dict(wait_s=0.0, copy_out_s=0.0, concat_s=0.0)
        n = reads.n_pairs
        chunks, inflight = [], collections.deque()
        with spans.span("align.reads") as call:
            for start in range(0, max(n, 1), self.batch_pairs):
                cnt = min(self.batch_pairs, n - start) if n else 0
                # batch shape: the next power of two >= 1024 pairs, capped
                # at batch_pairs, rounded up to a multiple of 128.  The DP
                # capacity TOP depends on it and candidates past TOP are
                # shed, so this rule is part of the output, not only of
                # the speed.
                P = min(self.batch_pairs,
                        max(1024, 1 << (max(cnt, 1) - 1).bit_length()))
                P = -(-P // 128) * 128
                inflight.append(self._enqueue(reads, start, cnt, P, L,
                                              smin, dense))
                if len(inflight) == 2:
                    chunks.append(self._decode(inflight.popleft(), L))
            while inflight:
                chunks.append(self._decode(inflight.popleft(), L))
            with spans.span("align.reads.concat", timed=True) as s:
                cat = chunks[0] if len(chunks) == 1 else {
                    k: np.concatenate([c[k] for c in chunks])
                    for k in chunks[0]}
            self.split["concat_s"] += s.seconds
            call.add(pairs=n, records=len(cat["pair_id"]))
        return PairAlignments(**cat)

    def _enqueue(self, reads: Reads, start: int, cnt: int, P: int, L: int,
                 smin: torch.Tensor, dense: bool) -> dict:
        """Upload pairs [start, start + cnt) padded to P, align them, pack
        the records, decode the buffer into a block of record rows and, on
        CUDA, start the block's copy into pinned host memory behind an
        event.  Nothing here waits for the device."""
        cfg = self.cfg
        dev = self.genome_p.device
        cuda = dev.type == "cuda"
        with spans.span("align.reads.enqueue", device=dev) as s:
            s.add(pairs=cnt, capacity=P)
            seqs = torch.full((2 * P, L), 4, dtype=torch.int8,
                              pin_memory=cuda)
            plens = torch.zeros(P, dtype=torch.int32, pin_memory=cuda)
            if cnt > 0:
                blk = reads.data[2 * start:2 * (start + cnt)]
                seqs.numpy()[:2 * cnt, :blk.shape[1]] = blk
                plens.numpy()[:cnt] = reads.lengths[start:start + cnt]
            seqs_d = seqs.to(dev, non_blocking=True)
            plens_d = plens.to(dev, non_blocking=True)
            rc = revcomp_padded(seqs_d, plens_d.repeat_interleave(2))
            out = _align_core(
                self.genome_p, self.index, seqs_d, rc, plens_d, smin,
                seed_len=cfg.seed_len, stride=cfg.seed_stride,
                pad=cfg.band_pad, C=cfg.max_candidates, K=MAX_PAIR_HITS,
                dlow=cfg.distance_low, dhigh=cfg.distance_high,
                mh=cfg.max_seed_hits)
            buf = compact(out, P, c13=self.c13, dense=dense)
            if dense:
                res = unpack_dense(buf, P)
                rec, n = _expand_dense(res, start, cnt, L, plens_d)
            else:
                res = unpack_records(buf, P)
                rec, n = _expand_packed(res, start, cnt, L, plens_d)
            blk, event = _to_host(_row_table(rec, n, res["overflow"]))
        # the full layout stays on the device until the flag is read
        return dict(start=start, cnt=cnt, dense=dense, out=out, blk=blk,
                    event=event)

    def _decode(self, batch: dict, L: int) -> dict:
        """Wait for one batch's block, read its header and copy its records
        out; a batch over its buffer's capacities is decoded again on the
        device from its full layout (as the JAX package re-runs it), and
        its records come down in a block of their own.  The block's
        layout and host bytes are the copy_out span's counts, and
        self.transfer sums them."""
        sp = self.split
        with spans.span("align.reads.wait", timed=True) as s:
            _wait(batch["event"])
        sp["wait_s"] += s.seconds
        blk = batch["blk"].numpy()
        counts = dict(host_bytes=blk.nbytes)
        if blk[1]:
            # more records or M-blocks than the buffer holds (heavy
            # multi-mapping or a very gappy batch); C13 is already in
            # out["valid"]
            rec, n = _expand_full(batch["out"], batch["start"],
                                  batch["cnt"], L)
            host, event = _to_host(_row_table(rec, n, torch.zeros_like(n)))
            with spans.span("align.reads.wait", timed=True) as s:
                _wait(event)
            sp["wait_s"] += s.seconds
            blk = host.numpy()
            counts.update(host_bytes=counts["host_bytes"] + blk.nbytes,
                          overflow=1)
        else:
            counts["dense" if batch["dense"] else "per_slot"] = 1
        with spans.span("align.reads.copy_out", timed=True) as s:
            rec = _copy_out(blk, L)
        sp["copy_out_s"] += s.seconds
        s.add(records=len(rec["pair_id"]), **counts)
        for k, v in counts.items():
            self.transfer[k] += v
        return rec


def read_split(aligner: ReadAligner) -> dict:
    """The last align's host seconds by step, keyed for a stats dict:
    reads_wait_s, reads_copy_out_s, reads_concat_s."""
    return {f"reads_{k}": v for k, v in aligner.split.items()}


def _wait(event) -> None:
    """Block the host until a batch's block has reached it: its CUDA
    event (never a whole-device synchronise: other threads share the
    card).  A CPU block (event None) is complete when enqueued."""
    if event is not None:
        event.synchronize()
