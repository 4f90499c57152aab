"""The PE read aligner of the plain reference.

Frozen copy of aligngraph_tpu_torch/align/read_aligner.py at commit
5fa5dc4: one batch's alignment (_align_core), the C13 filter and the
records of the full [P, K] layout (_expand_full), with the plain banded
SW of reference/banded_sw.py in place of the dispatch to the kernels.
The port compacts a batch's records into a transfer buffer and decodes
it; the reference reads them from the full layout, as the port does for
a batch that overflows its buffer.  It imports nothing of the port.

align_batch gives the records of one of the program's batches: pairs
[start, start + cnt) in a batch of P pairs (batch_shape, the port's
rule), so that the DP capacity, and with it which candidates a batch
sheds, is the program's.
"""

from __future__ import annotations

import numpy as np
import torch

from agbench.reference.banded_sw import posmap
from agbench.reference.seeding import (
    INVALID_DIAG, SeedIndex, lookup_seeds_bucketed, pack_query_seeds,
    rc_packed, select_candidates, sort_pairs,
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
                seed_len, stride, pad, C, K, dlow, dhigh, mh, gapless):
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
    sw_score, pos_map = posmap(
        creads, torch.where(cvalid, clens, 0), windows, diag_safe, pad=pad,
        smin=score_min, gapless=gapless)
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



def genome_padded(genome: np.ndarray, device) -> torch.Tensor:
    """The genome with GENOME_PAD 4s on both flanks, on `device`."""
    gp = np.full(len(genome) + 2 * GENOME_PAD, 4, np.int8)
    gp[GENOME_PAD:GENOME_PAD + len(genome)] = genome
    return torch.from_numpy(gp).to(device)


def batch_shape(cnt: int, batch_pairs: int) -> int:
    """The port's batch shape for cnt pairs: the next power of two >=
    1024, capped at batch_pairs, rounded up to a multiple of 128."""
    P = min(batch_pairs, max(1024, 1 << (max(cnt, 1) - 1).bit_length()))
    return -(-P // 128) * 128


def align_batch(genome_p, index: SeedIndex, data: np.ndarray,
                lens: np.ndarray, start: int, cnt: int, P: int, p: dict,
                *, c13: bool = True, gapless: bool = False) -> dict:
    """The accepted records of pairs [start, start + cnt) (data: int8
    [2n, L] mate-interleaved, lens [n]) aligned as one batch of P pairs
    with the parameters p (seed_len, seed_stride, band_pad,
    max_candidates, max_seed_hits, distance_low, distance_high) -> host
    numpy arrays by PairAlignments field, in (pair, k) order."""
    dev = genome_p.device
    L = max(data.shape[1], p["seed_len"])
    seqs = torch.full((2 * P, L), 4, dtype=torch.int8)
    plens = torch.zeros(P, dtype=torch.int32)
    seqs[:2 * cnt, :data.shape[1]] = torch.from_numpy(
        np.ascontiguousarray(data[2 * start:2 * (start + cnt)]))
    plens[:cnt] = torch.from_numpy(
        np.ascontiguousarray(lens[start:start + cnt], np.int32))
    seqs, plens = seqs.to(dev), plens.to(dev)
    rc = revcomp_padded(seqs, plens.repeat_interleave(2))
    smin = torch.from_numpy(score_min_table(L)).to(dev)
    out = _align_core(
        genome_p, index, seqs, rc, plens, smin, seed_len=p["seed_len"],
        stride=p["seed_stride"], pad=p["band_pad"], C=p["max_candidates"],
        K=MAX_PAIR_HITS, dlow=p["distance_low"], dhigh=p["distance_high"],
        mh=p["max_seed_hits"], gapless=gapless)
    if c13:
        out["valid"] = out["valid"] & c13_mask(out)
    rec, n = _expand_full(out, start, cnt, L)
    n = int(n)
    return {k: v[:n].cpu().numpy() for k, v in rec.items()}
