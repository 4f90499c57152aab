"""In-engine PE short-read aligner (the bowtie2 replacement), PyTorch port.

Counterpart of aligngraph_tpu/align/read_aligner.py; its output equals the
JAX ReadAligner.align field by field.  Reference invocation replaced
(AlignGraph.cpp:3601-3609):
  bowtie2 -f --no-mixed -k 5 --local --mp 3,1 --rdg 2,1 --rfg 2,1
          --score-min G,5,2 -I distanceLow -X distanceHigh
          --no-discordant --reorder

Per batch of P pairs, on the aligner's device:
  1. both orientations of every mate (the reverse complement on the host)
  2. seed lookup in the canonical k-mer genome index (ops/seeding.py)
  3. candidate diagonals by clustered seed votes, then a rank-major
     validity compaction to TOP rows
  4. banded affine local SW + traceback (ops/banded_sw.py; the CUDA
     kernels for CUDA tensors)
  5. per-candidate parse quantities (parseBOWTIE equivalents)
  6. PE pairing: opposite strands, facing orientation, fragment length in
     [distanceLow, distanceHigh], per-mate score >= 5 + 2*ln(len), top-K
     pairs by combined score, deterministic tie-break (fragment start)
and on the host the full-layout record extraction with the C13 ratio
filter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.formalize import Reads
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

_COMP_NP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def revcomp_padded_np(seqs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse-complement padded reads: rc[i] = comp(seq[len-1-i]) for
    i < len, pad 4 beyond."""
    R, L = seqs.shape
    if np.all(lens == L):
        return _COMP_NP[seqs[:, ::-1]]
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(L)[None, :]
    ok = idx >= 0
    vals = np.take_along_axis(seqs, np.clip(idx, 0, L - 1), axis=1)
    return np.where(ok, _COMP_NP[vals], np.int8(4))


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


def _c13_mask_np(out: dict) -> np.ndarray:
    """C13 (AlignGraph.cpp:1261) over the full [P, K] layout: both mates
    (se-ss-I)/size >= 0.6 and (te-ts-D)/(te-ts) >= 0.6, exact in integers
    since 0.6 == 3/5."""
    ss, se, sg = out["src_start"], out["src_end"], out["src_gap"]
    sz = out["src_size"]
    ts, te, tg = out["tgt_start"], out["tgt_end"], out["tgt_gap"]
    ok = ((se - ss - sg) * 5 >= 3 * sz) & ((te - ts - tg) * 5
                                           >= 3 * (te - ts))
    return ok.all(axis=-1)


def reconstruct_pos_map(segs: np.ndarray, L: int) -> np.ndarray:
    """Host: segments [..., MAXSEG, 3] -> pos_map [..., L] int32."""
    lead = segs.shape[:-2]
    pm = np.full(lead + (L,), -1, np.int32)
    idx = np.arange(L, dtype=np.int32)
    for s in range(segs.shape[-2]):
        st = segs[..., s, 0:1]
        ts = segs[..., s, 1:2]
        sz = segs[..., s, 2:3]
        m = (sz > 0) & (idx >= st) & (idx < st + sz)
        pm = np.where(m, ts + (idx - st), pm)
    return pm


def _expand_full(res, start: int, cnt: int, L: int) -> dict:
    """Host extraction of the accepted records from the full [P, K]
    layout (pairs past `cnt` are batch padding)."""
    p_ids, k_ids = np.nonzero(res["valid"][:cnt])
    sel = (p_ids, k_ids)
    return dict(
        pair_id=(p_ids + start).astype(np.int32),
        fr=res["fr"][sel],
        score=res["score"][sel],
        source_start=res["src_start"][sel],
        source_end=res["src_end"][sel],
        source_gap=res["src_gap"][sel],
        source_size=res["src_size"][sel],
        target_start=res["tgt_start"][sel],
        target_end=res["tgt_end"][sel],
        target_gap=res["tgt_gap"][sel],
        pos_map=reconstruct_pos_map(res["segs"][sel], L),
    )


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

    @classmethod
    def build(cls, genome_codes: np.ndarray, cfg: Config,
              batch_pairs: int = 32768, c13: bool = True, *,
              device) -> "ReadAligner":
        """Index the genome on the host, then place both on `device`."""
        return cls.from_index(genome_codes,
                              build_index(genome_codes, cfg.seed_len), cfg,
                              batch_pairs=batch_pairs, c13=c13,
                              device=device)

    @classmethod
    def from_index(cls, genome_codes: np.ndarray, index: SeedIndex,
                   cfg: Config, batch_pairs: int = 32768, c13: bool = True,
                   *, device) -> "ReadAligner":
        """An aligner over a seed index built elsewhere (SeedIndex.from_numpy
        carries the JAX package's index across)."""
        if index.seed_len != cfg.seed_len:
            raise ValueError(f"index seed_len {index.seed_len} != "
                             f"cfg.seed_len {cfg.seed_len}")
        if index.genome_len != len(genome_codes):
            raise ValueError(f"index genome_len {index.genome_len} != "
                             f"genome length {len(genome_codes)}")
        # align's host record extraction makes large numpy temporaries on
        # every batch; with freed pages kept on the heap they are reused
        # warm instead of faulted in afresh (utils/hostmem.py).  The host
        # times in PERF.md are taken with this setting.
        tune_host_malloc()
        gp = np.full(len(genome_codes) + 2 * GENOME_PAD, 4, np.int8)
        gp[GENOME_PAD:GENOME_PAD + len(genome_codes)] = genome_codes
        return cls(genome_p=torch.from_numpy(gp).to(device),
                   index=index.to(device), cfg=cfg, batch_pairs=batch_pairs,
                   c13=c13)

    def align(self, reads: Reads) -> PairAlignments:
        """Align all pairs; returns the accepted pair alignments (host SoA)."""
        cfg = self.cfg
        L = max(reads.max_len, cfg.seed_len)
        if L > 32767 - 2 * cfg.band_pad:
            raise ValueError(
                f"read length {L} exceeds the PE read aligner's limit "
                f"({32767 - 2 * cfg.band_pad}); long queries belong to the "
                f"contig aligner")
        dev = self.genome_p.device
        smin = torch.from_numpy(score_min_table(L)).to(dev)
        n = reads.n_pairs
        chunks = []
        for start in range(0, max(n, 1), self.batch_pairs):
            cnt = min(self.batch_pairs, n - start) if n else 0
            # batch shape: the next power of two >= 1024 pairs, capped at
            # batch_pairs, rounded up to a multiple of 128.  The DP
            # capacity TOP depends on it and candidates past TOP are shed,
            # so this rule is part of the output, not only of the speed.
            P = min(self.batch_pairs,
                    max(1024, 1 << (max(cnt, 1) - 1).bit_length()))
            P = -(-P // 128) * 128
            seqs = np.full((2 * P, L), 4, np.int8)
            plens = np.zeros(P, np.int32)
            if cnt > 0:
                blk = reads.data[2 * start:2 * (start + cnt)]
                seqs[:2 * cnt, :blk.shape[1]] = blk
                plens[:cnt] = reads.lengths[start:start + cnt]
            rcseqs = revcomp_padded_np(seqs, np.repeat(plens, 2))
            out = _align_core(
                self.genome_p, self.index, torch.from_numpy(seqs).to(dev),
                torch.from_numpy(rcseqs).to(dev),
                torch.from_numpy(plens).to(dev), smin,
                seed_len=cfg.seed_len, stride=cfg.seed_stride,
                pad=cfg.band_pad, C=cfg.max_candidates, K=MAX_PAIR_HITS,
                dlow=cfg.distance_low, dhigh=cfg.distance_high,
                mh=cfg.max_seed_hits)
            full = {k: v.cpu().numpy() for k, v in out.items()}
            if self.c13:
                full["valid"] = full["valid"] & _c13_mask_np(full)
            chunks.append(_expand_full(full, start, cnt, L))
        cat = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        return PairAlignments(**cat)
