"""In-engine long-query aligner (the BLAT/pblat/NUCMER replacement),
PyTorch port.

Counterpart of aligngraph_tpu/align/contig_aligner.py; its output equals
the JAX ContigAligner.align field by field.  The design is the same, but
for where the seeds are looked up:
  1. device seeding: every chunk and its reverse complement uploaded at
     once, their seeds looked up in the canonical SeedIndex on the
     aligner's device in a few batched calls
     (ops/seeding.contig_seed_hits) -> (qpos, tpos) hits per chunk and
     orientation, the hits the JAX module's per-query host lookup gives
  2. host chaining: diagonal clusters, chained into placements when
     query-collinear (absorbs large indels the way BLAT chains blocks)
  3. device tile DP: the chunk is cut into 512-base tiles; each
     (placement, tile) job gets a banded SW + traceback on the aligner's
     device (ops/banded_sw.banded_sw_posmap_auto: the hand-written CUDA
     kernels for a CUDA device, the plain torch versions on the CPU)
  4. host stitch: per-tile position maps merged into the placement's
     chunk-length pos_map; gapless holes at tile seams re-filled
  5. the loadContiAli filters (AlignGraph.cpp:841)
The host parts (_tile_diags, _fill_gapless_holes, _finalize) are copies
of the JAX module's: that module imports jax, which the machine with the
card does not have.  _cluster_and_chain and _enforce_monotone return
what the JAX module's return, faster: at tens of Mb, random 13-mer hits
make tens of thousands of clusters in one long contig (the JAX module's
loops are quadratic in them) and junk placements whose blocks the chain
DP walks (now in C++, native/chain.cpp); those loops took most of Eval's
time (PERF.md).
"""

from __future__ import annotations

import bisect
import time
from typing import List, Optional

import numpy as np
import torch

from aligngraph_tpu_torch import native
from aligngraph_tpu_torch.align.types import ContigAlignments
from aligngraph_tpu_torch.config import Config, INIT_CONTIG_THRESHOLD
from aligngraph_tpu_torch.io.formalize import Contigs
from aligngraph_tpu_torch.ops.banded_sw import banded_sw_posmap_auto
from aligngraph_tpu_torch.ops.seeding import (
    SeedIndex, build_index, contig_seed_hits)

TILE = 512
# every tile re-anchors its diagonal from its own seed hits (_tile_diags),
# so the band only absorbs within-tile drift (small indels); W = 32 is one
# warp in the CUDA kernels
TILE_PAD = 16
CLUSTER_GAP = 1000        # diagonal distance that separates clusters
MAX_JOIN_GAP = 20_000     # max genome gap when chaining clusters
MAX_Q_OVERLAP = 200       # allowed query overlap when chaining
MAX_PLACEMENTS = 4
# tile jobs per DP call.  Lanes are independent and padding lanes have
# tlen 0 (score 0, pos_map all -1), so the batch size changes only the
# speed, never the output (tests/test_torch_contig_aligner.py)
DP_BATCH = {"cuda": 2048, "cpu": 512}

_COMP_NP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def _revcomp_np(seq: np.ndarray) -> np.ndarray:
    return _COMP_NP[seq][::-1]


def query_segments(contigs: Contigs) -> List[np.ndarray]:
    """Every chunk forward, then its reverse complement: segment 2c + fr
    is chunk c in orientation fr, as align probes them."""
    out = []
    for c in range(contigs.n_chunks):
        fwd = np.asarray(contigs.chunk_seq(c), np.int8)
        out += [fwd, _revcomp_np(fwd)]
    return out


def _cluster_and_chain(qpos: np.ndarray, tpos: np.ndarray, chunk_len: int,
                       min_votes: int,
                       max_join_gap: int = MAX_JOIN_GAP) -> List[dict]:
    """Seed hits -> chained placements.

    Returns list of dicts {clusters: [(diag, qmin, qmax, votes)], votes}.

    The hits sorted by (diag, qpos) hold each cluster as one run, so a
    cluster is a slice: its diag is the run's first, qmin/qmax reduce over
    the run.  The work must stay linear in the hits: on a 64 Mb genome
    random 13-mer hits come at about one a seed, each a cluster.
    """
    if len(qpos) == 0:
        return []
    diag = tpos.astype(np.int64) - qpos.astype(np.int64)
    order = np.lexsort((qpos, diag))
    d, q = diag[order], qpos[order]
    new = np.empty(len(d), bool)
    new[0] = True
    new[1:] = (d[1:] - d[:-1]) > CLUSTER_GAP
    starts = np.flatnonzero(new)
    votes = np.diff(np.append(starts, len(d)))
    qmin = np.minimum.reduceat(q, starts)
    qmax = np.maximum.reduceat(q, starts)
    cl = []
    for i in np.flatnonzero(votes >= min_votes):
        s, e = starts[i], starts[i] + votes[i]
        cl.append(dict(diag=int(d[s]), qmin=int(qmin[i]), qmax=int(qmax[i]),
                       votes=int(votes[i]), q=q[s:e], d=d[s:e]))
    if not cl:
        return []
    # chain query-collinear clusters (large indel = diagonal jump)
    cl.sort(key=lambda c: (c["qmin"], c["diag"]))
    chains = [[cl[i] for i in ch] for ch in _chain(cl, max_join_gap)]
    out = []
    for chain in chains:
        out.append(dict(clusters=chain,
                        votes=sum(c["votes"] for c in chain)))
    out.sort(key=lambda p: (-p["votes"],
                            p["clusters"][0]["diag"]))
    return out[:MAX_PLACEMENTS]


def _chain(cl: List[dict], max_join_gap: int) -> List[List[int]]:
    """Greedy chains over clusters sorted by (qmin, diag), as indices:
    each unused cluster i starts a chain, which takes, again and again,
    the first unused cluster after the one it took last that joins its
    last (query gap > -MAX_Q_OVERLAP, -MAX_Q_OVERLAP < target gap <
    max_join_gap, diagonals closer than max_join_gap).

    A joining cluster's diagonal lies within max_join_gap of the last's,
    so only the three diagonal buckets of width max_join_gap around it
    are searched, each in cluster order: the work stays near linear for
    random clusters spread over the genome."""
    qmin = [c["qmin"] for c in cl]
    qmax = [c["qmax"] for c in cl]
    diag = [c["diag"] for c in cl]
    buckets: dict = {}
    for j, d in enumerate(diag):
        buckets.setdefault(d // max_join_gap, []).append(j)
    used = [False] * len(cl)
    chains = []
    for i in range(len(cl)):
        if used[i]:
            continue
        used[i] = True
        chain = [i]
        p = i
        while True:
            nxt = None
            b = diag[p] // max_join_gap
            for lst in (buckets.get(b - 1), buckets.get(b),
                        buckets.get(b + 1)):
                if not lst:
                    continue
                for j in lst[bisect.bisect_right(lst, p):]:
                    if nxt is not None and j > nxt:
                        break
                    tgap = (diag[j] + qmin[j]) - (diag[p] + qmax[p])
                    if (not used[j] and qmin[j] - qmax[p] > -MAX_Q_OVERLAP
                            and -MAX_Q_OVERLAP < tgap < max_join_gap
                            and abs(diag[j] - diag[p]) < max_join_gap):
                        nxt = j
                        break
            if nxt is None:
                break
            used[nxt] = True
            chain.append(nxt)
            p = nxt
        chains.append(chain)
    return chains


def _tile_diags(chain: List[dict], n_tiles: int) -> np.ndarray:
    """Per-tile diagonal estimate: min hit diagonal within the tile;
    carry forward previous tile's estimate for hitless tiles within the
    chain's query span."""
    td = np.full(n_tiles, 2**62, np.int64)
    qlo = min(c["qmin"] for c in chain)
    qhi = max(c["qmax"] for c in chain)
    for c in chain:
        t = (c["q"] // TILE).astype(np.int64)
        np.minimum.at(td, t, c["d"])
    has = td != 2**62
    # carry forward inside [qlo, qhi] tile range
    t0, t1 = qlo // TILE, qhi // TILE
    last = None
    for t in range(t0, min(t1 + 1, n_tiles)):
        if has[t]:
            last = td[t]
        elif last is not None:
            td[t] = last
            has[t] = True
    return np.where(has, td, 2**62), has


def _enforce_monotone(pos_map: np.ndarray) -> None:
    """Keep the maximum-weight strictly-increasing chain of M-blocks.

    Real BLAT PSL blocks are strictly increasing in both query and target;
    the per-tile DP can map bases on either side of a tile seam to the
    same (or an earlier) target position, and a repeated target position
    would make the reference's ContiMer walk (AlignGraph.cpp:2063-2089)
    loop forever.  Chaining at the block level keeps the real alignment
    and sheds the junk (a greedy keep-earlier rule would let junk truncate
    the true suffix)."""
    idx = np.nonzero(pos_map >= 0)[0]
    if len(idx) < 2:
        return
    # M-blocks: runs of consecutive source bases with consecutive targets
    vals = pos_map[idx]
    brk = np.nonzero((np.diff(idx) != 1) | (np.diff(vals) != 1))[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [len(idx)]])
    if len(starts) == 1:
        return
    t0 = vals[starts]
    t1 = vals[ends - 1] + 1
    if np.all(t0[1:] >= t1[:-1]):
        return                      # already strictly increasing
    m = len(starts)
    w = (ends - starts).astype(np.int64)
    # junk placements (random seed clusters) carry thousands of blocks:
    # the C++ loop when g++ built it, else the numpy one
    dp = native.monotone_chain_native(t0, t1, w)
    best, parent, trim = dp if dp is not None else _chain_dp(t0, t1, w)
    keep = np.zeros(m, bool)
    i = int(np.argmax(best))                # first max on ties
    while i >= 0:
        keep[i] = True
        i = int(parent[i])
    for k in np.nonzero(~keep)[0]:
        pos_map[idx[starts[k]]:idx[ends[k] - 1] + 1] = -1
    for k in np.nonzero(keep & (trim > 0))[0]:
        cut = idx[starts[k] + trim[k] - 1] + 1
        pos_map[idx[starts[k]]:cut] = -1


def _chain_dp(t0: np.ndarray, t1: np.ndarray, w: np.ndarray):
    """Weighted chain DP over M-blocks with target-overlap trimming ->
    (best, parent, trim): a successor block may overlap its predecessor's
    target span, and the overlapped prefix is trimmed off (local SW
    chance-extends block ends past true breakpoints, so exact non-overlap
    chaining would disqualify the real continuation).  The predecessor is
    the first j of largest gain (deterministic).  native/chain.cpp runs
    the same loop."""
    m = len(w)
    best = w.copy()
    parent = np.full(m, -1, np.int64)
    trim = np.zeros(m, np.int64)
    for i in range(1, m):
        ov = np.maximum(t1[:i] - t0[i], 0)
        kept_w = w[i] - ov
        gain = np.where(kept_w > 0, best[:i] + kept_w, -1)
        j = int(np.argmax(gain))            # first max (deterministic)
        if gain[j] > best[i]:
            best[i] = gain[j]
            parent[i] = j
            trim[i] = ov[j]
    return best, parent, trim


def _fill_gapless_holes(pos_map: np.ndarray) -> None:
    """Re-align interior holes where both flanks agree on a gapless join
    (local SW trims mismatching tile ends; PSL blocks keep them)."""
    idx = np.nonzero(pos_map >= 0)[0]
    if len(idx) < 2:
        return
    gaps_at = np.nonzero(np.diff(idx) > 1)[0]
    for k in gaps_at:
        i0, i1 = idx[k], idx[k + 1]
        if pos_map[i1] - pos_map[i0] == i1 - i0:
            pos_map[i0:i1 + 1] = pos_map[i0] + np.arange(i1 - i0 + 1)


class ContigAligner:
    """Aligns formalized contig chunks to the genome; the seeding and the
    tile DP run on `device`.

    index: a seed index of `genome_codes`.  One on `device` (a
    ReadAligner's, which shares it) is used as it is; one on the CPU
    (build_index returns one) is moved there once; one on another device
    raises.
    """

    def __init__(self, genome_codes: np.ndarray, cfg: Config,
                 index: Optional[SeedIndex] = None,
                 max_join_gap: int = MAX_JOIN_GAP,
                 accept: tuple = (INIT_CONTIG_THRESHOLD,
                                  INIT_CONTIG_THRESHOLD, 200), *, device):
        self.genome_np = np.asarray(genome_codes, np.int8)
        device = torch.device(device)
        if device.type not in DP_BATCH:
            raise ValueError(f"no contig-aligner path for device {device}")
        # "cuda" -> the current card, as the tensors placed there name it
        self.device = torch.empty(0, device=device).device
        self.cfg = cfg
        if index is None:
            index = build_index(self.genome_np, cfg.seed_len)
        at = index.sorted_kmers.device
        if at != self.device:
            if at.type != "cpu":
                raise ValueError(f"seed index on {at}, aligner on "
                                 f"{self.device}: pass an index on either "
                                 f"the aligner's device or the CPU")
            index = index.to(self.device)
        self.index = index
        self.stride = 32 if cfg.fast_map else 16
        self.min_votes = 4 if cfg.fast_map else 2
        self.max_join_gap = max_join_gap
        # (src_ratio, tgt_ratio, min_size) acceptance — the C12 loadContiAli
        # filter for the assembler path; eval/misassembly consumers pass
        # relaxed values and filter themselves (0.1 thresholds)
        self.accept = accept
        self.dp_batch = DP_BATCH[self.device.type]
        # the last seed_hits call's seeds, hits, batches and batch bytes
        self.seeding: dict = {}
        # the last align's seconds in _finalize
        self.finalize_s = 0.0

    # ------------------------------------------------------------------
    def seed_hits(self, seqs: List[np.ndarray]):
        """Forward-matching seed hits of the query segments `seqs` (int8
        codes), all looked up at once on the aligner's device -> host
        int64 (offsets, qpos, tpos): segment s's hits are
        qpos[offsets[s]:offsets[s + 1]] and the same slice of tpos, each
        the JAX module's _seed_hits(seqs[s]).  The segments go up in one
        copy and the hits come down in one."""
        lens = [len(s) for s in seqs]
        flat = np.concatenate(seqs) if seqs else np.zeros(0, np.int8)
        hits = contig_seed_hits(self.index,
                                torch.from_numpy(flat).to(self.device),
                                lens, self.stride)
        n, H = len(seqs) + 1, len(hits.qpos)
        buf = torch.cat([hits.offsets, hits.qpos, hits.tpos]).cpu().numpy()
        self.seeding = dict(seeds=hits.seeds, hits=H, batches=hits.batches,
                            batch_bytes=hits.batch_bytes)
        return buf[:n], buf[n:n + H], buf[n + H:]

    # ------------------------------------------------------------------
    def align(self, contigs: Contigs) -> ContigAlignments:
        jobs = []       # (placement_idx, tile_start, tile_seq, tlen, g0)
        placements = []  # (chunk_id, fr, chunk_len, pos_map buffer)
        seqs = query_segments(contigs)
        off, qpos, tpos = self.seed_hits(seqs)
        for i, seq in enumerate(seqs):
            c, fr = divmod(i, 2)
            n_tiles = (len(seq) + TILE - 1) // TILE
            a, b = off[i], off[i + 1]
            chains = _cluster_and_chain(qpos[a:b], tpos[a:b], len(seq),
                                        self.min_votes, self.max_join_gap)
            for ch in chains:
                td, has = _tile_diags(ch["clusters"], n_tiles)
                pid = len(placements)
                placements.append(dict(
                    chunk_id=c, fr=fr, length=len(seq),
                    pos_map=np.full(len(seq), -1, np.int32)))
                for t in range(n_tiles):
                    if not has[t]:
                        continue
                    ts = t * TILE
                    tile = np.full(TILE, 4, np.int8)
                    piece = seq[ts:ts + TILE]
                    tile[:len(piece)] = piece
                    g0 = int(td[t]) + ts
                    jobs.append((pid, ts, tile, len(piece), g0))
        self._run_tile_jobs(jobs, placements)
        t = time.perf_counter()
        out = self._finalize(placements, contigs)
        self.finalize_s = time.perf_counter() - t
        return out

    # ------------------------------------------------------------------
    def _run_tile_jobs(self, jobs, placements):
        G = len(self.genome_np)
        W = 2 * TILE_PAD
        bs = self.dp_batch
        dev = self.device
        for s in range(0, len(jobs), bs):
            blk = jobs[s:s + bs]
            tiles = np.full((bs, TILE), 4, np.int8)
            tlens = np.zeros(bs, np.int32)
            g0s = np.zeros(bs, np.int32)
            for k, (pid, ts, tile, plen, g0) in enumerate(blk):
                tiles[k] = tile
                tlens[k] = plen
                g0s[k] = np.clip(g0, -(2**30), 2**30)
            x = g0s[:, None] - TILE_PAD + np.arange(TILE + W)[None, :]
            ok = (x >= 0) & (x < G)
            windows = np.where(ok, self.genome_np[np.clip(x, 0, G - 1)],
                               np.int8(4))
            # DP + gapless fast path: most tiles are indel-free and get
            # their pos_map synthesized; the rest take the traceback
            _, pm_d = banded_sw_posmap_auto(
                *(torch.from_numpy(a).to(dev)
                  for a in (tiles, tlens, windows, g0s)), pad=TILE_PAD)
            pm = pm_d.cpu().numpy()
            for k, (pid, ts, tile, plen, g0) in enumerate(blk):
                seg = pm[k, :plen]
                dst = placements[pid]["pos_map"][ts:ts + plen]
                np.copyto(dst, seg, where=seg >= 0)

    # ------------------------------------------------------------------
    def _finalize(self, placements, contigs: Contigs) -> ContigAlignments:
        rows = dict(chunk_id=[], fr=[], score=[], source_start=[],
                    source_end=[], source_gap=[], source_size=[],
                    target_start=[], target_end=[], target_gap=[])
        maps = []
        for p in placements:
            pm = p["pos_map"]
            _enforce_monotone(pm)
            _fill_gapless_holes(pm)
            aligned = np.nonzero(pm >= 0)[0]
            if len(aligned) == 0:
                continue
            ss, se = int(aligned[0]), int(aligned[-1]) + 1
            m = len(aligned)
            qgap = (se - ss) - m
            ts = int(pm[aligned].min())
            te = int(pm[aligned].max()) + 1
            tgap = (te - ts) - m
            size = p["length"]
            # loadContiAli filter (AlignGraph.cpp:841) — thresholds per
            # consumer (self.accept)
            a_src, a_tgt, a_size = self.accept
            if not (size > a_size
                    and (se - ss - qgap) / size >= a_src
                    and (te - ts - tgap) / max(te - ts, 1) >= a_tgt):
                continue
            rows["chunk_id"].append(p["chunk_id"])
            rows["fr"].append(p["fr"])
            rows["score"].append(m)
            rows["source_start"].append(ss)
            rows["source_end"].append(se)
            rows["source_gap"].append(qgap)
            rows["source_size"].append(size)
            rows["target_start"].append(ts)
            rows["target_end"].append(te)
            rows["target_gap"].append(tgap)
            maps.append(pm)
        return ContigAlignments(
            chunk_id=np.array(rows["chunk_id"], np.int32),
            fr=np.array(rows["fr"], np.int8),
            score=np.array(rows["score"], np.int32),
            source_start=np.array(rows["source_start"], np.int32),
            source_end=np.array(rows["source_end"], np.int32),
            source_gap=np.array(rows["source_gap"], np.int32),
            source_size=np.array(rows["source_size"], np.int32),
            target_start=np.array(rows["target_start"], np.int32),
            target_end=np.array(rows["target_end"], np.int32),
            target_gap=np.array(rows["target_gap"], np.int32),
            pos_map=maps,
        )
