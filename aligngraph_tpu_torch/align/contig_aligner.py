"""In-engine long-query aligner (the BLAT/pblat/NUCMER replacement),
PyTorch port.

Counterpart of aligngraph_tpu/align/contig_aligner.py; its output equals
the JAX ContigAligner.align field by field.  The design is the same, but
everything from the seeds to the tile DP's batches stays on the
aligner's device, and only the greedy chain runs on the host:
  1. device seeding: the real contigs go up end to end in one copy (a
     reused staging buffer, pinned for a CUDA aligner), every chunk and
     its reverse complement are laid out from them on the device (one
     flat buffer of segments, segment_layout), their seeds looked up in
     the canonical SeedIndex in a few batched calls
     (ops/seeding.contig_seed_hits) -> (qpos, tpos) hits per segment, the
     hits the JAX module's per-query host lookup gives
  2. device clustering (cluster_hits): the hits of every segment sorted
     by (segment, diagonal) and cut into diagonal clusters; the kept
     clusters' summaries come to the host in one copy
  3. host chaining (chain_clusters, _chain): clusters chained into
     placements when query-collinear (absorbs large indels the way BLAT
     chains blocks), near linear in the clusters
  4. device tile jobs (build_tile_jobs): each placement's 512-base tiles
     get a diagonal (the least of the tile's hits, carried forward over
     hitless tiles), and the held tiles are the jobs; each DP batch's
     tiles and genome windows are gathered on the device (TileJobs.batch)
  5. device tile DP: a banded SW + traceback a job
     (ops/banded_sw.banded_sw_posmap_auto: the hand-written CUDA kernels
     for a CUDA device, the plain torch versions on the CPU), its
     position map scattered into the placements' one flat buffer
     (Placements)
  6. device finalize, every placement at once (finalize_placements): the
     strictly increasing chain of M-blocks (the chain DP in
     ops/monotone_chain: the hand-written CUDA kernel on a CUDA device),
     gapless holes at tile seams re-filled, the row fields and the
     loadContiAli filters (AlignGraph.cpp:841); then one copy of the
     kept rows and position maps to the host (one a pass of at most
     FINALIZE_PASS_BASES buffer bases, which bounds the device's
     temporaries)
Steps 2-4 are the JAX module's _cluster_and_chain, _tile_diags, the job
loop of align and _run_tile_jobs' batch fill, bit for bit; the same torch
code runs on a CPU aligner.  _cluster_and_chain is steps 2-3 for one
segment, returning the JAX module's dicts.  _enforce_monotone, _chain_dp
and _fill_gapless_holes are the per-placement host versions of step 6
(the JAX module's _finalize runs them), kept as the tests' oracles.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from aligngraph_tpu_torch import native
from aligngraph_tpu_torch.align.read_aligner import GENOME_PAD, window_slices
from aligngraph_tpu_torch.align.types import ContigAlignments
from aligngraph_tpu_torch.config import Config, INIT_CONTIG_THRESHOLD
from aligngraph_tpu_torch.io.formalize import Contigs
from aligngraph_tpu_torch.ops.banded_sw import banded_sw_posmap_auto
from aligngraph_tpu_torch.ops.monotone_chain import monotone_chain
from aligngraph_tpu_torch.ops.seeding import (
    ContigSeedHits, SeedIndex, build_index, contig_seed_hits)
from aligngraph_tpu_torch.utils import spans

TILE = 512
# every tile re-anchors its diagonal from its own seed hits
# (build_tile_jobs), so the band only absorbs within-tile drift (small
# indels); W = 32 is one warp in the CUDA kernels
TILE_PAD = 16
CLUSTER_GAP = 1000        # diagonal distance that separates clusters
MAX_JOIN_GAP = 20_000     # max genome gap when chaining clusters
MAX_Q_OVERLAP = 200       # allowed query overlap when chaining
MAX_PLACEMENTS = 4
# tile jobs per DP call.  Lanes are independent and padding lanes have
# tlen 0 (score 0, pos_map all -1), so the batch size changes only the
# speed, never the output (tests/test_torch_contig_aligner.py)
DP_BATCH = {"cuda": 2048, "cpu": 512}
# an align's layers, as ContigAligner.layer_s times them (its spans
# align.contigs.<layer>)
LAYERS = ("seed", "cluster", "chain", "tile_diags", "dp", "finalize")

# output bases a piece of segment_layout: its int32 temporaries are
# 16 MB each
LAYOUT_PIECE = 1 << 22

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


def segment_layout(fwd: torch.Tensor, contigs: Contigs) -> torch.Tensor:
    """np.concatenate(query_segments(contigs)) built on fwd's device from
    fwd, contigs.seqs end to end (int8 codes): segment 2c is chunk c,
    fwd[g:g + chunk_len[c]] with g its real's first base plus
    chunk_start[c], and segment 2c + 1 its reverse complement (codes 0-3
    -> 3 - x, 4 kept).  Any chunk table whose chunks lie inside their
    reals will do.  Built in pieces of at most LAYOUT_PIECE output bases
    with int32 offsets, so its temporaries stay small whatever the
    segments' size; nothing waits for the device."""
    dev = fwd.device
    clen = np.asarray(contigs.chunk_len, np.int64)
    real0 = np.cumsum([0] + [len(s) for s in contigs.seqs])
    g = (real0[np.asarray(contigs.chunk_real, np.int64)]
         + np.asarray(contigs.chunk_start, np.int64))
    start = np.concatenate([[0], np.cumsum(np.repeat(clen, 2))])
    N = int(start[-1])
    # each segment's first source base: a reverse one reads down from
    # its chunk's last
    first = np.repeat(g, 2)
    first[1::2] += clen - 1
    src_dtype = torch.int32 if len(fwd) < 2**31 else torch.int64
    start_d = torch.from_numpy(start).to(dev)
    first_d = torch.from_numpy(first).to(dev, src_dtype)
    out = torch.empty(N, dtype=torch.int8, device=dev)
    for a in range(0, N, LAYOUT_PIECE):
        b = min(a + LAYOUT_PIECE, N)
        # the segments that overlap [a, b): the last to start at or
        # before a (zero-length ones skipped) to the last to start
        # before b
        s0 = int(np.searchsorted(start, a, "right")) - 1
        s1 = int(np.searchsorted(start, b, "left"))
        st = (start_d[s0:s1] - a).to(torch.int32)
        loc = torch.arange(b - a, dtype=torch.int32, device=dev)
        k = torch.searchsorted(st, loc, right=True, out_int32=True) - 1
        off = loc - st.index_select(0, k)
        del loc
        rev = ((k + (s0 & 1)) & 1).bool()
        src = first_d[s0:s1].index_select(0, k) + torch.where(rev, -off, off)
        del k, off
        v = fwd.index_select(0, src)
        del src
        out[a:b] = torch.where(rev & (v < 4), 3 - v, v)
    return out


def _cluster_and_chain(qpos: np.ndarray, tpos: np.ndarray, chunk_len: int,
                       min_votes: int,
                       max_join_gap: int = MAX_JOIN_GAP) -> List[dict]:
    """Seed hits of one segment -> chained placements, the JAX module's
    dicts: {clusters: [{diag, qmin, qmax, votes, q, d}], votes}.

    cluster_hits then chain_clusters on the CPU, the hits first put in
    query order (stably), so that each cluster's q and d are in the JAX
    module's (diag, qpos) order.  The work stays near linear in the hits:
    on a 64 Mb genome random 13-mer hits come at about one a seed, each a
    cluster."""
    o = np.argsort(np.asarray(qpos, np.int64), kind="stable")
    q_t, t_t = (torch.from_numpy(np.asarray(a, np.int64)[o])
                for a in (qpos, tpos))
    cl = cluster_hits(q_t, t_t, torch.tensor([0, len(o)]), min_votes)
    ch = chain_clusters(cl, max_join_gap)
    q, d = cl.q.numpy(), cl.d.numpy()
    out = []
    for p in range(len(ch.seg)):
        chain = []
        for k in ch.members[ch.moff[p]:ch.moff[p + 1]]:
            a, b = cl.start[k], cl.start[k] + cl.votes[k]
            chain.append(dict(diag=int(cl.diag[k]), qmin=int(cl.qmin[k]),
                              qmax=int(cl.qmax[k]), votes=int(cl.votes[k]),
                              q=q[a:b], d=d[a:b]))
        out.append(dict(clusters=chain, votes=int(ch.votes[p])))
    return out


@dataclasses.dataclass
class HitClusters:
    """The diagonal clusters of every segment's seed hits.  Sorted by
    (segment, diagonal), the hits hold each cluster as one run; on the
    hits' device, hit i of that order has diagonal d[i], query position
    q[i] and run run[i] (runs numbered in that order).  The runs of at
    least min_votes hits are kept and summarised on the host, in run
    order: kept[k] is the run, seg[k] its segment, diag[k] its first
    (least) diagonal, qmin[k] and qmax[k] its query span, votes[k] its
    hits and start[k] its first hit."""
    d: torch.Tensor           # [H] int64
    q: torch.Tensor           # [H] int64
    run: torch.Tensor         # [H] int64
    kept: np.ndarray          # [K] int64, and the rest [K] int64 too
    seg: np.ndarray
    diag: np.ndarray
    qmin: np.ndarray
    qmax: np.ndarray
    votes: np.ndarray
    start: np.ndarray


def cluster_hits(qpos: torch.Tensor, tpos: torch.Tensor,
                 offsets: torch.Tensor, min_votes: int) -> HitClusters:
    """The first half of the JAX module's _cluster_and_chain for every
    segment at once, on the hits' device: segment s's hits are
    qpos[offsets[s]:offsets[s + 1]] and the same slice of tpos (int64).
    A stable sort by (segment, diag = tpos - qpos); a run starts where
    the segment changes or the diagonal steps by more than CLUSTER_GAP.
    Order among equal diagonals changes no run's figures: its votes,
    qmin and qmax are reductions and its diag is its least.  The runs
    are reduced into [H] arrays (no host sync); the kept ones' count is
    the one sync, then one copy of their summaries to the host."""
    dev = qpos.device
    H = qpos.numel()
    seg = torch.repeat_interleave(
        torch.arange(offsets.numel() - 1, device=dev), offsets.diff(),
        output_size=H)
    diag = tpos - qpos
    # positions and query offsets are under 2^31, so diag + 2^31 takes
    # the low 32 bits of the key
    order = torch.sort((seg << 32) | (diag + 2**31), stable=True).indices
    d, q, seg = diag[order], qpos[order], seg[order]
    del diag, order
    new = torch.ones(H, dtype=torch.bool, device=dev)
    new[1:] = (seg[1:] != seg[:-1]) | (d[1:] - d[:-1] > CLUSTER_GAP)
    run = torch.cumsum(new, 0) - 1
    del new
    votes = torch.zeros(H, dtype=torch.int64, device=dev).index_add_(
        0, run, torch.ones_like(run))
    start = torch.full((H,), H, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, run, torch.arange(H, device=dev), "amin")
    qmin = torch.full((H,), 2**62, dtype=torch.int64, device=dev)
    qmin.scatter_reduce_(0, run, q, "amin")
    qmax = torch.full((H,), -1, dtype=torch.int64, device=dev)
    qmax.scatter_reduce_(0, run, q, "amax")
    kept = torch.nonzero((votes >= min_votes) & (votes > 0)).squeeze(1)
    first = start[kept]
    host = torch.stack([kept, seg[first], d[first], qmin[kept], qmax[kept],
                        votes[kept], first]).cpu().numpy()
    return HitClusters(d, q, run, *host)


@dataclasses.dataclass
class Chains:
    """Placements: greedy chains of kept clusters (HitClusters' indices),
    every segment's in the JAX module's order (by votes, descending, then
    the first cluster's diag; at most MAX_PLACEMENTS), segment after
    segment.  Placement p is in segment seg[p], spans query bases
    qlo[p]..qhi[p] and holds the clusters members[moff[p]:moff[p + 1]],
    in chain order, with votes[p] hits in all."""
    seg: np.ndarray           # [P] int64
    qlo: np.ndarray           # [P] int64
    qhi: np.ndarray           # [P] int64
    votes: np.ndarray         # [P] int64
    members: np.ndarray       # [M] int64
    moff: np.ndarray          # [P + 1] int64


def chain_clusters(cl: HitClusters, max_join_gap: int) -> Chains:
    """The second half of the JAX module's _cluster_and_chain on the host,
    over the kept clusters only: per segment, its clusters sorted by
    (qmin, diag) go through _chain, and its chains are sorted by (-votes,
    first cluster's diag) and cut to MAX_PLACEMENTS.  A segment with one
    kept cluster (most of them) has that cluster as its one placement
    without the loop."""
    K = len(cl.seg)
    if K == 0:
        z = np.zeros(0, np.int64)
        return Chains(z, z, z, z, z, np.zeros(1, np.int64))
    order = np.lexsort((cl.diag, cl.qmin, cl.seg))
    sseg = cl.seg[order]
    edges = np.flatnonzero(np.diff(sseg)) + 1
    lo, hi = np.append(0, edges), np.append(edges, K)
    alone = hi - lo == 1
    # every placement's segment, rank in its segment and clusters (flat)
    p_seg, p_rank = [sseg[lo[alone]]], [np.zeros(int(alone.sum()), np.int64)]
    p_members = [order[lo[alone]]]
    p_lens = [np.ones(int(alone.sum()), np.int64)]
    qmin, qmax = cl.qmin[order].tolist(), cl.qmax[order].tolist()
    diag, votes = cl.diag[order].tolist(), cl.votes[order].tolist()
    for a, b in zip(lo[~alone].tolist(), hi[~alone].tolist()):
        chains = [[a + i for i in ch] for ch in _chain(
            qmin[a:b], qmax[a:b], diag[a:b], max_join_gap)]
        chains.sort(key=lambda ch: (-sum(votes[i] for i in ch),
                                    diag[ch[0]]))
        chains = chains[:MAX_PLACEMENTS]
        p_seg.append(np.full(len(chains), sseg[a]))
        p_rank.append(np.arange(len(chains)))
        p_members.append(order[np.concatenate(chains)])
        p_lens.append(np.array([len(ch) for ch in chains], np.int64))
    seg, rank = np.concatenate(p_seg), np.concatenate(p_rank)
    lens, flat = np.concatenate(p_lens), np.concatenate(p_members)
    # placements in (segment, rank) order, their clusters moved along
    pl = np.lexsort((rank, seg))
    moff = np.zeros(len(pl) + 1, np.int64)
    np.cumsum(lens[pl], out=moff[1:])
    starts = moff[:-1]
    src = np.repeat((np.cumsum(lens) - lens)[pl] - starts, lens[pl])
    members = flat[src + np.arange(moff[-1])].astype(np.int64)
    return Chains(seg=seg[pl].astype(np.int64),
                  qlo=np.minimum.reduceat(cl.qmin[members], starts),
                  qhi=np.maximum.reduceat(cl.qmax[members], starts),
                  votes=np.add.reduceat(cl.votes[members], starts),
                  members=members, moff=moff)


def _chain(qmin: List[int], qmax: List[int], diag: List[int],
           max_join_gap: int) -> List[List[int]]:
    """Greedy chains over clusters sorted by (qmin, diag), as indices:
    each unused cluster i starts a chain, which takes, again and again,
    the first unused cluster after the one it took last that joins its
    last (query gap > -MAX_Q_OVERLAP, -MAX_Q_OVERLAP < target gap <
    max_join_gap, diagonals closer than max_join_gap).

    A joining cluster's diagonal lies within max_join_gap of the last's,
    so only the three diagonal buckets of width max_join_gap around it
    are searched, each in cluster order: the work stays near linear for
    random clusters spread over the genome."""
    buckets: dict = {}
    for j, d in enumerate(diag):
        buckets.setdefault(d // max_join_gap, []).append(j)
    used = [False] * len(diag)
    chains = []
    for i in range(len(diag)):
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


@dataclasses.dataclass
class TileJobs:
    """An align's tile jobs, on the aligner's device: every held tile
    (pid, t) of every placement, placement after placement, tiles
    ascending.  Job j aligns query bases ts[j]..ts[j] + tlen[j] of
    placement pid[j] (segs[src[j]:], the query segments end to end)
    against the genome from g0[j] (the tile's diagonal + ts, clipped to
    +-2^30), and its pos_map goes to the placements' buffer at dst[j].
    Placement p is chunk chunk_id[p] in orientation fr[p], length[p]
    bases (host numpy)."""
    chunk_id: np.ndarray      # [P] int32
    fr: np.ndarray            # [P] int8
    length: np.ndarray        # [P] int64
    pid: torch.Tensor         # [J] int64
    ts: torch.Tensor          # [J] int64
    tlen: torch.Tensor        # [J] int32
    g0: torch.Tensor          # [J] int32
    dst: torch.Tensor         # [J] int64
    src: torch.Tensor         # [J] int64
    segs: torch.Tensor        # [sum of segment lengths] int8
    genome_p: torch.Tensor    # [GENOME_PAD + G + GENOME_PAD] int8

    @property
    def n(self) -> int:
        return self.pid.numel()

    def batch(self, s: int, bs: int):
        """The DP batch of jobs s..s + bs - 1 -> (tiles [bs, TILE] int8,
        tlens int32, windows [bs, TILE + 2 TILE_PAD] int8, g0s int32, dst
        int64): a tile is its query bases, 4 past tlen; a window is
        genome[g0 - TILE_PAD:][:TILE + 2 TILE_PAD], 4 outside the genome.
        Lanes past the last job have tlen 0, g0 0 and dst 0."""
        k = min(bs, self.n - s)

        def lanes(x):
            out = x.new_zeros(bs)
            out[:k] = x[s:s + k]
            return out

        tlens, g0s, dst, src = (lanes(x) for x in (self.tlen, self.g0,
                                                     self.dst, self.src))
        cols = torch.arange(TILE, device=src.device)
        at = (src[:, None] + cols).clamp_(max=max(self.segs.numel() - 1, 0))
        tiles = torch.where(cols < tlens[:, None], self.segs[at],
                            torch.full((), 4, dtype=torch.int8,
                                       device=src.device))
        windows = window_slices(self.genome_p, g0s.long() - TILE_PAD,
                                TILE + 2 * TILE_PAD)
        return tiles, tlens, windows, g0s, dst


def build_tile_jobs(cl: HitClusters, ch: Chains, seg_len: np.ndarray,
                    segs: torch.Tensor, genome_p: torch.Tensor) -> TileJobs:
    """The JAX module's _tile_diags and tile-job loop for every placement
    at once, on the device of the hits.  Each placement's tiles take
    TILE-base slots from base[p] (the cumulative sum of its tile counts);
    every hit of a placed cluster scatter-mins its diagonal into its
    tile (from the 2^62 sentinel); a hitless tile inside the placement's
    tile span [qlo // TILE, qhi // TILE] takes the last held tile's
    diagonal (a cummax of held slots; the span's first tile holds the
    hit at qlo, so no fill crosses placements).  The held tiles are the
    jobs; their count is the one host sync."""
    dev = cl.d.device
    P = len(ch.seg)
    length = seg_len[ch.seg]
    if P == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return TileJobs(np.zeros(0, np.int32), np.zeros(0, np.int8),
                        length, z, z, z.int(), z.int(), z, z, segs, genome_p)
    n_tiles = (length + TILE - 1) // TILE
    base = np.cumsum(n_tiles) - n_tiles
    T = int(n_tiles.sum())
    seg_start = np.cumsum(seg_len) - seg_len
    off = np.cumsum(length) - length
    # one upload: the placements' figures, then each placed run's id and
    # placement
    pid_of = np.repeat(np.arange(P), np.diff(ch.moff))
    up = torch.from_numpy(np.concatenate([
        base, ch.qlo // TILE, ch.qhi // TILE, length, off,
        seg_start[ch.seg], n_tiles, cl.kept[ch.members], pid_of])).to(dev)
    base_d, t0, t1, len_d, off_d, src_d, nt_d = up[:7 * P].view(7, P)
    placed = torch.full((cl.d.numel(),), -1, dtype=torch.int64, device=dev)
    placed[up[7 * P:7 * P + len(pid_of)]] = up[7 * P + len(pid_of):]
    # per-tile diagonals: the min over the tile's hits; hits of no
    # placement go to the spare slot T
    hp = placed[cl.run]
    slot = torch.where(hp >= 0, base_d[hp.clamp(min=0)] + cl.q // TILE, T)
    td = torch.full((T + 1,), 2**62, dtype=torch.int64, device=dev)
    td.scatter_reduce_(0, slot, cl.d, "amin")
    td = td[:T]
    has = td != 2**62
    tile_pid = torch.repeat_interleave(torch.arange(P, device=dev), nt_d,
                                       output_size=T)
    t = torch.arange(T, device=dev) - base_d[tile_pid]
    held = torch.where(has, torch.arange(T, device=dev), -1)
    last = torch.cummax(held, 0).values
    fill = ((t >= t0[tile_pid]) & (t <= t1[tile_pid]) & ~has & (last >= 0))
    td = torch.where(fill, td[last.clamp(min=0)], td)
    j = torch.nonzero(has | fill).squeeze(1)
    pid = tile_pid[j]
    ts = t[j] * TILE
    return TileJobs(
        chunk_id=(ch.seg // 2).astype(np.int32),
        fr=(ch.seg % 2).astype(np.int8), length=length.astype(np.int64),
        pid=pid, ts=ts, tlen=(len_d[pid] - ts).clamp(max=TILE).int(),
        g0=(td[j] + ts).clamp(-(2**30), 2**30).int(), dst=off_d[pid] + ts,
        src=src_d[pid] + ts, segs=segs, genome_p=genome_p)


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


@dataclasses.dataclass
class Placements:
    """An align's placements and their position maps, kept on the
    aligner's device from the tile DP to the end of _finalize.

    Placement p is chunk chunk_id[p] in orientation fr[p], length[p]
    bases; its pos_map is buf[off[p]:off[p + 1]] (int32 genome position
    per base, -1 unaligned).  The host arrays are numpy."""
    chunk_id: np.ndarray      # [P] int32
    fr: np.ndarray            # [P] int8
    length: np.ndarray        # [P] int64
    off: np.ndarray           # [P + 1] int64
    buf: torch.Tensor         # [off[-1]] int32 on the device

    @classmethod
    def new(cls, chunk_id, fr, length, device) -> "Placements":
        """Every map -1, in one buffer on `device`."""
        length = np.asarray(length, np.int64)
        off = np.zeros(len(length) + 1, np.int64)
        np.cumsum(length, out=off[1:])
        return cls(np.asarray(chunk_id, np.int32), np.asarray(fr, np.int8),
                   length, off, torch.full((int(off[-1]),), -1,
                                           dtype=torch.int32, device=device))

    @classmethod
    def from_maps(cls, maps, chunk_id, fr, device) -> "Placements":
        """Placements holding the given int32 position maps."""
        pl = cls.new(chunk_id, fr, [len(m) for m in maps], device)
        if maps:
            pl.buf.copy_(torch.from_numpy(
                np.concatenate(maps).astype(np.int32)))
        return pl

    def slice(self, a: int, b: int) -> "Placements":
        """Placements a..b-1; their maps are a view of this buffer."""
        off = self.off[a:b + 1]
        return Placements(self.chunk_id[a:b], self.fr[a:b],
                          self.length[a:b], off - off[0],
                          self.buf[int(off[0]):int(off[-1])])

    def scatter_tiles(self, pm: torch.Tensor, dst: torch.Tensor,
                      plen: torch.Tensor) -> None:
        """Tile k's aligned bases pm[k, :plen[k]] into the buffer at
        dst[k] on (pm [B, TILE] int32, dst int64, plen int32 on the
        device).  The tiles of one placement are disjoint and the buffer
        starts at -1, so this is the per-tile copy where pm >= 0."""
        cols = torch.arange(pm.shape[1], device=pm.device)
        ok = (cols[None, :] < plen[:, None]) & (pm >= 0)
        self.buf[(dst[:, None] + cols[None, :])[ok]] = pm[ok]


# _finalize's steps, in order, as finalize_placements times them (its
# spans align.contigs.finalize.<step>)
FINALIZE_STEPS = ("blocks", "monotone", "chain", "unkeep_trim", "holes",
                  "rows", "copy")


def _empty_alignments() -> ContigAlignments:
    return ContigAlignments(
        **{f.name: np.zeros(0, np.int8 if f.name == "fr" else np.int32)
           for f in dataclasses.fields(ContigAlignments)
           if f.name != "pos_map"}, pos_map=[])


# the most buffer bases that one pass of finalize_placements takes: its
# device temporaries are under ~100 B an aligned base, so a pass stays
# under ~7 GB however large the align
FINALIZE_PASS_BASES = 1 << 26


def finalize_placements(pl: Placements, accept: tuple, stats: dict
                        ) -> ContigAlignments:
    """The JAX module's _finalize on every placement at once, on pl.buf's
    device (pl.buf is changed in place): per placement _enforce_monotone,
    _fill_gapless_holes, the row fields and the loadContiAli filter
    `accept` = (src_ratio, tgt_ratio, min_size); then the kept rows and
    their position maps come to the host.  The placements go in passes
    of consecutive placements of at most FINALIZE_PASS_BASES buffer
    bases (or one placement), with one copy to the host a pass (pos_map:
    views of that pass's int32 array); the result does not depend on
    the passes.  stats gets "split", the host seconds of each of
    FINALIZE_STEPS (the steps' spans; nothing synchronises for them, so a
    step's device work can end inside a later step, and the last copy to
    the host ends them all), and "counts": placements, aligned (those with an
    aligned base), bases (aligned bases out of the tile DP), need_dp (not
    strictly increasing), blocks, dp_blocks, max_m and sum_m2 (the
    largest block count and the sum of the squares over need_dp), unkept
    and trimmed blocks, gaps and gaps_filled, rows, and passes.
    """
    split = dict.fromkeys(FINALIZE_STEPS, 0.0)
    counts = dict(placements=0, aligned=0, bases=0, need_dp=0, blocks=0,
                  dp_blocks=0, max_m=0, sum_m2=0, unkept=0, trimmed=0,
                  gaps=0, gaps_filled=0, rows=0, passes=0)
    stats.update(split=split, counts=counts)
    parts = []
    a, P = 0, len(pl.length)
    while a < P:
        b = int(np.searchsorted(pl.off, pl.off[a] + FINALIZE_PASS_BASES,
                                "right"))
        b = max(a + 1, b - 1)
        with spans.Steps("align.contigs.finalize", device=pl.buf.device,
                         seconds=split) as steps:
            parts.append(_finalize_pass(pl.slice(a, b), accept, steps,
                                        counts))
        counts["passes"] += 1
        a = b
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return _empty_alignments()
    return ContigAlignments(**{
        f.name: (sum((p.pos_map for p in parts), []) if f.name == "pos_map"
                 else np.concatenate([getattr(p, f.name) for p in parts]))
        for f in dataclasses.fields(ContigAlignments)})


def _finalize_pass(pl: Placements, accept: tuple, steps: spans.Steps,
                   counts: dict) -> ContigAlignments:
    """finalize_placements on one pass's placements, each of
    FINALIZE_STEPS a step of `steps`; its counts are added to counts."""
    dev = pl.buf.device
    P = len(pl.length)
    buf = pl.buf
    counts["placements"] += P
    # 1. M-blocks: runs of consecutive bases with consecutive targets,
    #    never across placements
    steps.step("blocks")
    idx = torch.nonzero(buf >= 0).squeeze(1)
    n = idx.numel()
    if n == 0:
        return _empty_alignments()
    off_d = torch.from_numpy(pl.off).to(dev)
    val = buf[idx].long()
    seg = torch.searchsorted(off_d[1:], idx, right=True)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = ((seg[1:] != seg[:-1]) | (idx[1:] - idx[:-1] != 1)
               | (val[1:] - val[:-1] != 1))
    bstart = torch.nonzero(new).squeeze(1)
    bend = torch.cat([bstart[1:], bstart.new_full((1,), n)])
    bseg = seg[bstart]
    t0 = val[bstart]
    t1 = val[bend - 1] + 1
    w = bend - bstart
    # 2. the placements whose blocks are not strictly increasing (so they
    #    have two blocks and more); the others keep every block
    steps.step("monotone")
    viol = (bseg[1:] == bseg[:-1]) & (t0[1:] < t1[:-1])
    need = torch.zeros(P, dtype=torch.bool, device=dev)
    need[bseg[1:][viol]] = True
    sel = need[bseg]
    m_q = torch.bincount(bseg, minlength=P)[need]
    q = m_q.numel()
    # 3. the chain DP over those placements' blocks (CSR)
    steps.step("chain")
    eb = torch.cumsum(new, 0) - 1               # each base's block
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    add = {}
    if q:
        coff = torch.zeros(q + 1, dtype=torch.int64, device=dev)
        torch.cumsum(m_q, 0, out=coff[1:])
        _, _, trim, keep = monotone_chain(t0[sel], t1[sel], w[sel], coff)
        # 4-5. unkept blocks and the trimmed fronts of kept ones: a
        #    block's bases are consecutive, so its span is its bases
        steps.step("unkeep_trim")
        dead_b = torch.zeros(len(bstart), dtype=torch.bool, device=dev)
        trim_b = torch.zeros_like(w)
        dead_b[sel] = ~keep
        trim_b[sel] = torch.where(keep, trim, 0)
        r = torch.arange(n, device=dev) - bstart[eb]
        dead = dead_b[eb] | (r < trim_b[eb])
        buf[idx[dead]] = -1
        add = dict(unkept=(~keep).sum(), trimmed=(keep & (trim > 0)).sum(),
                   dp_blocks=keep.numel(), sum_m2=(m_q * m_q).sum())
        counts["max_m"] = max(counts["max_m"], int(m_q.max()))
    else:
        steps.step("unkeep_trim")
    # 6. gapless holes: a gap between aligned bases i0 < i1 whose targets
    #    step by i1 - i0 is filled; the gaps are disjoint and the fill
    #    keeps the ends, so all at once is the reference's loop
    steps.step("holes")
    alive = ~dead
    idx, val, seg = idx[alive], val[alive], seg[alive]
    d = idx[1:] - idx[:-1]
    gap = (seg[1:] == seg[:-1]) & (d > 1)
    fill = gap & (val[1:] - val[:-1] == d)
    g_i0, g_v0, g_seg = idx[:-1][fill], val[:-1][fill], seg[:-1][fill]
    g_len = d[fill] - 1                         # the bases inside
    total = int(g_len.sum()) if g_len.numel() else 0
    if total:
        gid = torch.repeat_interleave(g_len, output_size=total)
        k = (torch.arange(total, device=dev)
             - (torch.cumsum(g_len, 0) - g_len)[gid] + 1)
        buf[g_i0[gid] + k] = (g_v0[gid] + k).to(torch.int32)
    # 7. row fields: the fill is interior and between its ends' targets,
    #    so the first and last aligned base and the target range are the
    #    surviving bases'; m counts the filled ones too
    steps.step("rows")
    cnt = torch.bincount(seg, minlength=P)
    m = cnt + torch.zeros_like(cnt).index_add_(0, g_seg, g_len)
    has = cnt > 0
    end = torch.cumsum(cnt, 0)
    last = idx.numel() - 1
    ss = idx[(end - cnt).clamp(max=last)] - off_d[:-1]
    se = idx[(end - 1).clamp(min=0)] + 1 - off_d[:-1]
    ts = torch.full_like(cnt, 2**62).scatter_reduce_(0, seg, val, "amin")
    te = torch.full_like(cnt, -1).scatter_reduce_(0, seg, val, "amax") + 1
    qgap = (se - ss) - m
    tgap = (te - ts) - m
    # 8. loadContiAli (AlignGraph.cpp:841) in float64, as the reference's
    #    division of Python ints
    a_src, a_tgt, a_size = accept
    size = torch.from_numpy(pl.length).to(dev)
    ok = (has & (size.double() > a_size)
          & ((se - ss - qgap).double() / size.double() >= a_src)
          & ((te - ts - tgap).double() / (te - ts).clamp_min(1).double()
             >= a_tgt))
    rows = torch.nonzero(ok).squeeze(1)
    fields = torch.stack([rows, m[rows], ss[rows], se[rows], qgap[rows],
                          ts[rows], te[rows], tgap[rows]])
    maps = buf[torch.repeat_interleave(ok, size, output_size=len(buf))]
    # 9. one copy to the host
    steps.step("copy")
    out = torch.cat([fields.flatten().to(torch.int32), maps]).cpu().numpy()
    R = rows.numel()
    got = out[:8 * R].reshape(8, R)
    r_host = got[0].astype(np.int64)
    lens = pl.length[r_host]
    for key, v in dict(aligned=has.sum(), bases=n, need_dp=q,
                       blocks=bstart.numel(),
                       gaps=gap.sum(), gaps_filled=fill.sum(), rows=R,
                       **add).items():
        counts[key] += int(v)
    return ContigAlignments(
        chunk_id=pl.chunk_id[r_host], fr=pl.fr[r_host], score=got[1].copy(),
        source_start=got[2].copy(), source_end=got[3].copy(),
        source_gap=got[4].copy(), source_size=lens.astype(np.int32),
        target_start=got[5].copy(), target_end=got[6].copy(),
        target_gap=got[7].copy(),
        pos_map=np.split(out[8 * R:], np.cumsum(lens)[:-1]) if R else [])


class ContigAligner:
    """Aligns formalized contig chunks to the genome; everything but the
    greedy chain (the seeding, the clusters, the tile jobs, the tile DP
    and _finalize) runs on `device`, where the genome is kept padded
    with GENOME_PAD 4s a flank (genome_p).

    index: a seed index of `genome_codes`; without one, build_index
    builds it on `device`.  One on `device` (a ReadAligner's, which
    shares it) is used as it is; one on the CPU (SeedIndex.from_numpy
    carries the JAX package's there) is moved there once; one on another
    device raises.
    """

    def __init__(self, genome_codes: np.ndarray, cfg: Config,
                 index: Optional[SeedIndex] = None,
                 max_join_gap: int = MAX_JOIN_GAP,
                 accept: tuple = (INIT_CONTIG_THRESHOLD,
                                  INIT_CONTIG_THRESHOLD, 200), *, device):
        genome = np.asarray(genome_codes, np.int8)
        device = torch.device(device)
        if device.type not in DP_BATCH:
            raise ValueError(f"no contig-aligner path for device {device}")
        # "cuda" -> the current card, as the tensors placed there name it
        self.device = torch.empty(0, device=device).device
        # the genome on the device with 4s on both flanks (window_slices)
        gp = np.full(len(genome) + 2 * GENOME_PAD, 4, np.int8)
        gp[GENOME_PAD:GENOME_PAD + len(genome)] = genome
        self.genome_p = torch.from_numpy(gp).to(self.device)
        self.cfg = cfg
        if index is None:
            index = build_index(genome, cfg.seed_len,
                                device=self.device)
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
        # the last seeding's seeds, hits, batches and batch bytes
        self.seeding: dict = {}
        # the last align's seconds by layer (LAYERS) on the host clock,
        # its layers' spans: the device is not synchronised for it, so a
        # layer's device work can end inside a later layer's seconds (the
        # syncs are the kept cluster count, the job count and the tile
        # DP's own)
        self.layer_s = dict.fromkeys(LAYERS, 0.0)
        # the last align's seconds in _finalize, by step
        # (FINALIZE_STEPS), and its counts (finalize_placements)
        self.finalize_s = 0.0
        self.finalize_split: dict = {}
        self.finalize_counts: dict = {}
        # the host buffer the real contigs are written to before their
        # one copy up (_segments), pinned for a CUDA aligner; grown
        # geometrically, and reused once the event of its last copy has
        # passed
        self._pinned = self.device.type == "cuda"
        self._staging = torch.empty(0, dtype=torch.int8)
        self._staged = None

    # ------------------------------------------------------------------
    def seed_hits(self, seqs: List[np.ndarray]):
        """Forward-matching seed hits of the query segments `seqs` (int8
        codes), all looked up at once on the aligner's device -> host
        int64 (offsets, qpos, tpos): segment s's hits are
        qpos[offsets[s]:offsets[s + 1]] and the same slice of tpos, each
        the JAX module's _seed_hits(seqs[s]).  The segments go up in one
        copy and the hits come down in one."""
        flat = np.concatenate(seqs) if seqs else np.zeros(0, np.int8)
        hits = self._seed(torch.from_numpy(flat).to(self.device),
                          [len(s) for s in seqs])
        n, H = len(seqs) + 1, len(hits.qpos)
        buf = torch.cat([hits.offsets, hits.qpos, hits.tpos]).cpu().numpy()
        return buf[:n], buf[n:n + H], buf[n + H:]

    def _seed(self, segs: torch.Tensor, lens) -> ContigSeedHits:
        """contig_seed_hits of the segments `segs` (end to end on the
        device, lengths `lens`); its counts go to self.seeding."""
        hits = contig_seed_hits(self.index, segs, lens, self.stride)
        self.seeding = dict(seeds=hits.seeds, hits=len(hits.qpos),
                            batches=hits.batches,
                            batch_bytes=hits.batch_bytes)
        return hits

    # ------------------------------------------------------------------
    def _segments(self, contigs: Contigs):
        """The query segments on the aligner's device, as
        np.concatenate(query_segments(contigs)), and their lengths: the
        real contigs written end to end into the staging buffer, one
        copy of them up, the layout on the device (segment_layout).
        Nothing of them is kept after the call but the buffer.  Returns
        (segs, lens, counts): the bytes copied up, whether the buffer is
        pinned, and whether it grew."""
        T = sum(len(s) for s in contigs.seqs)
        grows = int(T > len(self._staging))
        if grows:
            self._staging = torch.empty(max(T, 2 * len(self._staging)),
                                        dtype=torch.int8,
                                        pin_memory=self._pinned)
        elif self._staged is not None:
            # the last copy out of the buffer has to be done first
            self._staged.synchronize()
        if T:
            np.concatenate(contigs.seqs, out=self._staging.numpy()[:T],
                           casting="unsafe")
        fwd = self._staging[:T].to(self.device, non_blocking=True)
        if self._pinned:
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))
        segs = segment_layout(fwd, contigs)
        lens = np.repeat(np.asarray(contigs.chunk_len, np.int64), 2)
        return segs, lens, dict(host_bytes=T, pinned=int(self._pinned),
                                staging_grows=grows)

    # ------------------------------------------------------------------
    def tile_jobs(self, contigs: Contigs) -> TileJobs:
        """Every chunk's tile jobs, both orientations, on the aligner's
        device: the segments are laid out there (_segments); seeding,
        clustering (cluster_hits), the tiles' diagonals and the jobs
        (build_tile_jobs) run on the device; the host chains the kept
        clusters (chain_clusters).  Sets layer_s's seed, cluster, chain
        and tile_diags, the seconds of those layers' spans; the seed
        span's child align.contigs.segments is _segments (the staging
        write, the copy up and the layout's launches), and its counts
        are self.seeding."""
        self.layer_s = dict.fromkeys(LAYERS, 0.0)
        dev = self.device
        with spans.span("align.contigs.seed", device=dev, timed=True) as s:
            with spans.span("align.contigs.segments", device=dev) as g:
                segs, lens, staged = self._segments(contigs)
                g.add(segments=len(lens), bases=len(segs), **staged)
            hits = self._seed(segs, lens)
        self.layer_s["seed"] += s.seconds
        s.add(**self.seeding)
        with spans.span("align.contigs.cluster", device=dev,
                        timed=True) as s:
            cl = cluster_hits(hits.qpos, hits.tpos, hits.offsets,
                              self.min_votes)
            del hits
        self.layer_s["cluster"] += s.seconds
        with spans.span("align.contigs.chain", timed=True) as s:
            ch = chain_clusters(cl, self.max_join_gap)
        self.layer_s["chain"] += s.seconds
        with spans.span("align.contigs.tile_diags", device=dev,
                        timed=True) as s:
            jobs = build_tile_jobs(cl, ch, lens, segs, self.genome_p)
        self.layer_s["tile_diags"] += s.seconds
        return jobs

    # ------------------------------------------------------------------
    def align(self, contigs: Contigs) -> ContigAlignments:
        """Every chunk's placements: the span align.contigs (the sample's
        root when called outside one) over tile_jobs' layers, then dp
        (_run_tile_jobs) and finalize (_finalize, whose counts it
        carries); finalize_s is its seconds."""
        dev = self.device
        with spans.span("align.contigs", device=dev) as call:
            jobs = self.tile_jobs(contigs)
            placements = Placements.new(jobs.chunk_id, jobs.fr, jobs.length,
                                        dev)
            with spans.span("align.contigs.dp", device=dev,
                            timed=True) as s:
                self._run_tile_jobs(jobs, placements)
            self.layer_s["dp"] += s.seconds
            s.add(jobs=jobs.n)
            with spans.span("align.contigs.finalize", device=dev,
                            timed=True) as s:
                out = self._finalize(placements, contigs)
            self.layer_s["finalize"] += s.seconds
            self.finalize_s = s.seconds
            s.add(**self.finalize_counts)
            call.add(chunks=contigs.n_chunks, placements=out.n)
        return out

    # ------------------------------------------------------------------
    def _run_tile_jobs(self, jobs: TileJobs, placements: Placements):
        """The jobs in DP batches of dp_batch lanes: banded SW + traceback
        on the device (the gapless fast path synthesizes most tiles'
        pos_map), each batch's maps scattered into the placements'
        buffer."""
        for s in range(0, jobs.n, self.dp_batch):
            tiles, tlens, windows, g0s, dst = jobs.batch(s, self.dp_batch)
            _, pm = banded_sw_posmap_auto(tiles, tlens, windows, g0s,
                                          pad=TILE_PAD)
            placements.scatter_tiles(pm, dst, tlens)

    # ------------------------------------------------------------------
    def _finalize(self, placements: Placements,
                  contigs: Contigs) -> ContigAlignments:
        """finalize_placements with this aligner's acceptance; its split
        and counts go to finalize_split and finalize_counts."""
        st: dict = {}
        out = finalize_placements(placements, self.accept, st)
        self.finalize_split, self.finalize_counts = st["split"], st["counts"]
        return out
