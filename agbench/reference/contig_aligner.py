"""The contig aligner of the plain reference.

Frozen copy of aligngraph_tpu_torch/align/contig_aligner.py at commit
5fa5dc4: the device seeding, the hit clusters, the greedy chain, the tile
jobs, the tile DP and finalize_placements, with the plain banded SW of
reference/banded_sw.py and the plain chain DP of
reference/monotone_chain.py in place of the port's kernels.  It imports
nothing of the port.

align_drafts aligns draft contigs as the port's ContigAligner.align
aligns their formalized chunks (each draft one chunk: no draft here
reaches the 1 Mb chunk size, and none is chaff) and returns the
placements as host arrays.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List

import numpy as np
import torch

from agbench.reference.banded_sw import posmap
from agbench.reference.monotone_chain import monotone_chain_plain
from agbench.reference.read_aligner import window_slices
from agbench.reference.seeding import SeedIndex, contig_seed_hits

# config.INIT_CONTIG_THRESHOLD (AlignGraph.cpp:29)
INIT_CONTIG_THRESHOLD = 0.5
TILE = 512
# every tile re-anchors its diagonal from its own seed hits
# (build_tile_jobs), so the band only absorbs within-tile drift (small
# indels); W = 32 is one warp in the CUDA kernels
TILE_PAD = 16
CLUSTER_GAP = 1000        # diagonal distance that separates clusters
MAX_JOIN_GAP = 20_000     # max genome gap when chaining clusters
MAX_Q_OVERLAP = 200       # allowed query overlap when chaining
MAX_PLACEMENTS = 4
# tile jobs a DP call (lanes are independent: only the speed depends on it)
DP_BATCH = 16384

_COMP_NP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def _revcomp_np(seq: np.ndarray) -> np.ndarray:
    return _COMP_NP[seq][::-1]


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

    def scatter_tiles(self, pm: torch.Tensor, dst: torch.Tensor,
                      plen: torch.Tensor) -> None:
        """Tile k's aligned bases pm[k, :plen[k]] into the buffer at
        dst[k] on (pm [B, TILE] int32, dst int64, plen int32 on the
        device).  The tiles of one placement are disjoint and the buffer
        starts at -1, so this is the per-tile copy where pm >= 0."""
        cols = torch.arange(pm.shape[1], device=pm.device)
        ok = (cols[None, :] < plen[:, None]) & (pm >= 0)
        self.buf[(dst[:, None] + cols[None, :])[ok]] = pm[ok]


@dataclasses.dataclass
class ContigAlignments:
    """align/types.ContigAlignments: one row a placement of a chunk."""
    chunk_id: np.ndarray      # [M] int32
    fr: np.ndarray            # [M] int8
    score: np.ndarray         # [M] int32
    source_start: np.ndarray  # [M] int32
    source_end: np.ndarray    # [M] int32
    source_gap: np.ndarray    # [M] int32
    source_size: np.ndarray   # [M] int32
    target_start: np.ndarray  # [M] int32 (global genome axis)
    target_end: np.ndarray    # [M] int32
    target_gap: np.ndarray    # [M] int32
    pos_map: list             # [M] int32 arrays (chunk length each)

    @property
    def n(self) -> int:
        return int(self.chunk_id.shape[0])


def _empty_alignments() -> ContigAlignments:
    return ContigAlignments(
        **{f.name: np.zeros(0, np.int8 if f.name == "fr" else np.int32)
           for f in dataclasses.fields(ContigAlignments)
           if f.name != "pos_map"}, pos_map=[])


def finalize_placements(pl: Placements, accept: tuple) -> ContigAlignments:
    """The JAX module's _finalize on every placement at once, on pl.buf's
    device (pl.buf is changed in place): per placement _enforce_monotone,
    _fill_gapless_holes, the row fields and the loadContiAli filter
    `accept` = (src_ratio, tgt_ratio, min_size); then the kept rows and
    their position maps come to the host in one copy (pos_map: views of
    its int32 array)."""
    dev = pl.buf.device
    P = len(pl.length)
    buf = pl.buf
    # 1. M-blocks: runs of consecutive bases with consecutive targets,
    #    never across placements
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
    viol = (bseg[1:] == bseg[:-1]) & (t0[1:] < t1[:-1])
    need = torch.zeros(P, dtype=torch.bool, device=dev)
    need[bseg[1:][viol]] = True
    sel = need[bseg]
    m_q = torch.bincount(bseg, minlength=P)[need]
    q = m_q.numel()
    # 3. the chain DP over those placements' blocks (CSR)
    eb = torch.cumsum(new, 0) - 1               # each base's block
    dead = torch.zeros(n, dtype=torch.bool, device=dev)
    if q:
        coff = torch.zeros(q + 1, dtype=torch.int64, device=dev)
        torch.cumsum(m_q, 0, out=coff[1:])
        _, _, trim, keep = monotone_chain_plain(t0[sel], t1[sel], w[sel],
                                                coff)
        # 4-5. unkept blocks and the trimmed fronts of kept ones: a
        #    block's bases are consecutive, so its span is its bases
        dead_b = torch.zeros(len(bstart), dtype=torch.bool, device=dev)
        trim_b = torch.zeros_like(w)
        dead_b[sel] = ~keep
        trim_b[sel] = torch.where(keep, trim, 0)
        r = torch.arange(n, device=dev) - bstart[eb]
        dead = dead_b[eb] | (r < trim_b[eb])
        buf[idx[dead]] = -1
    # 6. gapless holes: a gap between aligned bases i0 < i1 whose targets
    #    step by i1 - i0 is filled; the gaps are disjoint and the fill
    #    keeps the ends, so all at once is the reference's loop
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
    out = torch.cat([fields.flatten().to(torch.int32), maps]).cpu().numpy()
    R = rows.numel()
    got = out[:8 * R].reshape(8, R)
    r_host = got[0].astype(np.int64)
    lens = pl.length[r_host]
    return ContigAlignments(
        chunk_id=pl.chunk_id[r_host], fr=pl.fr[r_host], score=got[1].copy(),
        source_start=got[2].copy(), source_end=got[3].copy(),
        source_gap=got[4].copy(), source_size=lens.astype(np.int32),
        target_start=got[5].copy(), target_end=got[6].copy(),
        target_gap=got[7].copy(),
        pos_map=np.split(out[8 * R:], np.cumsum(lens)[:-1]) if R else [])


def align_drafts(genome_p: torch.Tensor, index: SeedIndex,
                 drafts: List[np.ndarray], *, fast_map: bool = False,
                 max_join_gap: int = MAX_JOIN_GAP,
                 accept: tuple = (INIT_CONTIG_THRESHOLD,
                                  INIT_CONTIG_THRESHOLD, 200),
                 gapless: bool = False) -> ContigAlignments:
    """ContigAligner.align of the drafts (chunk c = drafts[c]) on
    genome_p's device, its tile DP in batches of DP_BATCH lanes."""
    stride = 32 if fast_map else 16
    min_votes = 4 if fast_map else 2
    seqs = []
    for d in drafts:
        fwd = np.asarray(d, np.int8)
        seqs += [fwd, _revcomp_np(fwd)]
    lens = np.array([len(x) for x in seqs], np.int64)
    flat = np.concatenate(seqs) if seqs else np.zeros(0, np.int8)
    segs = torch.from_numpy(flat).to(genome_p.device)
    hits = contig_seed_hits(index, segs, lens, stride)
    cl = cluster_hits(hits.qpos, hits.tpos, hits.offsets, min_votes)
    del hits
    ch = chain_clusters(cl, max_join_gap)
    jobs = build_tile_jobs(cl, ch, lens, segs, genome_p)
    pl = Placements.new(jobs.chunk_id, jobs.fr, jobs.length,
                        genome_p.device)
    for s in range(0, jobs.n, DP_BATCH):
        tiles, tlens, windows, g0s, dst = jobs.batch(s, DP_BATCH)
        _, pm = posmap(tiles, tlens, windows, g0s, pad=TILE_PAD,
                       gapless=gapless)
        pl.scatter_tiles(pm, dst, tlens)
    return finalize_placements(pl, accept)
