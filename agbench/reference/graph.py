"""The graph's tensors and its contig layer.

Frozen from aligngraph_tpu_torch at commit 5fa5dc4: graph/model.py
(GraphTensors), graph/contig_layer.py (build_contig_layer,
initial_contigs) and the constants of graph/kmer_layer.py and config.py
that the build reads.  A contig set here is the drafts themselves: each
draft (all are longer than 200 and shorter than 1 Mb bases) is one chunk,
chunk c draft c, as the port's formalize_contigs makes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

EP = 5                        # AlignGraph.cpp:39 (compatibility epsilon unit)
CPO = 2                       # own-ContiMer cross-product cap
CPM = 2                       # mate-ContiMer cross-product cap

S_CM = 4     # ContiMer slots per position
K_KM = 6     # KMer slots per position
E_ED = 4     # edge slots per k-mer

NONE32 = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class GraphTensors:
    """Per-part graph state (host numpy)."""
    part_len: int
    overflow_cap: int
    overflow_used: int
    base: np.ndarray        # [P] int8 genome base codes (incl. overflow)

    # contig layer (ContiMer, AlignGraph.cpp:51-62)
    cm_cnt: np.ndarray      # [P] int8
    cm_contig: np.ndarray   # [P, S] uint32 contig id (chunk seq id)
    cm_coff: np.ndarray     # [P, S] uint32 contig offset
    cm_next: np.ndarray     # [P, S] uint32 next position (NONE32 = -1)
    cm_nitem: np.ndarray    # [P, S] uint32 next ContiMer item
    cm_base: np.ndarray     # [P, S] int8 nucleotide code

    # read layer (KMer, AlignGraph.cpp:78-98)
    km_cnt: np.ndarray      # [P] int8
    km_trav: np.ndarray     # [P, K] uint8
    km_contig: np.ndarray   # [P, K] uint32 own contig anchor id
    km_coff: np.ndarray     # [P, K] uint32 own contig anchor offset
    km_contig0: np.ndarray  # [P, K] uint32 mate contig anchor id
    km_coff0: np.ndarray    # [P, K] uint32 mate contig anchor offset
    km_mate: np.ndarray     # [P, K] uint32 mate genome anchor position
    km_cov: np.ndarray      # [P, K] int32 coverage
    km_votes: np.ndarray    # [P, K, 5] int32 A/C/G/T/N votes
    km_s: np.ndarray        # [P, K] uint32 packed k-mer string (2b/base)
    km_slen: np.ndarray     # [P, K] int8 k-mer string length (0 = empty)

    # edges
    ed_cnt: np.ndarray      # [P, K] int8
    ed_pos: np.ndarray      # [P, K, E] uint32 target position
    ed_item: np.ndarray     # [P, K, E] uint8 target k-mer slot

    # overflow statistics (determinism diagnostics)
    dropped_cm: int = 0
    dropped_km: int = 0
    dropped_ed: int = 0

    @property
    def n_pos(self) -> int:
        return self.part_len + self.overflow_used

    @classmethod
    def create(cls, part_seq: np.ndarray, overflow_cap: int = 0
               ) -> "GraphTensors":
        n = len(part_seq)
        if overflow_cap == 0:
            overflow_cap = max(1024, n // 10)
        P = n + overflow_cap
        base = np.full(P, 4, np.int8)
        base[:n] = part_seq
        z = np.zeros
        return cls(
            part_len=n, overflow_cap=overflow_cap, overflow_used=0,
            base=base,
            cm_cnt=z(P, np.int8),
            cm_contig=np.full((P, S_CM), NONE32, np.uint32),
            cm_coff=np.full((P, S_CM), NONE32, np.uint32),
            cm_next=np.full((P, S_CM), NONE32, np.uint32),
            cm_nitem=np.full((P, S_CM), NONE32, np.uint32),
            cm_base=np.full((P, S_CM), 4, np.int8),
            km_cnt=z(P, np.int8),
            km_trav=z((P, K_KM), np.uint8),
            km_contig=np.full((P, K_KM), NONE32, np.uint32),
            km_coff=np.full((P, K_KM), NONE32, np.uint32),
            km_contig0=np.full((P, K_KM), NONE32, np.uint32),
            km_coff0=np.full((P, K_KM), NONE32, np.uint32),
            km_mate=np.full((P, K_KM), NONE32, np.uint32),
            km_cov=z((P, K_KM), np.int32),
            km_votes=z((P, K_KM, 5), np.int32),
            km_s=z((P, K_KM), np.uint32),
            km_slen=z((P, K_KM), np.int8),
            ed_cnt=z((P, K_KM), np.int8),
            ed_pos=np.full((P, K_KM, E_ED), NONE32, np.uint32),
            ed_item=z((P, K_KM, E_ED), np.uint8),
        )

    def alloc_overflow(self, n: int) -> int:
        """Reserve n overflow positions; returns the first index."""
        if self.overflow_used + n > self.overflow_cap:
            grow = max(n, self.overflow_cap)
            P_old = self.part_len + self.overflow_cap
            for name in ("base", "cm_cnt", "cm_contig", "cm_coff", "cm_next",
                         "cm_nitem", "cm_base", "km_cnt", "km_trav",
                         "km_contig", "km_coff", "km_contig0", "km_coff0",
                         "km_mate", "km_cov", "km_votes", "km_s", "km_slen",
                         "ed_cnt", "ed_pos", "ed_item"):
                arr = getattr(self, name)
                shape = (P_old + grow,) + arr.shape[1:]
                if name == "base" or name == "cm_base":
                    fill = np.int8(4)
                elif arr.dtype == np.uint32:
                    fill = NONE32
                else:
                    fill = arr.dtype.type(0)
                new = np.full(shape, fill, arr.dtype)
                new[:P_old] = arr
                setattr(self, name, new)
            self.overflow_cap += grow
        start = self.part_len + self.overflow_used
        self.overflow_used += n
        return start


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


def build_contig_layer(g: GraphTensors, drafts: List[np.ndarray], ali,
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
        chunk_seq = np.asarray(drafts[chunk], np.int8)
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


def initial_contigs(drafts: List[np.ndarray], outputted: Dict[int, bool]
                    ) -> List[Tuple[int, np.ndarray]]:
    """The reference's tmp/_initial_contigs grouping (AlignGraph.cpp:
    1188-1216): real contigs whose outputted-chunk fraction >= 0.5, here
    the drafts whose one chunk was outputted."""
    return [(r, drafts[r]) for r in range(len(drafts))
            if outputted.get(r, False)]
