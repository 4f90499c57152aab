"""Seed index and candidate selection of the plain reference.

Frozen copy of aligngraph_tpu_torch/ops/seeding.py at commit 5fa5dc4:
the whole module, plain torch ops.
It imports nothing of the port, so that later changes to the program
are held to these semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INVALID_DIAG = 2**31 - 1
RC_OFFSET = 1 << 29     # added to reverse-orientation diagonals
POS_MASK = 0x7FFFFFFF
_KEY_PAD = 2**31 - 1    # never equals a packed k-mer (< 2^30)


@dataclasses.dataclass(frozen=True)
class SeedIndex:
    """Sorted canonical k-mer position index + prefix bucket table, as
    tensors on one device (the genome's "weights" beside its codes).

    bucket_lo[p] is the first index in sorted_kmers whose top
    (2*seed_len - suffix_bits) packed bits are >= p; search_steps is the
    binary-search depth inside the largest bucket (0 when direct-addressed).
    """
    seed_len: int
    genome_len: int
    sorted_kmers: torch.Tensor    # [M] int32 canonical, ascending
    sorted_posflip: torch.Tensor  # [M] int32 pos | flip<<31
    bucket_lo: torch.Tensor       # [2^prefix_bits + 1] int32
    search_steps: int
    suffix_bits: int

    @classmethod
    def from_numpy(cls, idx, device) -> "SeedIndex":
        """The index carried across from any object with the JAX
        SeedIndex's host fields (sorted_kmers_np, sorted_posflip_np,
        bucket_lo_np, search_steps, suffix_bits, seed_len, genome_len)."""
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)
        return cls(seed_len=int(idx.seed_len),
                   genome_len=int(idx.genome_len),
                   sorted_kmers=t(idx.sorted_kmers_np),
                   sorted_posflip=t(idx.sorted_posflip_np),
                   bucket_lo=t(idx.bucket_lo_np),
                   search_steps=int(idx.search_steps),
                   suffix_bits=int(idx.suffix_bits))

    @property
    def nbytes(self) -> int:
        """The three tensors' bytes, on whichever device they lie."""
        return sum(t.numel() * t.element_size() for t in
                   (self.sorted_kmers, self.sorted_posflip, self.bucket_lo))

    def to(self, device) -> "SeedIndex":
        return dataclasses.replace(
            self, sorted_kmers=self.sorted_kmers.to(device),
            sorted_posflip=self.sorted_posflip.to(device),
            bucket_lo=self.bucket_lo.to(device))


def pack_kmers(codes: torch.Tensor, seed_len: int):
    """All overlapping seed_len-mers of int8 `codes` -> (packed int32,
    valid bool), on the device of `codes`.

    packed[i] encodes codes[i:i+seed_len] big-endian 2 bits a base (one
    shift-or pass a base; 2 * 15 bits fit in int32); windows containing
    N (code >= 4) are invalid.
    """
    dev = codes.device
    m = codes.shape[0] - seed_len + 1
    if m <= 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    packed = torch.zeros(m, dtype=torch.int32, device=dev)
    invalid = torch.zeros(m, dtype=torch.bool, device=dev)
    for k in range(seed_len):
        w = codes[k:k + m]
        bad = w >= 4
        invalid |= bad
        packed.bitwise_left_shift_(2).bitwise_or_(w.masked_fill(bad, 0))
    return packed, invalid.logical_not_()


def bucket_table(sorted_kmers: torch.Tensor, seed_len: int):
    """The prefix bucket table of the sorted k-mers -> (bucket_lo,
    search_steps, suffix_bits), bucket_lo on their device.

    ~4 table slots per k-mer, capped at 26 bits (a 256 MB table); a big
    genome with a short seed takes the full-width table, so lookups are
    direct-addressed (suffix_bits == 0, no binary probes).  Bucket sizes
    are counted into int32 slots and summed in place; only the largest
    bucket (for the binary search's depth) comes down to the host."""
    M = sorted_kmers.shape[0]
    prefix_bits = min(26, 2 * seed_len,
                      max(14, int(np.ceil(np.log2(max(M, 2)))) + 2))
    if 2 * seed_len <= 26 and M >= (1 << 20):
        prefix_bits = 2 * seed_len
    suffix_bits = 2 * seed_len - prefix_bits
    bucket_lo = torch.zeros((1 << prefix_bits) + 1, dtype=torch.int32,
                            device=sorted_kmers.device)
    counts = bucket_lo[1:]
    counts.index_add_(0, sorted_kmers >> suffix_bits,
                      torch.ones_like(sorted_kmers))
    steps = 0
    if suffix_bits:
        max_bucket = int(counts.max())
        steps = max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)
    return bucket_lo.cumsum_(0), steps, suffix_bits


def build_index(genome_codes, seed_len: int, *, device) -> SeedIndex:
    """The canonical seed index of the concatenated genome, built on
    `device`: genome_codes (a numpy int8 array or an int8 tensor) goes
    there once, and every step (pack, filter, canonical form, sort,
    bucket table) runs there; only the number of valid windows (inside
    the filter) and the largest bucket come down.  Each step's inputs are
    freed as it ends, so the peak above what was allocated before is the
    sort's, ~40 B a position (the stable sort's int64 order and buffers),
    or for a small genome the 2^26-slot table's."""
    if seed_len > 15:
        raise ValueError("seed_len must be <= 15 (int32 packing)")
    if seed_len % 2 == 0:
        raise ValueError("seed_len must be odd (canonical k-mers need "
                         "palindrome-free packing)")
    n = len(genome_codes)
    if n >= RC_OFFSET - (1 << 20):
        raise ValueError(
            f"genome part too large for the int32 seed index "
            f"({n} >= 2^29): shard it into parts")
    if not isinstance(genome_codes, torch.Tensor):
        genome_codes = torch.from_numpy(
            np.ascontiguousarray(genome_codes, np.int8))
    packed, valid = pack_kmers(genome_codes.to(device, torch.int8), seed_len)
    pos = valid.nonzero()[:, 0]
    fwd = packed[pos]
    pos = pos.to(torch.int32)
    del packed, valid
    # canonical form: the smaller of the pack and its reverse complement,
    # bit 31 of posflip set where the reverse complement was taken
    rc = rc_packed(fwd, seed_len)
    flip = rc < fwd
    kmers = torch.where(flip, rc, fwd)
    del rc, fwd
    posflip = torch.where(flip, pos | -2**31, pos)
    del flip, pos
    # stable, so equal k-mers keep ascending positions
    # (np.argsort(kind="stable")'s order)
    sorted_kmers, order = torch.sort(kmers, stable=True)
    del kmers
    sorted_posflip = posflip[order]
    del posflip, order
    bucket_lo, steps, suffix_bits = bucket_table(sorted_kmers, seed_len)
    return SeedIndex(seed_len=seed_len, genome_len=n,
                     sorted_kmers=sorted_kmers,
                     sorted_posflip=sorted_posflip, bucket_lo=bucket_lo,
                     search_steps=steps, suffix_bits=suffix_bits)


def rc_packed(packed: torch.Tensor, seed_len: int) -> torch.Tensor:
    """Reverse complement of 2-bit packed k-mers (complement = base^3)."""
    p = packed.to(torch.int32)
    out = torch.zeros_like(p)
    for i in range(seed_len):
        out = (out << 2) | (((p >> (2 * i)) & 3) ^ 3)
    return out


def pack_query_seeds(seqs: torch.Tensor, seed_len: int, stride: int):
    """Pack seeds at `stride` offsets from padded reads [R, L].

    Returns (packed [R, S] int32, offsets [S] int32, valid [R, S] bool);
    seeds whose window contains a pad/N code are invalid.
    """
    R, L = seqs.shape
    dev = seqs.device
    offsets = torch.arange(0, max(L - seed_len + 1, 1), stride,
                           dtype=torch.int32, device=dev)
    k = torch.arange(seed_len, dtype=torch.int32, device=dev)
    idx = (offsets[:, None] + k[None, :]).long()
    w = seqs[:, idx].to(torch.int32)                 # [R, S, seed_len]
    invalid = (w >= 4).any(dim=-1)
    w = torch.where(w >= 4, 0, w)
    shifts = 2 * (seed_len - 1 - k)
    packed = (w << shifts).sum(dim=-1, dtype=torch.int32)
    return packed, offsets, ~invalid


def slice_gather(arr: torch.Tensor, lo: torch.Tensor, width: int,
                 pad_value: int = 0) -> torch.Tensor:
    """Contiguous runs: out[..., j] = arr[clip(lo, 0, M) + j], pad_value
    past the end of arr (the JAX _slice_gather's semantics)."""
    M = arr.shape[0]
    j = torch.arange(width, dtype=torch.int64, device=lo.device)
    idx = torch.clamp(lo.long(), 0, M)[..., None] + j
    inside = idx < M
    if M == 0:
        return torch.full(idx.shape, pad_value, dtype=arr.dtype,
                          device=arr.device)
    vals = arr[torch.clamp(idx, max=M - 1)]
    return torch.where(inside, vals, pad_value)


def _hit_mask(valid, count, max_hits: int):
    """valid seed, run no longer than max_hits, slot inside the run."""
    j = torch.arange(max_hits, dtype=torch.int32, device=count.device)
    return (valid[..., None] & (count[..., None] <= max_hits)
            & (j < count[..., None]))


def _search(sorted_kmers, key, lo, hi, steps: int, right: bool):
    """`steps` bounded binary-search iterations in [lo, hi): the first
    index whose key is >= `key` (right: > `key`)."""
    M = sorted_kmers.shape[0]
    for _ in range(steps):
        go = lo < hi
        mid = (lo + hi) >> 1
        k = sorted_kmers[torch.clamp(mid, 0, M - 1).long()]
        below = (k <= key) if right else (k < key)
        lo = torch.where(go & below, mid + 1, lo)
        hi = torch.where(go & ~below, mid, hi)
    return lo


def lookup_seeds_bucketed(sorted_kmers, sorted_posflip, bucket_lo, packed,
                          valid, max_hits: int, steps: int,
                          suffix_bits: int):
    """Canonical query packs [R, S] -> (posflip [R, S, max_hits] int32,
    ok [R, S, max_hits] bool).

    Seeds with more than max_hits occurrences are dropped entirely
    (repetitive-seed policy).  The bucket table bounds each k-mer's run;
    with suffix_bits == 0 the bucket IS the run (direct addressing),
    otherwise `steps` bounded binary-search iterations find its left end
    and the run length (capped at max_hits + 1) comes from the keys that
    follow it."""
    M = sorted_kmers.shape[0]
    prefix = packed >> suffix_bits
    lohi = slice_gather(bucket_lo, prefix, 2)
    lo, hi = lohi[..., 0], lohi[..., 1]
    if suffix_bits == 0:
        ok = _hit_mask(valid, hi - lo, max_hits)
        return slice_gather(sorted_posflip, lo, max_hits), ok
    # an empty index has no probes
    lo = _search(sorted_kmers, packed, lo, hi, steps if M else 0,
                 right=False)
    keys = slice_gather(sorted_kmers, lo, max_hits + 1, pad_value=_KEY_PAD)
    count = (keys == packed[..., None]).sum(dim=-1, dtype=torch.int32)
    ok = _hit_mask(valid, count, max_hits)
    return slice_gather(sorted_posflip, lo, max_hits), ok


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor, dim: int = -1):
    """Stable lexicographic sort by (hi, lo), both int32 -> the sorted
    positions along `dim`.  The keys are packed into one int64
    (hi * 2^32 + lo + 2^31), so ties of both keep their original order."""
    key = hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))
    return torch.sort(key, dim=dim, stable=True).indices


def select_candidates(posflip, ok, qflip, seed_offsets, qlens,
                      seed_len: int, band_pad: int, max_candidates: int):
    """Cluster hit diagonals per read (both orientations at once) -> top
    candidate diagonals.

    posflip/ok: [R, S, H] from lookup (canonical index);
    qflip: [R, S] query-seed flip bits; seed_offsets: [S]; qlens: [R].

    Hit orientation o = qflip ^ genome_flip.  Forward diagonal =
    pos - offset; reverse diagonal = pos - (qlen - offset - seed_len),
    offset by RC_OFFSET so strands never co-cluster.  A new cluster starts
    where the gap to the previous sorted diagonal exceeds band_pad; its
    vote is its size, its representative diagonal its minimum.  Top-C by
    (votes desc, diag asc).

    Returns (diags [R, C] int32, votes [R, C], orient [R, C] int32); empty
    slots have diag=INVALID_DIAG, votes=0.
    """
    R, S, H = posflip.shape
    N = S * H
    dev = posflip.device
    pos = posflip & POS_MASK
    gflip = posflip < 0
    o = gflip ^ qflip[..., None]                       # [R, S, H]
    off_f = seed_offsets[None, :, None].to(torch.int32)
    off_r = qlens[:, None, None] - off_f - seed_len
    diag = torch.where(o, pos - off_r + RC_OFFSET, pos - off_f)
    diag = torch.where(ok, diag, INVALID_DIAG).reshape(R, N)

    diag = torch.sort(diag, dim=1).values        # invalids sort to the end
    prev = torch.cat([torch.full((R, 1), -(2**30), dtype=torch.int32,
                                 device=dev), diag[:, :-1]], dim=1)
    is_valid = diag != INVALID_DIAG
    new_cluster = is_valid & ((diag - prev) > band_pad)
    # cluster votes via run lengths: for a cluster start at i, votes =
    # (index of the next cluster start, or #valid) - i
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(R, N)
    n_valid = is_valid.sum(dim=1, keepdim=True, dtype=torch.int32)
    start_idx = torch.where(new_cluster, idx, N)
    nxt = torch.cat([start_idx[:, 1:],
                     torch.full((R, 1), N, dtype=torch.int32, device=dev)],
                    dim=1)
    next_start = torch.flip(
        torch.cummin(torch.flip(nxt, dims=[1]), dim=1).values, dims=[1])
    votes_at_start = torch.minimum(next_start, n_valid) - idx
    votes = torch.where(new_cluster, votes_at_start, 0)
    rep_diag = torch.where(new_cluster, diag, INVALID_DIAG)
    order = sort_pairs(-votes, rep_diag, dim=1)[:, :max_candidates]
    out_votes = torch.gather(votes, 1, order)
    out_diag = torch.gather(rep_diag, 1, order)
    orient = ((out_diag != INVALID_DIAG)
              & (out_diag >= RC_OFFSET)).to(torch.int32)
    out_diag = torch.where(out_votes > 0, out_diag - orient * RC_OFFSET,
                           INVALID_DIAG)
    return out_diag, out_votes, orient


# The contig aligner's seeding (contig_seed_hits) keeps a seed whose run
# holds 1 to CONTIG_MAX_RUN index entries (the contig aligner's own
# repetitive-seed cutoff, not cfg.max_seed_hits) and runs
# CONTIG_SEED_BUDGET seeds a batch.  A batch of B seeds whose kept runs
# hold H hits takes at most CONTIG_SEED_BYTES * B + CONTIG_HIT_BYTES * H
# bytes on the device: per seed its int64 segment, offset and window
# start with their int8/int32 gathers, the int32 pack, its reverse
# complement and the run bounds with the binary searches' temporaries;
# per hit the int32 run index, slot and index gather, the posflip, the
# orientation mask, the int64 kept index, the int64 segment it counts
# into the offsets and the int64 (qpos, tpos) out.  H <= 64 * B, so
# 2^20 seeds take ~0.26 GB at the ~1.8 run entries a seed of a 32 Mb
# genome (the whole call's peak measured 0.25 GB on an H100, PERF.md),
# and at most ~4.4 GB if every seed's run held 64 entries.
CONTIG_MAX_RUN = 64
CONTIG_SEED_BUDGET = 1 << 20
CONTIG_SEED_BYTES = 128
CONTIG_HIT_BYTES = 64


@dataclasses.dataclass
class ContigSeedHits:
    """Seed hits of query segments, flat: segment-major, then by seed
    (query order), then in index order.  Segment s holds hits
    offsets[s]:offsets[s + 1] of qpos and tpos.  seeds:
    the seed windows looked up (N-free or not); batches: the lookup's
    batches; batch_bytes: the largest batch's device bytes, reckoned
    (CONTIG_SEED_BYTES, CONTIG_HIT_BYTES)."""
    qpos: torch.Tensor      # [H] int64
    tpos: torch.Tensor      # [H] int64
    offsets: torch.Tensor   # [n_segs + 1] int64
    seeds: int
    batches: int
    batch_bytes: int


def run_bounds(index: SeedIndex, key: torch.Tensor):
    """Canonical packs -> each one's run [lo, hi) in sorted_kmers (int32),
    np.searchsorted's left and right sides: the bucket itself when
    suffix_bits == 0, else two bounded binary searches inside it."""
    prefix = (key >> index.suffix_bits).long()
    lo, hi = index.bucket_lo[prefix], index.bucket_lo[prefix + 1]
    if index.suffix_bits == 0 or index.sorted_kmers.shape[0] == 0:
        return lo, hi
    steps = index.search_steps
    left = _search(index.sorted_kmers, key, lo, hi, steps, right=False)
    return left, _search(index.sorted_kmers, key, left, hi, steps,
                         right=True)


def contig_seed_hits(index: SeedIndex, segs: torch.Tensor, seg_lens,
                     stride: int) -> ContigSeedHits:
    """Forward-matching seed hits of every query segment at once, on the
    device of `segs` and `index`.

    segs: the segments' int8 codes end to end; seg_lens: their lengths
    (host ints).  Seeds start at 0, stride, 2*stride, ... of each segment
    up to len - seed_len; a window holding a code >= 4 is dropped.  Each
    seed is canonicalised (qflip = rc < packed) and its run looked up
    (run_bounds); a run of 1 to CONTIG_MAX_RUN entries is kept and
    expanded in index order, and an entry is a hit when its genome flip
    equals qflip (the segment as given matches the genome forward); tpos
    is its position.  Runs are expanded ragged, by counts, a cumulative
    sum and repeat_interleave, CONTIG_SEED_BUDGET seeds a batch."""
    budget = CONTIG_SEED_BUDGET
    dev = segs.device
    sl = index.seed_len
    lens = np.asarray(seg_lens, np.int64)
    n_segs = len(lens)
    n_seeds = np.where(lens >= sl, (lens - sl) // stride + 1, 0)
    seed_end_np = np.cumsum(n_seeds)
    S = int(seed_end_np[-1]) if n_segs else 0

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    seg_start = up(np.cumsum(lens) - lens)
    seed_end = up(seed_end_np)
    seed_first = seed_end - up(n_seeds)
    offsets = torch.zeros(n_segs + 1, dtype=torch.int64, device=dev)
    out = {"qpos": [], "tpos": []}
    batches = batch_bytes = 0
    for s0 in range(0, S, budget):
        g = torch.arange(s0, min(S, s0 + budget), device=dev)
        seg = torch.searchsorted(seed_end, g, right=True)
        qpos = (g - seed_first[seg]) * stride
        at = seg_start[seg] + qpos
        del g
        packed = torch.zeros(len(at), dtype=torch.int32, device=dev)
        invalid = torch.zeros(len(at), dtype=torch.bool, device=dev)
        for k in range(sl):
            c = segs[at + k].to(torch.int32)
            invalid |= c >= 4
            packed = (packed << 2) | torch.where(c >= 4, 0, c)
        del at, c
        rc = rc_packed(packed, sl)
        qflip = rc < packed
        lo, hi = run_bounds(index, torch.minimum(packed, rc))
        cnt = hi - lo
        del packed, rc, hi
        kept = (~invalid & (cnt >= 1)
                & (cnt <= CONTIG_MAX_RUN)).nonzero()[:, 0]
        seg, qpos, lo, cnt, qflip = (a[kept] for a in
                                     (seg, qpos, lo, cnt, qflip))
        H = int(cnt.sum())
        batches += 1
        batch_bytes = max(batch_bytes, CONTIG_SEED_BYTES * len(invalid)
                          + CONTIG_HIT_BYTES * H)
        del invalid, kept
        # each kept seed's run, seed-major, in index order
        run = torch.repeat_interleave(cnt, output_size=H)
        first = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
        slot = torch.arange(H, dtype=torch.int32, device=dev) - first[run]
        pf = index.sorted_posflip[lo[run] + slot]
        del slot
        fwd = ((pf < 0) == qflip[run]).nonzero()[:, 0]
        run = run[fwd]
        offsets[1:] += torch.bincount(seg[run], minlength=n_segs)
        out["qpos"].append(qpos[run])
        out["tpos"].append((pf[fwd] & POS_MASK).long())
    cat = {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.int64,
                                                  device=dev)
           for k, v in out.items()}
    return ContigSeedHits(offsets=torch.cumsum(offsets, 0), seeds=S,
                          batches=batches, batch_bytes=batch_bytes, **cat)
