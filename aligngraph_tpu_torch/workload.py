"""Synthetic workloads of the benchmarks (numpy only).

make_workload, a copy of bench.make_workload (bench.py imports jax): a
random genome, a closely related reference (1% SNPs), and 100 bp PE reads
at a 500 bp insert drawn from the unmutated genome with 0.3% sequencing
errors.

make_pipeline_workload, with copies of bench_pipeline.py's mutate_fast,
simulate_pe_reads and cut_contigs (bench_pipeline.py imports jax): a
target genome, a reference = target + 1% SNPs + small indels, PE 100 bp
reads from the target at a given depth, and ~3 kb draft contigs of the
target separated by insert-bridgeable gaps.

make_bigscale_workload: scripts/bigscale_run.py's workload (the same
generators and order, seed 11), for the big-genome run
(aligngraph_tpu_torch/bigscale.py).

write_reads_fasta: a workload's reads as the CLI's two FASTA files.

The same arguments give the same arrays as the benchmark scripts.
"""

from __future__ import annotations

import os

import numpy as np


def make_workload(genome_len=4_600_000, n_pairs=100_000, read_len=100,
                  insert=500, snp=0.01, seed=0, return_target=False):
    """-> (ref int8 [G], data int8 [2*n_pairs, read_len] mate-interleaved,
    lens int32 [n_pairs]), plus the unmutated genome if return_target."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, genome_len).astype(np.int8)
    ref = target.copy()
    m = rng.random(genome_len) < snp
    ref[m] = (ref[m] + rng.integers(1, 4, int(m.sum()))) % 4
    starts = rng.integers(0, genome_len - insert - 1, n_pairs)
    idx1 = starts[:, None] + np.arange(read_len)[None, :]
    r1 = target[idx1]
    idx2 = (starts + insert - read_len)[:, None] + \
        np.arange(read_len)[None, :]
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    r2 = comp[target[idx2]][:, ::-1]
    # sequencing errors 0.3%
    for r in (r1, r2):
        e = rng.random(r.shape) < 0.003
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
    data = np.empty((2 * n_pairs, read_len), np.int8)
    data[0::2] = r1
    data[1::2] = r2
    lens = np.full(n_pairs, read_len, np.int32)
    if return_target:
        return ref, data, lens, target
    return ref, data, lens


COMP = np.array([3, 2, 1, 0, 4], np.int8)


def mutate_fast(rng, target, snp=0.01, indel=0.0005, max_indel=3):
    """Vectorized SNP + small-indel mutation (tests/simdata.mutate
    semantics at Mb scale)."""
    n = len(target)
    out = target.copy()
    m = rng.random(n) < snp
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    ev = np.nonzero(rng.random(n) < indel)[0]
    if len(ev) == 0:
        return out
    pieces, prev = [], 0
    for p in ev:
        if p < prev:
            continue
        if rng.random() < 0.5:       # deletion from target
            d = int(rng.integers(1, max_indel + 1))
            pieces.append(out[prev:p])
            prev = p + d
        else:                        # insertion
            ins = rng.integers(0, 4, int(rng.integers(1, max_indel + 1)))
            pieces.append(out[prev:p + 1])
            pieces.append(ins.astype(np.int8))
            prev = p + 1
    pieces.append(out[prev:])
    return np.concatenate(pieces)


# pairs simulate_pe_reads makes at a time
READ_BLOCK_PAIRS = 1 << 18


def simulate_pe_reads(rng, target, n_pairs, read_len=100, insert=500,
                      insert_sd=30, err=0.003):
    """Vectorized FR PE read simulation with gaussian insert sizes ->
    (data int8 [2*n_pairs, read_len] mate-interleaved, lens int32).

    The reads, then the sequencing-error mask, are made READ_BLOCK_PAIRS
    pairs at a time: consecutive rng.random calls draw the doubles that
    one call over the whole read matrix would, so the output is
    bench_pipeline.py's, without its [2*n_pairs, read_len] float64 mask
    and int64 gather indices (10 GB each at 64 Mb and 20x)."""
    n = len(target)
    ins = np.clip(rng.normal(insert, insert_sd, n_pairs).astype(np.int64),
                  2 * read_len, n - 1)
    starts = (rng.random(n_pairs) * (n - ins - 1)).astype(np.int64)
    data = np.empty((2 * n_pairs, read_len), np.int8)
    j = np.arange(read_len)
    for s in range(0, n_pairs, READ_BLOCK_PAIRS):
        e = min(s + READ_BLOCK_PAIRS, n_pairs)
        st = starts[s:e, None]
        data[2 * s:2 * e:2] = target[st + j]
        data[2 * s + 1:2 * e:2] = COMP[target[st + ins[s:e, None]
                                              - read_len + j]][:, ::-1]
    flat = data.reshape(-1)
    hits = [np.zeros(0, np.int64)]
    rows = 2 * READ_BLOCK_PAIRS
    for s in range(0, 2 * n_pairs, rows):
        blk = rng.random((min(rows, 2 * n_pairs - s), read_len)) < err
        hits.append(np.flatnonzero(blk) + s * read_len)
    e = np.concatenate(hits)
    flat[e] = (flat[e] + rng.integers(1, 4, len(e))) % 4
    return data, np.full(n_pairs, read_len, np.int32)


def cut_contigs(rng, target, mean_len=3000, gap_lo=50, gap_hi=400):
    """Draft fragments of the target with insert-bridgeable gaps."""
    n = len(target)
    seqs, pos = [], 0
    while pos + 500 < n:
        ln = max(400, int(rng.normal(mean_len, mean_len // 3)))
        e = min(pos + ln, n)
        seqs.append(target[pos:e])
        pos = e + int(rng.integers(gap_lo, gap_hi))
    return seqs


def make_pipeline_workload(genome_len=4_600_000, depth=25.0, read_len=100,
                           seed=7, n_pairs=None):
    """bench_pipeline.py's workload -> (target, ref, data, lens,
    contig_seqs); n_pairs, by default depth * genome_len / (2 *
    read_len) pairs."""
    if n_pairs is None:
        n_pairs = int(depth * genome_len / (2 * read_len))
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, genome_len).astype(np.int8)
    ref = mutate_fast(rng, target)
    data, lens = simulate_pe_reads(rng, target, n_pairs, read_len=read_len)
    return target, ref, data, lens, cut_contigs(rng, target)


# pairs write_reads_fasta formats at a time
FASTA_BLOCK_PAIRS = 1 << 16


def write_reads_fasta(d, data, lens, width=60):
    """Mate-interleaved reads (data [2 * n_pairs, L] int8, lens [n_pairs])
    as d/r1.fa and d/r2.fa, pair i named p{i}: the bytes that
    io.fasta.write_fasta writes for [f"p{i}" ...] and [decode(data[2 * i
    + mate, :lens[i]]) ...], formatted a block of pairs at a time."""
    from aligngraph_tpu_torch.io.fasta import ALPHABET

    dec = np.frombuffer(ALPHABET, np.uint8)
    n, L = len(lens), data.shape[1]
    for mate in (0, 1):
        with open(os.path.join(d, f"r{mate + 1}.fa"), "wb") as f:
            for s in range(0, n, FASTA_BLOCK_PAIRS):
                e = min(s + FASTA_BLOCK_PAIRS, n)
                buf = dec[data[2 * s + mate:2 * e:2]].tobytes()
                out = []
                for i in range(s, e):
                    o = (i - s) * L
                    seq = buf[o:o + int(lens[i])]
                    out.append(b">p%d\n" % i)
                    out.extend(seq[j:j + width] + b"\n"
                               for j in range(0, len(seq), width))
                f.write(b"".join(out))


def make_bigscale_workload(genome_len, depth, seed=11, read_len=100):
    """scripts/bigscale_run.py's workload -> (target, ref, data, lens,
    contig_seqs): the same generators as make_pipeline_workload, drawn in
    the script's order from seed 11."""
    return make_pipeline_workload(genome_len, depth, read_len, seed)


def tile_lanes(rng, B, L=512, pad=16, G=1_000_000, max_indel=6):
    """DP lanes shaped as the contig aligner's tile jobs: tiles of a random
    genome with 1% SNPs and up to two indels of 1..max_indel bases, a
    diagonal estimate off by up to +-12, ~10% partial tiles, every 29th
    lane of length 0 (a padding lane); windows[c, x] = genome[g0 - pad + x]
    (4 outside).  -> numpy (tiles int8 [B, L], tlens int32, windows int8
    [B, L + 2*pad], g0 int32)."""
    genome = rng.integers(0, 4, G).astype(np.int8)
    tiles = np.full((B, L), 4, np.int8)
    tlens = np.full(B, L, np.int32)
    part = rng.random(B) < 0.1
    tlens[part] = rng.integers(1, L, int(part.sum()))
    tlens[::29] = 0
    g0 = np.zeros(B, np.int32)
    for c in range(B):
        st = int(rng.integers(4 * L, G - 4 * L))
        src = genome[st:st + 2 * L].copy()
        snp = rng.random(len(src)) < 0.01
        src[snp] = (src[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(8, L - 8))
            n = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5:
                src = np.concatenate([src[:at], src[at + n:]])
            else:
                src = np.concatenate([src[:at], rng.integers(
                    0, 4, n).astype(np.int8), src[at:]])
        tiles[c, :tlens[c]] = src[:tlens[c]]
        g0[c] = st + int(rng.integers(-12, 13))
    x = g0[:, None].astype(np.int64) - pad + np.arange(L + 2 * pad)[None, :]
    windows = np.where((x >= 0) & (x < G), genome[np.clip(x, 0, G - 1)],
                       np.int8(4)).astype(np.int8)
    return tiles, tlens, windows, g0


# --- the small simulator of the tests (a copy of tests/simdata.py's
# make_simdata; the same seed gives the same arrays) -----------------------

def _mutate(rng, seq, snp_rate=0.01, indel_rate=0.0005, max_indel=3):
    """SNPs + small indels -> a 'closely related' genome."""
    out = []
    i = 0
    n = len(seq)
    snp_mask = rng.random(n) < snp_rate
    indel_mask = rng.random(n) < indel_rate
    while i < n:
        b = seq[i]
        if snp_mask[i]:
            b = (b + rng.integers(1, 4)) % 4
        if indel_mask[i]:
            if rng.random() < 0.5:  # deletion from target
                i += int(rng.integers(1, max_indel + 1))
                continue
            ins = rng.integers(0, 4, size=int(rng.integers(1, max_indel + 1)))
            out.append(np.array([b], dtype=np.int8))
            out.append(ins.astype(np.int8))
            i += 1
            continue
        out.append(np.array([b], dtype=np.int8))
        i += 1
    return np.concatenate(out) if out else np.zeros(0, np.int8)


def _simulate_reads(rng, target, n_pairs, read_len, insert, err_rate,
                    insert_sd=30):
    """FR PE reads: mate 1 forward at p, mate 2 the reverse complement of
    [p+ins-L, p+ins)."""
    n = len(target)
    reads1, reads2 = [], []
    for _ in range(n_pairs):
        ins = int(np.clip(rng.normal(insert, insert_sd), 2 * read_len, n - 1))
        p = int(rng.integers(0, n - ins))
        r1 = target[p:p + read_len].copy()
        r2 = COMP[target[p + ins - read_len:p + ins]][::-1]
        for r in (r1, r2):
            errs = np.nonzero(rng.random(read_len) < err_rate)[0]
            r[errs] = (r[errs] + rng.integers(1, 4, size=len(errs))) % 4
        reads1.append(r1)
        reads2.append(r2)
    return reads1, reads2


def _simulate_contigs(rng, target, n_contigs, mean_len=3000, min_len=400):
    """Disjoint draft fragments of the target with gaps between them."""
    n = len(target)
    starts = np.sort(rng.choice(n, size=n_contigs, replace=False))
    contigs = []
    prev_end = 0
    for s in starts:
        s = max(int(s), prev_end + 50)
        ln = max(min_len, int(rng.normal(mean_len, mean_len // 3)))
        e = min(s + ln, n)
        if e - s < min_len or s >= n:
            continue
        contigs.append(target[s:e].copy())
        prev_end = e
    return contigs


def make_simdata(seed=0, genome_len=50_000, n_pairs=2000, read_len=100,
                 insert=500, n_contigs=12, snp_rate=0.01, err_rate=0.005):
    """-> (target, reference, reads1, reads2, contigs): a random target, a
    reference = target + SNPs + small indels, PE reads from the target and
    draft contigs of it, as the tests' simulator makes them."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, size=genome_len).astype(np.int8)
    reference = _mutate(rng, target, snp_rate=snp_rate)
    reads1, reads2 = _simulate_reads(rng, target, n_pairs, read_len, insert,
                                     err_rate)
    contigs = _simulate_contigs(rng, target, n_contigs)
    return target, reference, reads1, reads2, contigs
