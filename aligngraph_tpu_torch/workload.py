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

make_multichrom_workload: a genome of several chromosomes (YEAST_R64's
lengths for BASELINE.json config 2), each with its own reads and draft
contigs; write_multichrom_fasta writes it as the CLI's inputs.

make_misassembly_workload: make_pipeline_workload's genome, reads and
drafts with a share of the drafts joined into chimeras of two distant
drafts and random junk (BASELINE.json config 3); write_misassembly_fasta
writes it as bigscale.run writes its workload.

make_bigscale_workload: scripts/bigscale_run.py's workload (the same
generators and order, seed 11), for the big-genome run
(aligngraph_tpu_torch/bigscale.py).

write_reads_fasta: a workload's reads as the CLI's two FASTA files.

make_tandem_workload: tandem copies of one unit between random flanks,
with read blocks from each region (the read aligner's buffer overflow).

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
    return cut_contigs_at(rng, target, mean_len, gap_lo, gap_hi)[0]


def cut_contigs_at(rng, target, mean_len=3000, gap_lo=50, gap_hi=400):
    """cut_contigs' fragments (the same draws) -> (seqs, homes int64: each
    fragment's start in the target)."""
    n = len(target)
    seqs, homes, pos = [], [], 0
    while pos + 500 < n:
        ln = max(400, int(rng.normal(mean_len, mean_len // 3)))
        e = min(pos + ln, n)
        seqs.append(target[pos:e])
        homes.append(pos)
        pos = e + int(rng.integers(gap_lo, gap_hi))
    return seqs, np.array(homes, np.int64)


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


def make_tandem_workload(pairs=(800, 224, 1024), unit_len=2000, copies=4,
                         flank_len=6000, read_len=100, insert=400, seed=5):
    """A genome of `copies` tandem copies of one random unit between two
    random flanks, and PE reads (simulate_pe_reads) in three blocks:
    pairs[0] from the first flank, pairs[1] from the repeat, pairs[2]
    from the second flank.  A repeat pair aligns at up to `copies` places
    (its seeds have `copies` hits, within Config's max_seed_hits 8 and
    max_candidates 4).  The default blocks in batches of 1,024 pairs put
    224 repeat pairs among 800 unique ones in the first batch: the read
    aligner's DP capacity (1.5 candidates a read) then keeps most of their
    candidates, and the batch holds more extra hits than its dense buffer
    and more records than its per-slot buffer (distance_high 40,000);
    the second batch holds unique pairs only.
    -> (genome int8, data int8 [2n, read_len] mate-interleaved, lens)."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 4, flank_len).astype(np.int8)
    repeat = np.tile(rng.integers(0, 4, unit_len).astype(np.int8), copies)
    second = rng.integers(0, 4, flank_len).astype(np.int8)
    blocks = [simulate_pe_reads(rng, region, n, read_len, insert)
              for region, n in zip((first, repeat, second), pairs)]
    return (np.concatenate([first, repeat, second]),
            np.concatenate([b[0] for b in blocks]),
            np.concatenate([b[1] for b in blocks]))


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


# S. cerevisiae S288C's nuclear genome, assembly R64 (GCF_000146045.2):
# chromosome names and lengths (BASELINE.json config 2), 12,071,326 bp
YEAST_R64 = (
    ("chrI", 230_218), ("chrII", 813_184), ("chrIII", 316_620),
    ("chrIV", 1_531_933), ("chrV", 576_874), ("chrVI", 270_161),
    ("chrVII", 1_090_940), ("chrVIII", 562_643), ("chrIX", 439_888),
    ("chrX", 745_751), ("chrXI", 666_816), ("chrXII", 1_078_177),
    ("chrXIII", 924_431), ("chrXIV", 784_333), ("chrXV", 1_091_291),
    ("chrXVI", 948_066))


def make_multichrom_workload(chrom_lens, depth, seed, read_len=100,
                             insert=500):
    """A genome of several chromosomes, each made as make_pipeline_workload
    makes its one, from one generator in chromosome order: the target,
    reference = mutate_fast(target), the chromosome's PE reads
    (simulate_pe_reads, so no pair crosses a chromosome's end) and its
    draft contigs (cut_contigs).  The pairs are depth * length / (2 *
    read_len) of all chromosomes, each chromosome taking floor(depth *
    (its end) / (2 * read_len)) less the same of its start: in proportion
    to its length, within one pair.
    -> dict(targets, refs: lists of int8 arrays; data int8 [2n, read_len]
    mate-interleaved, lens int32 [n], pair_chrom int32 [n]: the reads of
    every chromosome in turn; contigs: list of int8 arrays, contig_chrom
    int32)."""
    rng = np.random.default_rng(seed)
    ends = np.cumsum(np.asarray(chrom_lens, np.int64))
    cum = (depth * ends / (2 * read_len)).astype(np.int64)
    n_pairs = np.diff(np.concatenate([[0], cum]))
    out = dict(targets=[], refs=[], data=[], lens=[], pair_chrom=[],
               contigs=[], contig_chrom=[])
    for c, (ln, n) in enumerate(zip(chrom_lens, n_pairs)):
        target = rng.integers(0, 4, int(ln)).astype(np.int8)
        out["targets"].append(target)
        out["refs"].append(mutate_fast(rng, target))
        data, lens = simulate_pe_reads(rng, target, int(n), read_len,
                                       insert)
        out["data"].append(data)
        out["lens"].append(lens)
        out["pair_chrom"].append(np.full(int(n), c, np.int32))
        contigs = cut_contigs(rng, target)
        out["contigs"] += contigs
        out["contig_chrom"].append(np.full(len(contigs), c, np.int32))
    for key in ("data", "lens", "pair_chrom", "contig_chrom"):
        out[key] = np.concatenate(out[key])
    return out


def write_multichrom_fasta(d, names, wl) -> None:
    """make_multichrom_workload's output as the CLI's inputs in d:
    genome.fa (the references, one record a chromosome), target.fa (the
    targets, for Eval), contigs.fa (contig j of chromosome c named
    "{names[c]}.c{j}") and r1.fa / r2.fa (write_reads_fasta)."""
    from aligngraph_tpu_torch.io.fasta import decode, write_fasta

    write_fasta(os.path.join(d, "genome.fa"), list(names),
                [decode(s) for s in wl["refs"]])
    write_fasta(os.path.join(d, "target.fa"), list(names),
                [decode(s) for s in wl["targets"]])
    ids, seen = [], {}
    for c in wl["contig_chrom"]:
        j = seen[c] = seen.get(c, -1) + 1
        ids.append(f"{names[c]}.c{j}")
    write_fasta(os.path.join(d, "contigs.fa"), ids,
                [decode(s) for s in wl["contigs"]])
    write_reads_fasta(d, wl["data"], wl["lens"])


def make_bigscale_workload(genome_len, depth, seed=11, read_len=100):
    """scripts/bigscale_run.py's workload -> (target, ref, data, lens,
    contig_seqs): the same generators as make_pipeline_workload, drawn in
    the script's order from seed 11."""
    return make_pipeline_workload(genome_len, depth, read_len, seed)


def make_misassembly_workload(genome_len, depth, seed, read_len=100,
                              insert=500, chimera_frac=0.04,
                              junk=(300, 600), min_apart=1_000_000,
                              draft_len=3000):
    """A genome with chimeric draft contigs, for misassembly removal
    (BASELINE.json config 3).  make_pipeline_workload's generators in its
    order: the target, reference = mutate_fast(target), depth *
    genome_len / (2 * read_len) PE pairs at `insert`, and cut_contigs'
    drafts of mean length draft_len.  Then round(chimera_frac * drafts /
    2) chimeras, so that chimera_frac of the cut drafts go into one:
    chimera k joins draft i, junk[0] to junk[1] random bases and draft j,
    whose home lies at least min_apart from i's, reverse-complemented in
    every odd k.  i is drawn among the drafts not yet used, j among those
    far enough from it.  The chimera takes draft i's place in the list
    and draft j leaves it, so each region of the target is in one draft.
    -> dict(target, ref: int8 arrays; data int8 [2n, read_len]
    mate-interleaved, lens int32 [n]; contigs: list of int8 arrays;
    homes int64: each draft's start in the target (a chimera's: draft
    i's); chimera_index int64: each chimera's place in contigs;
    chimera_homes, chimera_lens int64 [n_chimeras, 2]: the homes and
    lengths of its drafts i and j; chimera_junk int64: its junk length;
    chimera_rc bool: draft j reverse-complemented; n_cut: the drafts
    cut_contigs made).

    The two kinds of chimera are QUAST's misassemblies (Gurevich et al.
    2013, Bioinformatics 29:1072): the sides of a junction align over 1
    kb apart on one strand (a relocation: draft j as it is) or on
    opposite strands (an inversion: draft j reverse-complemented).  The
    rest has no public source: BASELINE.json config 3 names only a
    high-coverage PE library and --misassemblyRemoval, and its A.
    thaliana drafts are not in the repository.  So chimera_frac (4 % of
    the drafts in a chimera), the one-to-one mix of the two kinds, the
    junk (300 to 600 bases of unresolved junction sequence) and min_apart
    (1 Mb, far past QUAST's 1 kb) are assumptions; chimera_outcomes and
    outcomes_by_strand report the two kinds apart."""
    n_pairs = int(depth * genome_len / (2 * read_len))
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 4, genome_len).astype(np.int8)
    ref = mutate_fast(rng, target)
    data, lens = simulate_pe_reads(rng, target, n_pairs, read_len=read_len,
                                   insert=insert)
    seqs, homes = cut_contigs_at(rng, target, mean_len=draft_len)
    n_cut = len(seqs)
    n_chim = int(round(chimera_frac * n_cut / 2))
    free = np.ones(n_cut, bool)
    joins = []                       # (i, j, junk length), in draw order
    for k in range(n_chim):
        i = int(rng.choice(np.flatnonzero(free)))
        free[i] = False
        far = np.flatnonzero(free & (np.abs(homes - homes[i]) >= min_apart))
        if len(far) == 0:
            raise ValueError(f"no draft lies {min_apart} bases from draft "
                             f"{i}'s home {homes[i]}: lower min_apart")
        j = int(rng.choice(far))
        free[j] = False
        joins.append((i, j, int(rng.integers(junk[0], junk[1] + 1))))
    chimera_of = {}
    for k, (i, j, jl) in enumerate(joins):
        tail = COMP[seqs[j]][::-1] if k % 2 else seqs[j]
        chimera_of[i] = (k, np.concatenate(
            [seqs[i], rng.integers(0, 4, jl).astype(np.int8), tail]))
    gone = {j for _, j, _ in joins}
    contigs, keep, index = [], [], np.zeros(n_chim, np.int64)
    for i in range(n_cut):
        if i in gone:
            continue
        if i in chimera_of:
            k, seq = chimera_of[i]
            index[k] = len(contigs)
            contigs.append(seq)
        else:
            contigs.append(seqs[i])
        keep.append(i)
    return dict(
        target=target, ref=ref, data=data, lens=lens, contigs=contigs,
        homes=homes[keep], chimera_index=index,
        chimera_homes=np.array([(homes[i], homes[j]) for i, j, _ in joins],
                               np.int64).reshape(-1, 2),
        chimera_lens=np.array([(len(seqs[i]), len(seqs[j]))
                               for i, j, _ in joins], np.int64).reshape(-1, 2),
        chimera_junk=np.array([jl for _, _, jl in joins], np.int64),
        chimera_rc=np.arange(n_chim) % 2 == 1, n_cut=n_cut)


def chimera_outcomes(chimeras, masb: dict, ids: dict) -> list:
    """How misassembly removal left each generated chimera (its draft id,
    c{i}), from remove_misassembly's stats per file (masb: {file: stats},
    their split_ids and whole_safe_ids) and the ids of the files it read
    (ids: {file: [id, ...]}): "split" when a contig holding the chimera
    (its id is a word of the contig's id) was cut into parts, "whole"
    when such a contig was kept whole by the 0.8 rule, "kept" when such a
    contig came out as one piece otherwise, "absent" when no contig holds
    it -> one of those a chimera."""
    words = {"split": set(), "whole": set(), "kept": set()}
    for which, st in masb.items():
        for cid in st["split_ids"]:
            words["split"].update(cid.split())
        for cid in st["whole_safe_ids"]:
            words["whole"].update(cid.split())
        for cid in ids[which]:
            words["kept"].update(cid.split())
    return [next((k for k in words if c in words[k]), "absent")
            for c in chimeras]


def outcomes_by_strand(outcomes, rc) -> dict:
    """chimera_outcomes' list counted apart for the chimeras whose second
    draft is as it is ("forward", QUAST's relocations) and those whose
    second draft is reverse-complemented ("rc", inversions)."""
    return {strand: {k: sum(o == k for o, r in zip(outcomes, rc)
                            if bool(r) == (strand == "rc"))
                     for k in ("split", "whole", "kept", "absent")}
            for strand in ("forward", "rc")}


def write_misassembly_fasta(d, wl) -> None:
    """make_misassembly_workload's output in d as bigscale.run writes its
    workload: genome.fa (the reference) and target.fa, one record "chr"
    each, and contigs.fa (draft i named c{i})."""
    from aligngraph_tpu_torch.io.fasta import decode, write_fasta

    write_fasta(os.path.join(d, "genome.fa"), ["chr"], [decode(wl["ref"])])
    write_fasta(os.path.join(d, "target.fa"), ["chr"],
                [decode(wl["target"])])
    write_fasta(os.path.join(d, "contigs.fa"),
                [f"c{i}" for i in range(len(wl["contigs"]))],
                [decode(c) for c in wl["contigs"]])


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


# where the multi-chromosome cases cut the small sim's genomes into
# chromosomes of unequal length, one shorter than 5 kb
SIM_CHROM_CUTS = (4_000, 16_000)


def split_chromosomes(seq, cuts=SIM_CHROM_CUTS):
    """seq cut at `cuts` -> len(cuts) + 1 chromosomes."""
    return np.split(np.asarray(seq), list(cuts))


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
