"""Synthetic PE workload of the read-aligner benchmark (numpy only).

A copy of bench.make_workload (bench.py imports jax): a random genome, a
closely related reference (1% SNPs), and 100 bp PE reads at a 500 bp
insert drawn from the unmutated genome with 0.3% sequencing errors.  The
same arguments give the same arrays as bench.make_workload.
"""

from __future__ import annotations

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
