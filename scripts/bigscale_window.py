"""One window of the big-genome workload as a run of its own: the share
of aligngraph_tpu_torch.bigscale's data that lies in target[lo, hi), to
be reassembled by the port and by any other implementation of the same
CLI on the same files.

    python3 scripts/bigscale_window.py genome_mb depth lo_mb hi_mb out_dir
        [--device cuda|cpu]

It makes workload.make_bigscale_workload(genome_mb, depth) (seed 11) and
keeps the pairs whose insert lies inside the window, the draft contigs
inside it, and the stretch of the reference homologous to it (its ends
found by exact 24-mer matches next to lo and hi).  It writes to out_dir
target.fa, genome.fa, contigs.fa, read_1.fa and read_2.fa, then runs the
port's CLI there (`--ratioCheck`, distance 300-700, the host k-mer build
as the CLI's default; work dir out_dir/tmp) into extended.fa, and the
port's Eval of it against target.fa; one JSON line.  The JAX package's
CLI on the same files, from out_dir:
    python -m aligngraph_tpu --read1 read_1.fa --read2 read_2.fa \\
        --contig contigs.fa --genome genome.fa --distanceLow 300 \\
        --distanceHigh 700 --ratioCheck --extendedContig jax_extended.fa \\
        --remainingContig jax_remaining.fa
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aligngraph_tpu_torch import workload  # noqa: E402
from aligngraph_tpu_torch.__main__ import main as cli  # noqa: E402
from aligngraph_tpu_torch.evaluate.evaluate import evaluate  # noqa: E402
from aligngraph_tpu_torch.io.fasta import decode, write_fasta  # noqa: E402

READ_LEN = 100
ANCHOR = 24


def window_workload(glen: int, depth: float, lo: int, hi: int):
    """make_bigscale_workload's draws, with each pair's insert and each
    draft contig's start -> (target, ref, data, pair mask, contig
    seqs, contig mask)."""
    n_pairs = int(depth * glen / (2 * READ_LEN))
    rng = np.random.default_rng(11)
    target = rng.integers(0, 4, glen).astype(np.int8)
    ref = workload.mutate_fast(rng, target)
    # simulate_pe_reads' first two draws: insert sizes, then starts
    state = rng.bit_generator.state
    ins = np.clip(rng.normal(500, 30, n_pairs).astype(np.int64),
                  2 * READ_LEN, glen - 1)
    starts = (rng.random(n_pairs) * (glen - ins - 1)).astype(np.int64)
    rng.bit_generator.state = state
    data, _ = workload.simulate_pe_reads(rng, target, n_pairs)
    # cut_contigs with each contig's start
    state = rng.bit_generator.state
    seqs = workload.cut_contigs(rng, target)
    rng.bit_generator.state = state
    cstart, pos = [], 0
    while pos + 500 < glen:
        ln = max(400, int(rng.normal(3000, 1000)))
        cstart.append(pos)
        pos = min(pos + ln, glen) + int(rng.integers(50, 400))
    cstart = np.array(cstart, np.int64)
    assert len(cstart) == len(seqs) and all(
        np.array_equal(s, target[c:c + len(s)])
        for s, c in zip(seqs[:50], cstart[:50]))
    assert np.sum(data[0] != target[starts[0]:starts[0] + READ_LEN]) <= 3
    pairs = (starts >= lo) & (starts + ins <= hi)
    clen = np.array([len(s) for s in seqs], np.int64)
    cmask = (cstart >= lo) & (cstart + clen <= hi)
    return target, ref, data, pairs, seqs, cmask


def ref_position(target, ref, at: int) -> int:
    """The reference position homologous to target position `at`: the
    first of the 24-mers at at, at+1, ... found once in the reference
    within 20 kb of it."""
    rb = decode(ref)
    for j in range(0, 5_000):
        probe = decode(target[at + j:at + j + ANCHOR])
        lo = max(0, at - 20_000)
        hit = rb.find(probe, lo, at + 20_000)
        if hit >= 0 and rb.find(probe, hit + 1, at + 20_000) < 0:
            return hit - j
    raise RuntimeError(f"no anchor next to {at}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("genome_mb", type=float)
    ap.add_argument("depth", type=float)
    ap.add_argument("lo_mb", type=float)
    ap.add_argument("hi_mb", type=float)
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    glen = int(a.genome_mb * 1e6)
    lo, hi = int(a.lo_mb * 1e6), int(a.hi_mb * 1e6)
    out = Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    target, ref, data, pairs, seqs, cmask = window_workload(
        glen, a.depth, lo, hi)
    rlo = ref_position(target, ref, lo)
    rhi = ref_position(target, ref, hi - 5_000) + 5_000
    idx = np.flatnonzero(pairs)
    write_fasta(out / "target.fa", ["window"], [decode(target[lo:hi])])
    write_fasta(out / "genome.fa", ["window"], [decode(ref[rlo:rhi])])
    write_fasta(out / "contigs.fa",
                [f"c{i}" for i in np.flatnonzero(cmask)],
                [decode(seqs[i]) for i in np.flatnonzero(cmask)])
    for m in (0, 1):
        write_fasta(out / f"read_{m + 1}.fa", [f"p{i}" for i in idx],
                    [decode(data[2 * i + m]) for i in idx])
    del data
    row = dict(genome_mb=a.genome_mb, depth=a.depth, lo=lo, hi=hi,
               ref_lo=rlo, ref_hi=rhi, pairs=len(idx),
               contigs=int(cmask.sum()))
    cwd = os.getcwd()
    os.chdir(out)
    try:
        t0 = time.time()
        rc = cli(["--read1", "read_1.fa", "--read2", "read_2.fa",
                  "--contig", "contigs.fa", "--genome", "genome.fa",
                  "--distanceLow", "300", "--distanceHigh", "700",
                  "--ratioCheck", "--extendedContig", "extended.fa",
                  "--remainingContig", "remaining.fa"], device=a.device)
        row["pipeline_s"] = round(time.time() - t0, 1)
        if rc != 0:
            raise SystemExit(rc)
        m = evaluate("target.fa", "extended.fa", out_path="stats.txt",
                     device=a.device)
    finally:
        os.chdir(cwd)
    row.update(m)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
