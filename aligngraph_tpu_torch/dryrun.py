"""Multi-device dry run of the port: the counterpart of
__graft_entry__.dryrun_multichip.

    python3 -m aligngraph_tpu_torch.dryrun [--nproc N] [--device cuda|cpu]

Spawns N ranks (default: one a visible GPU; NCCL on cuda, gloo on cpu,
parallel/mesh.run_ranks) and runs every multi-device path once on tiny
shapes, asserting what the JAX dry run asserts:
  - the data-parallel aligner finds records, and the ranks' record
    counts sum to their all_reduce'd total
  - the halo-exchange window sum runs
  - position-sharded span coverage equals span_coverage_np
  - the position-sharded k-mer build equals the host oracle
    (build_kmer_layer) on km_cnt, km_cov, km_votes, km_s, ed_cnt, ed_pos
    and ed_item
and prints one line.

entry() -> (fn, args) is the counterpart of __graft_entry__.entry(): the
single-card align step (the reverse complement on the device, then the
read aligner's _align_core, as the JAX package's _align_pairs_device) and
its arguments on __graft_entry__'s tiny shapes, on the card by default.
The port runs eagerly, so fn(*args) is the step; nothing is traced.

The shard_* functions are the per-rank pieces: each takes the whole input
on every rank, runs its shard of one multi-device path and returns the
whole result on every rank.  run_jobs runs a list of them in one launch
of the ranks (tests/test_torch_parallel.py holds them to the JAX
package's sharded functions).
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aligngraph_tpu_torch.align.read_aligner import (
    MAX_PAIR_HITS, ReadAligner, _align_core, revcomp_padded,
    score_min_table)
from aligngraph_tpu_torch.config import THRESHOLD, Config
from aligngraph_tpu_torch.graph.kmer_layer import build_kmer_layer
from aligngraph_tpu_torch.graph.model import GraphTensors
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.parallel.coverage import (make_sharded_coverage,
                                                    pad_spans,
                                                    span_coverage_np)
from aligngraph_tpu_torch.parallel.halo import (exchange_halos,
                                                sliding_window_sum_sharded)
from aligngraph_tpu_torch.parallel.kmer_shard import build_kmer_layer_sharded
from aligngraph_tpu_torch.parallel.mesh import (gather_blocks,
                                                make_sharded_aligner,
                                                run_ranks)
from aligngraph_tpu_torch.pipeline.driver import _subset_pairs

KM_CHECKED = ("km_cnt", "km_cov", "km_votes", "km_s", "ed_cnt", "ed_pos",
              "ed_item")


def _gather(mesh, t: torch.Tensor) -> np.ndarray:
    """Every rank's block t (one shape on every rank), stacked in rank
    order: [S, *t.shape] on the host."""
    return gather_blocks(mesh, t).view((mesh.world_size,) + tuple(t.shape)) \
        .cpu().numpy()


def _block(mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's contiguous block of x (length a multiple of S)."""
    n = len(x) // mesh.world_size
    return torch.from_numpy(
        np.ascontiguousarray(x[mesh.rank * n:(mesh.rank + 1) * n])).to(
            mesh.device)


def shard_halo(mesh, x: np.ndarray, halo: int) -> np.ndarray:
    """exchange_halos on each rank's block of x: [S, halo + n + halo]."""
    return _gather(mesh, exchange_halos(_block(mesh, x), mesh, halo))


def shard_window_sum(mesh, x: np.ndarray, window: int) -> np.ndarray:
    """sliding_window_sum_sharded over x split into S blocks: [len(x)]."""
    fn = sliding_window_sum_sharded(mesh, window)
    return _gather(mesh, fn(_block(mesh, x))).reshape(-1)


def shard_coverage(mesh, starts: np.ndarray, ends: np.ndarray,
                   G: int) -> np.ndarray:
    """make_sharded_coverage with the spans (padded by pad_spans) split
    into S slices: the whole [G] coverage."""
    s_p, e_p = pad_spans(starts, ends, mesh.world_size)
    fn = make_sharded_coverage(mesh, G)
    return _gather(mesh, fn(_block(mesh, s_p), _block(mesh, e_p))) \
        .reshape(-1)


def shard_align(mesh, genome: np.ndarray, cfg: Config, reads: Reads,
                batch_pairs: int = 32768):
    """make_sharded_aligner over a ReadAligner on every rank's device:
    ShardedRecords of all pairs."""
    al = ReadAligner.build(genome, cfg, batch_pairs=batch_pairs,
                           device=mesh.device)
    return make_sharded_aligner(mesh, al)(reads)


def shard_kmer(mesh, g: GraphTensors, pairs, reads, k: int,
               insert_variation: int, chunk_records=None):
    """build_kmer_layer_sharded into g: (g, its stats)."""
    st = build_kmer_layer_sharded(g, pairs, reads, k, insert_variation, mesh,
                                  chunk_records=chunk_records)
    return g, st


JOBS = {"halo": shard_halo, "window": shard_window_sum,
        "coverage": shard_coverage, "align": shard_align,
        "kmer": shard_kmer}


def run_jobs(mesh, jobs: List[Tuple[str, tuple]]) -> list:
    """Each (name, args) of jobs through JOBS[name](mesh, *args), in
    order: their results."""
    return [JOBS[name](mesh, *args) for name, args in jobs]


def _tiny_problem(n_pairs=32, L=64, glen=4096, seed=0):
    """__graft_entry__._tiny_problem: a random genome and pairs read from
    it (mate 2 the reverse complement 2L downstream)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen).astype(np.int8)
    comp = np.array([3, 2, 1, 0, 4], np.int8)
    seqs = np.full((2 * n_pairs, L), 4, np.int8)
    plens = np.full(n_pairs, L, np.int32)
    for i in range(n_pairs):
        p = int(rng.integers(0, glen - 4 * L))
        seqs[2 * i] = genome[p:p + L]
        seqs[2 * i + 1] = comp[genome[p + 3 * L - L:p + 3 * L]][::-1]
    return genome, seqs, plens


def align_step(genome_p, index, seqs, plens, smin, *, cfg: Config,
               dlow: int, dhigh: int) -> dict:
    """One batch of pairs (seqs [2P, L] int8 mate-interleaved, plens [P])
    through the single-card align step: revcomp_padded, then _align_core
    with cfg's seeding, band and candidates and the top MAX_PAIR_HITS pairs
    within [dlow, dhigh] -> the full [P, K] layout (a dict of tensors)."""
    rc = revcomp_padded(seqs, plens.repeat_interleave(2))
    return _align_core(genome_p, index, seqs, rc, plens, smin,
                       seed_len=cfg.seed_len, stride=cfg.seed_stride,
                       pad=cfg.band_pad, C=cfg.max_candidates,
                       K=MAX_PAIR_HITS, dlow=dlow, dhigh=dhigh,
                       mh=cfg.max_seed_hits)


def entry(device="cuda"):
    """-> (fn, args): fn(*args) is align_step on __graft_entry__.entry()'s
    problem (_tiny_problem: 32 pairs of 64 bases on a 4,096-base genome;
    Config(), distance 0-99999), its genome and seed index placed on
    `device` as ReadAligner places them.  There is no fallback: "cuda"
    with no CUDA device raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() places the step on a CUDA device and "
                           "none is available")
    cfg = Config()
    genome, seqs, plens = _tiny_problem()
    al = ReadAligner.build(genome, cfg, device=device)
    dev = al.genome_p.device
    fn = functools.partial(align_step, cfg=cfg, dlow=0, dhigh=99999)
    args = (al.genome_p, al.index, torch.from_numpy(seqs).to(dev),
            torch.from_numpy(plens).to(dev),
            torch.from_numpy(score_min_table(seqs.shape[1])).to(dev))
    return fn, args


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def dryrun(mesh) -> str:
    """Every multi-device path once on mesh, on __graft_entry__'s shapes
    and with its assertions; returns the summary line (every rank)."""
    n = mesh.world_size
    n_pairs, L = 8 * n, 64
    genome, seqs, plens = _tiny_problem(n_pairs=n_pairs, L=L, glen=1 << 14)
    reads = Reads(n_pairs, L, seqs, plens)
    res = shard_align(mesh, genome, Config(distance_low=0,
                                           distance_high=99999), reads)
    _check(res.total > 0, "sharded aligner found no records")
    _check(sum(res.per_rank) == res.total,
           f"per-rank records {res.per_rank} must sum to the all_reduce'd "
           f"total {res.total}")

    cov = np.zeros(1 << 14, np.int32)
    cov[0] = 1
    _check(int(shard_window_sum(mesh, cov, 5).sum()) >= 1,
           "halo window sum lost the impulse")

    Gc = n * 512
    rng = np.random.default_rng(1)
    st = rng.integers(0, Gc - 1, 64 * n).astype(np.int32)
    en = (st + rng.integers(1, 200, len(st))).astype(np.int32)
    _check(np.array_equal(shard_coverage(mesh, st, en, Gc),
                          span_coverage_np(st, en, Gc)),
           "sharded coverage != oracle")

    kcfg = Config(distance_low=2 * L, distance_high=4 * L)
    krali = shard_align(mesh, genome, kcfg, reads).records
    krali = _subset_pairs(krali, krali.ratio_ok(THRESHOLD))
    g_ref = GraphTensors.create(genome)
    build_kmer_layer(g_ref, krali, reads, kcfg.k_mer, kcfg.insert_variation,
                     chunk_records=1 << 30)
    g_sh, _ = shard_kmer(mesh, GraphTensors.create(genome), krali, reads,
                         kcfg.k_mer, kcfg.insert_variation)
    for f in KM_CHECKED:
        _check(np.array_equal(getattr(g_ref, f), getattr(g_sh, f)),
               f"sharded k-mer build != oracle on {f}")
    return (f"dryrun({n} ranks on {mesh.device.type}, "
            f"{dist.get_backend(mesh.group)}): {res.total} pair records "
            f"(per rank {res.per_rank}); halo-window op ok; sharded "
            f"coverage == oracle; sharded k-mer graph build == oracle "
            f"({int(g_sh.km_cnt.sum())} slots over {n} position blocks)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aligngraph_tpu_torch.dryrun")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: the visible GPUs)")
    args = ap.parse_args(argv)
    have = torch.cuda.device_count()
    nproc = have if args.nproc is None else args.nproc
    if nproc < 1 or (args.device == "cuda" and nproc > have):
        print(f"cannot run {nproc} ranks on {args.device} ({have} CUDA "
              f"devices visible)", file=sys.stderr)
        return 1
    print(run_ranks(dryrun, nproc, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
