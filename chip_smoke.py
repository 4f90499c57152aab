"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises (non-zero exit):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit, the SM count and the maximum SM clock.
  2. build: compiles aligngraph_tpu_torch/csrc/*.cu with nvcc (sm_90a; one
     process a source, side by side, then one link) and the C++
     traversal, FASTA parser and chain DP with g++, all into
     aligngraph_tpu_torch/_build/.
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the same CUDA tensors, at the read aligner's shapes (L 100, pad 16,
     98,304 score lanes; 4,096 dp/traceback lanes; pad 8; ~30% indel
     lanes; rlen-0 lanes), at the contig aligner's tile (L 512, pad 16,
     2,048 lanes: indels up to 6 bases, diagonal offsets up to +-12,
     partial and length-0 tiles), and where the kernels take their other
     layouts: pad 5 (one score cell a lane, tb staged by byte copies), L
     4,000 (one staging buffer a warp) and L 8,000 (tb walked in global
     memory).  Every layout (cells per lane) of the score and dp kernels
     is checked at every shape; the score layouts are timed at L 100 and
     L 512 (SCORE_SWEEP), the dp layouts and the traceback at the lanes a
     launch carries on the paths and at full batches (DP_SWEEP).
     Then the contig aligner's chain DP kernel (monotone_chain_kernel)
     against monotone_chain_plain on 400 placements of 2-64 blocks, on
     placements of 1,024, 8,192, 8,193 and 50,000 blocks, on a batch
     built for ties and zero kept weight, and at the edges of its design
     (check_chain: m = B and B + 1, the cluster threshold and a
     cluster's int32 shared-memory capacity each - 1, itself and + 1,
     targets past 2^31, also a cluster's int64 capacity + 1, equal gains
     across block edges, the longest placement last), each with the
     launch plan it must take: best, parent, trim and keep equal; the
     whole call and the kernel alone timed.
     Everything is integer: tolerance 0.  CUDA-event times, kernel vs
     plain, and each kernel's bound (bytes or operations on these inputs)
     per shape.
  4. read aligner: ReadAligner.build(..., device="cuda").align on the
     benchmark workload (4.6 Mb genome, 100,000 pairs of 100 bp, insert
     500, 1% SNPs, seed 0, batch_pairs 32,768) through
     aligngraph_tpu_torch.bench.run: 3 timed runs after a warm-up, which
     must give the same records, and each kernel's device ms over one
     more align under torch.profiler; every kernel must have launched.
     Each path prints its launches and lanes per kernel and read length
     L.  Prints the last timed align's batches by transfer layout (dense,
     per-slot, overflowing), the bytes of the record blocks copied to the
     host, and its host seconds in the waits, the copies out and the
     concatenation (ReadAligner.split; the decode runs on the card).
  5. check: align on "cuda" and on "cpu" (the plain path), every
     PairAlignments field and the batches by layout equal: the first
     2,048 pairs in one batch; the first 4,096 in batches of 1,024
     (dense buffers decoded on the card, each batch's block of records
     read after its event), and again with distance_high 40,000
     (per-slot buffers); the tandem-repeat genome
     (workload.make_tandem_workload, 2,048 pairs in batches of 1,024) at
     distance 150-750 and 150-40,000, where a batch must overflow its
     buffer and be decoded on the card from its full layout.  In each
     layout the device decode runs once more under
     torch.cuda.set_sync_debug_mode("error"): it must make no host sync.
  6. pipeline small: tests/test_pipeline.py's sim (seed 42, 30 kb, 3,000
     pairs, 10 contigs) through the CLI (aligngraph_tpu_torch.__main__.main)
     on "cuda" and on "cpu", with --misassemblyRemoval and with --part 2
     --iterativeMap, and the same sim at 1,500 pairs with its genome cut
     into three chromosomes (4,000, 12,000 and ~14,000 bases) with
     --iterativeMap (three parts): the extended, remaining and corrected
     FASTA and every tmp/ stage file byte-equal, every kernel launched on
     "cuda" in the first and in the third; the CLI's k-mer build on the
     device on "cuda" and on the host on "cpu", so the bytes hold the two
     builds equal; Eval of the extended contigs on both devices equal.
  kmer: the device k-mer layer build on bench_pipeline.py's workload
     (seed 7, 4.6 Mb, depth 25 = 575,000 pairs of 100 bp, 1,424 draft
     contigs, distance 300-700, one part): the seed index built on "cuda"
     and on "cpu" at seed 13 and at seed 15, every field equal (the card's
     CUDA-event ms and peak device bytes); both aligners on "cuda" as the
     driver runs them (the contig aligner on the read aligner's device
     index, not copied); the contig seeding of every draft contig's
     chunks in both orientations on "cuda" and on "cpu" (offsets, qpos,
     tpos equal, and again on the card in batches of 2^16 seeds; seeds,
     hits, batches, device bytes reckoned and peak, the card's CUDA-event
     ms); the contig aligner's tile jobs on "cuda" and on "cpu"
     (ContigAligner.tile_jobs: every job's placement, tile start, length,
     g0, destination and source, every placement's chunk, orientation
     and length, and every DP batch's tiles and windows equal; both
     calls' ms and the card's host syncs by layer under
     torch.cuda.set_sync_debug_mode("warn")); the contig layer, then the
     first 4 chunks of
     16,384 accepted records through the host oracle (build_kmer_layer,
     numpy) and through build_kmer_layer_device on "cuda": every k-mer
     and edge array and every build statistic equal; both walls and the
     peak device memory.  Then the device build over all accepted
     records (stats equal to HOST_KMER_STATS), split by CUDA events
     (normalize = phase 0's duplicate skip, h2d = the state's upload,
     gather = each chunk's host gathers and upload, phase0 = its phase 0
     rows on the card, emit = emission and expansion, group, rounds,
     edges, d2h); phase 0 over all accepted records on "cuda" and on
     "cpu", the skip and every chunk's rows equal; and one chunk's wall,
     device busy time and top 10 CUDA ops under torch.profiler.
  multi: the multi-device paths (aligngraph_tpu_torch/parallel) in a
     world-size-1 NCCL group started in this process (file init under
     the temp dir, torn down at the end), on the objects of phases 4 and
     kmer: make_sharded_aligner over phase 4's aligner on its 100,000
     pairs equals phase 4's align in every FIELDS entry, every kernel
     launched, the per-rank record counts sum to the all_reduce'd
     total; make_sharded_coverage over both mates' spans of the 574,919
     accepted records (G = 4.6 Mb) equals span_coverage;
     sliding_window_sum_sharded of that coverage equals the plain
     windowed sum; build_kmer_layer_sharded(..., chunk_records=16,384)
     over the accepted records equals the kmer phase's full-size device
     build in all 13 arrays, with stats equal to HOST_KMER_STATS (the
     device build runs again after it, for walls in turns); then
     `python3 -m aligngraph_tpu_torch.dryrun --nproc 1` as a subprocess
     must exit 0.  Each wall beside nvidia-smi's name and power limit;
     the group's first collective (NCCL's communicator start) is timed
     on its own.  No fallback to gloo or the CPU.
  7. pipeline full: aligngraph_tpu_torch.bench_pipeline's run_pipeline
     on "cuda" (the device k-mer build, by the CLI's rule) on the same
     workload, then Eval of the extended contigs against the target on
     "cuda": per-stage seconds, launches and lanes per kernel, and
     bench_pipeline's JSON line.  The k-mer build statistics must equal
     the host build's on this workload (HOST_KMER_STATS) and Eval the JAX
     package's BENCH_PIPE.json (identity to 4 places); fails too if the
     native C++ traversal did not load.  Then the CLI (main, on "cuda")
     from the workload's reads written as r1.fa / r2.fa: the k-mer layer
     built on the device, extended.fa, remaining.fa and the tmp/ stage
     files byte-equal to run_pipeline's; the formalize and CLI walls.
  big: the big-genome run (aligngraph_tpu_torch.bigscale.run, the code
     path of python3 -m aligngraph_tpu_torch.bigscale) on "cuda" at 16 Mb,
     20x (1,600,000 pairs), --part 2, seed 11, graph_build="device",
     ratio_check=True, then Eval: walls per stage, peak device memory per
     stage, the k-mer state's bytes (reckoned and allocated), host RSS
     (peak, and per stage its RSS, live heap and named arrays' bytes);
     every kernel launched; every dropped_* 0, extended > 0, Eval MPMB
     0.0, true contigs >= 95% of extended, and the extended contigs, Eval
     and the k-mer stats equal to the recorded BIG_EVAL and
     BIG_KMER_STATS (identity to 4 places).  Then the
     read aligner on "cuda" against "cpu" on 2,048 pairs at the run's
     16 Mb index (every field equal), and part 2's device k-mer build (8
     Mb positions, part_offset 8 Mb; the graph after its contig layer and
     the records as run_pipeline hands them to the build) against the
     host oracle on the part's first 4 chunks of 16,384 accepted records:
     all 13 arrays and the stats equal.  (Eval's contig align by
     profile_contig's layers, eval_align_layers, is no longer run here:
     call it alone.)
  chroms: BASELINE.json config 2's layout, S. cerevisiae R64's 16
     chromosomes (12,071,326 bases, workload.YEAST_R64; the sequences from
     seed 288, workload.make_multichrom_workload), 20x (1,207,132 pairs of
     100 bp, insert 500, each chromosome's own), cut_contigs on each
     chromosome, as FASTA files; the CLI on "cuda" with --iterativeMap at
     --part 1 (16 parts: each part's reads and contigs aligned on its own
     index, the k-mer layer built on the device at 16 offsets), then Eval
     of extended.fa against the 16-record target: stage and formalize
     walls, each part's seconds and records, peak device and host memory,
     launches per kernel and L; 16 parts, the device build, every kernel
     launched at L 100 and L 512, every dropped_* 0, extended > 0, Eval
     MPMB 0.0, true contigs >= 95% of extended, and the extended contigs,
     Eval and the k-mer stats equal to the recorded CHROMS_EVAL and
     CHROMS_KMER_STATS; then chrXII's device k-mer build (a late part, a
     non-zero offset) against the host oracle on its first 4 chunks of
     16,384 records: all 13 arrays and the stats equal.
  masb: BASELINE.json config 3, misassembly removal: a genome of TAIR10
     Chr1's length (30,427,671 bases, NC_003070.9; seed 3702), 40x
     (6,085,534 pairs of 100 bp, insert 500), cut_contigs' drafts with 4%
     of them joined into 188 chimeras (draft + 300-600 random bases +
     a draft >= 1 Mb away, every second one reverse-complemented: QUAST's
     relocations and inversions; workload.make_misassembly_workload),
     after every earlier phase's objects are freed: run_pipeline on
     "cuda" with misassembly_removal=True, --part 1, the device k-mer
     build (reads in memory, the rest through FASTA as bigscale.run; its
     split by CUDA events, stats["kmer_split"], beside the split with
     phase 0 on the host, MASB_KMER_HOST_PHASE0),
     then Eval on "cuda", on one target index, of the drafts, of
     extended.fa + remaining.fa and of corrected_extended.fa +
     corrected_remaining.fa against the target, each with its aligner's
     seconds (evaluate's stats) and each contig align's seconds by layer
     (ContigAligner.layer_s: the alignment stage's contig thread, stage
     (5)'s two, each Eval's): every stage's seconds, the read
     thread's host seconds in waits, copies out and concatenation
     (aligner.split, in stats["alignment_threads"]), stage (5) by file
     (index, read align and its host split, coverage, contig index,
     contig align, loops,
     sweep/split; contigs in, kept whole, split, pieces out), peak device
     and host memory per stage, launches per kernel and L, the ": part"
     headers and what became of each chimera (split, kept whole, one
     piece, absent; relocations and inversions apart); the device build,
     every dropped_* 0, extended > 0, every kernel launched at L 100 and
     L 512, the drafts' MPMB > 0, the corrected output's below the
     drafts' and below the uncorrected output's, contigs split > 0, and
     the Evals, the k-mer stats and the splits equal to MASB_EVAL,
     MASB_KMER_STATS and MASB_SPLITS; the chain DP kernel launched in
     the run and in each Eval, and its largest launch there (the most
     (i, j) pairs) held against the plain version and timed (the
     kernel's figures in the JSON line).  Every seed index build of the
     run and of Eval's target, on "cuda": its caller, bases, k-mers and
     CUDA-event ms, and its peak device bytes above what was allocated
     before it (the build run again on the same codes after the Evals);
     stage (5)'s index over extended.fa's contigs (N separators) built
     again on "cpu", every field equal.  Then remove_misassembly on a
     500 kb instance (seed 3703, 100,000 pairs) on "cuda" and on "cpu":
     the same bytes, with ": part" headers.
The chain DP kernel must launch on the paths that align long contigs:
Eval at 4.6 Mb, phase big, and phase masb's run and Evals.
Then a JSON line of per-kernel results (launches: the main paths',
run_pipeline then Eval at 4.6 Mb, the CLI at 4.6 Mb, then phase big,
phase chroms' CLI and Eval, and phase masb's run_pipeline and Evals),
nvidia-smi's line, and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

L_MAIN = 100          # read length of the benchmark workload
PAD_MAIN = 16         # Config.band_pad
L_TILE = 512          # the contig aligner's TILE and TILE_PAD
PAD_TILE = 16
B_TILE = 2048         # its DP batch on CUDA
B_SCORE = 98_304      # DP lanes of one 32,768-pair batch (TOP = 3R/2)
B_DP = 4_096
FIELDS = ("pair_id", "fr", "score", "source_start", "source_end",
          "source_gap", "source_size", "target_start", "target_end",
          "target_gap", "pos_map")
SOURCE = "aligngraph_tpu_torch/csrc/banded_sw.cu"
REPLACES = {
    "score": "aligngraph_tpu/ops/banded_sw_pallas.py:161",
    "dp": "aligngraph_tpu/ops/banded_sw_pallas.py:46",
    "traceback": "aligngraph_tpu/ops/banded_sw_pallas.py:209",
}
KERNEL_NAMES = {"score": "sw_score_kernel", "dp": "sw_dp_kernel",
                "traceback": "sw_traceback_kernel"}
# the contig aligner's chain DP: no Pallas kernel computes it (the JAX
# package runs the loop on the host, at this line)
CHAIN = {"name": "monotone_chain_kernel", "route": "cuda",
         "source": "aligngraph_tpu_torch/csrc/monotone_chain.cu",
         "replaces": "aligngraph_tpu/align/contig_aligner.py:185"}
# the banded kernels every path launches; the paths that align long
# contigs launch the chain DP too (require_launched's `need`)
BANDED = tuple(KERNEL_NAMES)
WITH_CHAIN = BANDED + ("chain",)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def dp_lanes(rng, B, L, pad, indel_frac=0.3, G=1_000_000):
    """Read/window lanes as the aligner hands them to the DP: reads drawn
    from a random genome at g0 with 2% substitutions, 0.5% N, a 2-base
    deletion or insertion in `indel_frac` of the lanes, lengths L/2..L
    (every 17th lane 0), windows[c, x] = genome[g0 - pad + x] (4 outside).
    Returns numpy (reads, rlens, windows, g0)."""
    genome = rng.integers(0, 4, G).astype(np.int8)
    g0 = rng.integers(0, G - L - 4 * pad, B)
    j = np.arange(L)[None, :]
    kind = rng.random(B)[:, None]
    cut = rng.integers(5, L - 5, B)[:, None]
    src = g0[:, None] + j
    dele = kind < indel_frac / 2
    ins = (kind >= indel_frac / 2) & (kind < indel_frac)
    src = np.where(dele & (j >= cut), src + 2, src)
    src = np.where(ins & (j >= cut + 2), src - 2, src)
    reads = genome[src]
    in_ins = ins & (j >= cut) & (j < cut + 2)
    reads[in_ins] = rng.integers(0, 4, int(in_ins.sum()))
    snp = rng.random((B, L)) < 0.02
    reads[snp] = (reads[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    reads[rng.random((B, L)) < 0.005] = 4
    rlens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rlens[::17] = 0
    reads[j >= rlens[:, None]] = 4
    x = g0[:, None] - pad + np.arange(L + 2 * pad)[None, :]
    windows = np.where((x >= 0) & (x < G), genome[np.clip(x, 0, G - 1)],
                       np.int8(4)).astype(np.int8)
    return reads.astype(np.int8), rlens, windows, g0.astype(np.int32)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events,
    after one warm-up call).  The stream first sleeps ~10 ms, so the host
    queues the reps while it waits and the events time the device's work,
    not the host's launch cost."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (shapes must
    match)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# the card's figures behind bound_ms: INT32 lanes of a Hopper SM (NVIDIA's
# H100 white paper), device memory rate of the H100 SXM (data sheet); the
# SM count and the maximum SM clock are read from the card
INT32_LANES_PER_SM = 64
MEM_BYTES_PER_S = 3.35e12
# integer operations per band cell of the recurrence: substitution score,
# M, E, Hno, the in-row F, H and the running best
OPS_PER_CELL = 10
# integer operations per move of the traceback walk
OPS_PER_MOVE = 6


def card_figures(kind: str) -> dict:
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"kind": kind, "sms": sms, "max_sm_clock_mhz": float(clk),
            "int32_ops_per_s": sms * INT32_LANES_PER_SM * float(clk) * 1e6,
            "bytes_per_s": MEM_BYTES_PER_S}


def bound(card: dict, ops: float, nbytes: float) -> dict:
    """The least time the card could take for `ops` integer operations and
    `nbytes` bytes moved: the larger of the two times."""
    ops_ms = ops / card["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / card["bytes_per_s"] * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": nbytes}


def kernel_bounds(card, reads, rlens, W, best_i, pm) -> dict:
    """Each kernel's bound on these inputs (what this data needs).
      score: the rows up to each lane's rlen, W cells each, OPS_PER_CELL
             operations a cell; reads, windows and rlens read, the score
             written.
      dp: every row (its traceback bytes are an output), W cells each;
          reads, windows, rlens read, tb and three words written.
      traceback: the tb rows a walk can reach (best_i * W bytes a lane),
          best_i, best_b, g0 read, pos_map written; OPS_PER_MOVE a move
          (the diag moves, pm >= 0)."""
    B, L = reads.shape
    rows = int(rlens.clamp(0, L).sum())
    inputs = B * (L + (L + W) + 4)
    return {
        "score": bound(card, rows * W * OPS_PER_CELL, inputs + 4 * B),
        "dp": bound(card, B * L * W * OPS_PER_CELL,
                    inputs + B * L * W + 12 * B),
        "traceback": bound(card, int((pm >= 0).sum()) * OPS_PER_MOVE,
                           int(best_i.clamp(0, L).sum()) * W + 4 * B * L
                           + 12 * B),
    }


def kernel_results() -> dict:
    """The per-kernel entries of the JSON line, before any phase ran."""
    out = {n: {"name": KERNEL_NAMES[n], "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[n]} for n in BANDED}
    out["chain"] = dict(CHAIN)
    for r in out.values():
        # no PyTorch call computes a banded affine-gap local DP, its
        # traceback or the chain DP
        r.update(launches=0, max_abs_err=0, ms=None, plain_ms=None,
                 bound_ms=None, bound_by=None, library_ms=None,
                 launches_by_path={}, shapes={})
    return out


# lanes the score kernel's layouts are timed at, by shape
SCORE_SWEEP = {"L100 pad16": (2_048, 8_192, 32_768, B_SCORE),
               "L512 pad16": (B_TILE,)}
# lanes the dp kernel's layouts (and the traceback) are timed at: about
# the mean lanes of a launch on the read aligner's path (6,888 in 12
# launches, L 100: 576) and on the pipeline's (3,086 in 10, L 512: 320),
# and the full batches
DP_SWEEP = {"L100 pad16": (576, B_DP), "L512 pad16": (320, B_TILE)}


def check_kernels(results: dict, card: dict) -> None:
    """Each kernel against its plain version at every shape of the paths,
    and at the shapes that take the kernels' other layouts (a band width
    other than 16 and 32; one or no staging buffer in the traceback).
    CUDA-event times and bounds per shape go to results[name]["shapes"],
    and the read aligner's (L 100, pad 16) are also results[name]["ms"/
    "plain_ms"/"bound_ms"].  The score kernel's layouts (cells per lane)
    are each checked, and timed at L 100 and L 512, pad 16, on the lanes
    of SCORE_SWEEP."""
    from aligngraph_tpu_torch.ops import banded_sw as plain
    from aligngraph_tpu_torch.ops import banded_sw_cuda as k
    from aligngraph_tpu_torch.workload import tile_lanes

    rng = np.random.default_rng(0)
    # (label, lanes, pad, kernels timed here, score kernel only)
    cases = [
        ("L100 pad16", lambda: dp_lanes(rng, B_SCORE, L_MAIN, PAD_MAIN),
         PAD_MAIN, ("score",), True),
        ("L100 pad16", lambda: dp_lanes(rng, B_DP, L_MAIN, PAD_MAIN),
         PAD_MAIN, ("dp", "traceback"), False),
        ("L100 pad8", lambda: dp_lanes(rng, B_DP, L_MAIN, 8), 8, (), False),
        ("L100 pad5", lambda: dp_lanes(rng, 1024, L_MAIN, 5), 5, (), False),
        ("L512 pad16", lambda: tile_lanes(rng, B_TILE, L_TILE, PAD_TILE),
         PAD_TILE, ("score", "dp", "traceback"), False),
        ("L4000 pad16", lambda: dp_lanes(rng, 40, 4000, 16), 16, (), False),
        ("L8000 pad16", lambda: dp_lanes(rng, 12, 8000, 16), 16, (), False),
    ]
    cells_ms: dict = {}
    dp_cells_ms: dict = {}
    sweep: dict = {"dp": {}, "traceback": {}}
    for label, make, pad, timed, score_only in cases:
        reads, rlens, windows, g0 = (torch.from_numpy(a).cuda()
                                     for a in make())
        B, L = reads.shape
        W = 2 * pad
        ref = plain.banded_sw(reads, rlens, windows, pad)
        score = k.sw_score_cuda(reads, rlens, windows, pad)
        torch.cuda.synchronize()
        errs = {"score": max_err(score, ref.score)}
        # every layout the score kernel is built for at this band width,
        # timed on the first n lanes for each n of SCORE_SWEEP
        for cells in k.SCORE_CELLS.get(W, (1,)):
            s_c = k.sw_score_cuda(reads, rlens, windows, pad,
                                  cells_per_lane=cells)
            torch.cuda.synchronize()
            errs["score"] = max(errs["score"], max_err(s_c, ref.score))
            for n in (SCORE_SWEEP[label] if "score" in timed else ()):
                cells_ms.setdefault(f"{label} {n} lanes", {})[cells] = \
                    cuda_ms(lambda: k.sw_score_cuda(
                        reads[:n], rlens[:n], windows[:n], pad,
                        cells_per_lane=cells), 20)
        plain_dp = (lambda: plain.banded_sw(reads, rlens, windows, pad))
        fns = {"score": (lambda: k.sw_score_cuda(reads, rlens, windows,
                                                 pad), plain_dp)}
        msg = (f"{label}: lanes {B} (rlen 0: {int((rlens == 0).sum())}) "
               f"max_abs_err score {errs['score']}")
        pm_ref = None
        if not score_only:
            res = k.banded_sw_cuda(reads, rlens, windows, pad)
            torch.cuda.synchronize()
            errs["dp"] = max(max_err(res.score, ref.score),
                             max_err(res.best_i, ref.best_i),
                             max_err(res.best_b, ref.best_b),
                             max_err(res.tb, ref.tb))
            pm_ref = plain.sw_traceback(ref.tb, ref.best_i, ref.best_b, g0,
                                        pad)
            tb_k = res.tb.permute(1, 0, 2).contiguous()
            pm = k.sw_traceback_cuda(tb_k, res.best_i, res.best_b, g0, pad)
            s_all, pm_all = k.banded_sw_posmap_cuda(reads, rlens, windows,
                                                    g0, pad)
            torch.cuda.synchronize()
            err_tb = max(max_err(pm, pm_ref), max_err(s_all, ref.score),
                         max_err(pm_all, pm_ref))
            # the two-pass fast path against the plain composition
            smin = torch.full_like(rlens, 20)
            s_f, pm_f = k.banded_sw_posmap_fast(reads, rlens, windows, g0,
                                                pad, smin=smin)
            s_p, pm_p = plain.banded_sw_posmap_plain(reads, rlens, windows,
                                                     g0, pad, smin=smin)
            torch.cuda.synchronize()
            err_fast = max(max_err(s_f, s_p), max_err(pm_f, pm_p))
            errs["traceback"] = max(err_tb, err_fast)
            # every layout the dp kernel is built for at this band width
            dp_errs = {}
            for cells in k.DP_CELLS.get(W, (1,)):
                tb_c, s_c, bi_c, bb_c = k.sw_dp_cuda(reads, rlens, windows,
                                                     pad, cells_per_lane=cells)
                torch.cuda.synchronize()
                dp_errs[cells] = max(max_err(s_c, ref.score),
                                     max_err(bi_c, ref.best_i),
                                     max_err(bb_c, ref.best_b),
                                     max_err(tb_c.permute(1, 0, 2), ref.tb))
            errs["dp"] = max(errs["dp"], *dp_errs.values())
            fns["dp"] = (lambda: k.sw_dp_cuda(reads, rlens, windows, pad),
                         plain_dp)
            fns["traceback"] = (
                lambda: k.sw_traceback_cuda(tb_k, res.best_i, res.best_b,
                                            g0, pad),
                lambda: plain.sw_traceback(ref.tb, ref.best_i, ref.best_b,
                                           g0, pad))
            n_gapped = int((ref.score > plain.gapless_diag(
                reads, rlens, windows, pad)[0]).sum())
            msg += (f" dp {errs['dp']} (by cells per lane: {dp_errs}) "
                    f"traceback {err_tb} fast-path {err_fast} (gapped best "
                    f"{n_gapped}, longest walk "
                    f"{int((pm_ref >= 0).sum(dim=1).max())})")
            # dp at each layout and the traceback, on the first n lanes
            for n in (DP_SWEEP[label] if "dp" in timed else ()):
                key = f"{label} {n} lanes"
                nb = kernel_bounds(card, reads[:n], rlens[:n], W,
                                   ref.best_i[:n], pm_ref[:n])
                dp_cells_ms[key] = {
                    cells: cuda_ms(lambda: k.sw_dp_cuda(
                        reads[:n], rlens[:n], windows[:n], pad,
                        cells_per_lane=cells), 20)
                    for cells in k.DP_CELLS.get(W, (1,))}
                sweep["dp"][key] = {
                    "lanes": n, "ms": cuda_ms(lambda: k.sw_dp_cuda(
                        reads[:n], rlens[:n], windows[:n], pad), 20),
                    **nb["dp"]}
                sweep["traceback"][key] = {
                    "lanes": n, "ms": cuda_ms(lambda: k.sw_traceback_cuda(
                        tb_k[:n], res.best_i[:n], res.best_b[:n], g0[:n],
                        pad), 20),
                    **nb["traceback"]}
        for name, err in errs.items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
        if timed:
            bounds = kernel_bounds(card, reads, rlens, W, ref.best_i,
                                   pm_ref if pm_ref is not None
                                   else torch.empty(0))
        for name in timed:
            results[name]["shapes"][label] = {
                "lanes": B, "ms": cuda_ms(fns[name][0], 20),
                "plain_ms": cuda_ms(fns[name][1], 2), **bounds[name]}
        phase("kernels", msg)
    bad = {n: r["max_abs_err"] for n, r in results.items()
           if r["max_abs_err"] != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    for label, by_cells in cells_ms.items():
        phase("kernels", f"sw_score_kernel {label} by cells per lane: "
              + ", ".join(f"C {c}: {t:.4f} ms" for c, t in by_cells.items()))
    results["score"]["cells_ms"] = {
        label: {str(c): t for c, t in by_cells.items()}
        for label, by_cells in cells_ms.items()}
    for label, by_cells in dp_cells_ms.items():
        d, t = sweep["dp"][label], sweep["traceback"][label]
        phase("kernels", f"sw_dp_kernel {label} by cells per lane: "
              + ", ".join(f"C {c}: {ms:.4f} ms" for c, ms in by_cells.items())
              + f"; as launched {d['ms']:.4f} ms, bound {d['bound_ms']:.4f}"
              f" ms ({d['bound_by']}), {d['bound_ms'] / d['ms']:.3f} of it; "
              f"sw_traceback_kernel {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.3f} of it")
    results["dp"]["cells_ms"] = {
        label: {str(c): t for c, t in by_cells.items()}
        for label, by_cells in dp_cells_ms.items()}
    for name, by_label in sweep.items():
        results[name]["sweep"] = by_label
    for n in BANDED:
        r = results[n]
        main = r["shapes"]["L100 pad16"]
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            r[key] = main[key]
        for label, t in r["shapes"].items():
            phase("kernels", f"{KERNEL_NAMES[n]} {label} ({t['lanes']} "
                  f"lanes): {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} "
                  f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                  f"{t['ops']:.4g} ops, {t['bytes']:.4g} B), "
                  f"{t['bound_ms'] / t['ms']:.3f} of it")


# integer operations per (i, j) pair of the chain DP, counted at the
# card's int32 rate: the overlap, its clamp, the kept weight, its test, the
# gain, its select, the compare with the running best and the two selects
# of (gain, j).  The redesigned kernel does about six int32 operations a
# pair (csrc/monotone_chain.cu); nine stays the count, a floor, so that
# shares compare with the first kernel's.
CHAIN_OPS_PER_PAIR = 9
# the shape whose figures stand for the kernel in the JSON line: the
# largest launch of phase masb's main path
CHAIN_MAIN = "masb's largest launch"


def chain_blocks(rng, sizes, spread=None, back=0.1):
    """A CSR batch of M-blocks as finalize_placements hands them to the
    chain DP: per placement of m blocks, targets from a sorted draw over
    `spread` (40 m by default; a narrow one makes equal gains) plus
    noise, weights 1..59, and a `back` share overlapping the block before
    by up to 120 (kept weight <= 0 for some).  -> CUDA int64 (t0, t1, w,
    offsets)."""
    t0s, ws = [], []
    for m in sizes:
        t0 = (np.sort(rng.integers(0, spread or 40 * m, m))
              + rng.integers(0, 600, m))
        w = rng.integers(1, 60, m)
        b = np.flatnonzero(rng.random(m) < back)
        b = b[b > 0]
        t0[b] = np.maximum(t0[b - 1] + w[b - 1] - rng.integers(0, 120,
                                                               len(b)), 0)
        t0s.append(t0)
        ws.append(w)
    t0 = np.concatenate(t0s).astype(np.int64)
    w = np.concatenate(ws).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return tuple(torch.from_numpy(a).cuda() for a in (t0, t0 + w, w, off))


def equal_gain_blocks(m: int, parts: int = 2):
    """`parts` placements of m blocks all alike but for their targets,
    which repeat every 15 blocks (w 6, steps of 4): equal gains on both
    sides of every block edge of the kernel's DP.  -> CUDA int64 (t0, t1,
    w, offsets)."""
    t0 = np.tile(np.arange(0, 60, 4), -(-m * parts // 15))[:m * parts]
    w = np.full(m * parts, 6)
    off = np.arange(parts + 1) * m
    return tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                 for a in (t0, t0 + w, w, off))


def chain_bound(card, off) -> dict:
    """The chain DP's bound on a batch: sum m(m-1)/2 pairs of
    CHAIN_OPS_PER_PAIR operations; t0, t1, w and the offsets read,
    best, parent, trim and keep written (49 bytes a block)."""
    m = (off[1:] - off[:-1]).double()
    pairs = float((m * (m - 1) / 2).sum())
    n = int(off[-1])
    return bound(card, pairs * CHAIN_OPS_PER_PAIR,
                 49 * n + 8 * off.numel())


def time_chain(results: dict, card: dict, label: str, t0, t1, w, off,
               expect=None) -> None:
    """monotone_chain_kernel against monotone_chain_plain on one batch:
    best, parent, trim and keep equal (tolerance 0, integers).  The
    kernel's launch plan (chain_plan) is made first, and `expect` maps
    ChainPlan fields to the values it must have; "ms" is the whole call
    as the main path makes it (the plan and its copy to the host inside),
    "kernel_ms" the kernel alone on the plan made before (CUDA events
    both), "plain_ms" the plain version's (one run: each of its steps is
    several small launches); they and the bound go to
    results["chain"]["shapes"][label]."""
    from aligngraph_tpu_torch.ops import monotone_chain as mc

    r = results["chain"]
    plan = mc.chain_plan(t0, t1, w, off, mc.kernel_limits())
    got = mc.monotone_chain_cuda(t0, t1, w, off)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    want = mc.monotone_chain_plain(t0, t1, w, off)
    ev[1].record()
    torch.cuda.synchronize()
    err = max(max_err(g, e) for g, e in zip(got, want))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    reps = 3 if plan.max_m > 10_000 else 20
    paths = {k: getattr(plan, k) for k in ("n_cluster", "n_cta", "n_warp",
                                           "wide")}
    r["shapes"][label] = t = {
        "placements": off.numel() - 1, "blocks": int(off[-1]),
        "max_m": plan.max_m, **paths,
        "scratch": mc.needs_scratch(plan, mc.kernel_limits()),
        "ms": cuda_ms(lambda: mc.monotone_chain_cuda(t0, t1, w, off), reps),
        "kernel_ms": cuda_ms(lambda: mc._launch(t0, t1, w, off, plan), reps),
        "plain_ms": ev[0].elapsed_time(ev[1]), **chain_bound(card, off)}
    phase("kernels", f"{CHAIN['name']} {label}: {t['placements']} "
          f"placements, {t['blocks']} blocks (max m {t['max_m']}; "
          f"clusters / CTAs / warps {plan.n_cluster} / {plan.n_cta} / "
          f"{plan.n_warp}, {'int64' if plan.wide else 'int32'}"
          f"{', scratch rows' if t['scratch'] else ''}); max_abs_err {err} "
          f"(best, parent, trim, keep); {t['ms']:.4f} ms a call, "
          f"{t['kernel_ms']:.4f} ms the kernel alone, vs plain "
          f"{t['plain_ms']:.2f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of the call, "
          f"{t['bound_ms'] / t['kernel_ms']:.3f} of the kernel")
    if err != 0:
        raise AssertionError(f"{CHAIN['name']} disagrees with its plain "
                             f"version on {label}: {err}")
    bad = {k: (t[k], v) for k, v in (expect or {}).items() if t[k] != v}
    if bad:
        raise AssertionError(f"{CHAIN['name']} {label}: launch plan "
                             f"(got, expected) {bad}")


def check_chain(results: dict, card: dict) -> None:
    """time_chain on many small placements (m 2-64), on placements of
    1,024, 8,192, 8,193 and 50,000 blocks, on a batch built for ties and
    zero kept weight, and at the edges of the kernel's design, each with
    the path its plan must take: m = B and B + 1 (a warp, a CTA); the
    cluster threshold - 1, itself and + 1; a cluster's shared-memory
    capacity in int32 - 1, itself and + 1 (the last in the scratch rows,
    its parent walk in device memory); targets spread past 2^31 (the
    int64 instantiation), also at a cluster's int64 capacity + 1; equal
    gains on both sides of every block edge; and a CSR order with the
    longest placement last.  The kernel's sizes come from the library
    (ag_monotone_chain_limits) and must be the source's.  Phase masb adds
    the largest launch of its main path (CHAIN_MAIN), whose figures stand
    for the kernel."""
    from aligngraph_tpu_torch.ops import monotone_chain as mc

    lim = mc.kernel_limits()
    src = mc.source_limits()
    if {k: lim[k] for k in src} != src:
        raise AssertionError(f"chain kernel sizes: library {lim}, source "
                             f"{src}")
    B, thr = lim["rows"], lim["cluster_from"]
    cap32 = lim["cluster"] * lim["smem_rows32"]
    cap64 = lim["cluster"] * lim["smem_rows64"]
    phase("kernels", f"{CHAIN['name']} sizes: {lim}")
    rng = np.random.default_rng(14)
    cases = [
        ("many small", lambda: chain_blocks(
            rng, rng.integers(2, 65, 400)), None),
        ("m 1024", lambda: chain_blocks(rng, [1024] * 4), None),
        ("m 8192", lambda: chain_blocks(rng, [8192]), None),
        ("m 8193", lambda: chain_blocks(rng, [8193]), None),
        ("m 50000", lambda: chain_blocks(rng, [50_000]), None),
        ("ties, kept weight <= 0", lambda: chain_blocks(
            rng, rng.integers(2, 300, 60), spread=3, back=0.6), None),
        (f"m B {B} and B + 1", lambda: chain_blocks(rng, [B, B + 1]),
         {"n_cluster": 0, "n_cta": 1, "n_warp": 1}),
        (f"cluster threshold {thr} - 1, itself, + 1", lambda: chain_blocks(
            rng, [thr - 1, thr, thr + 1], back=0.3),
         {"n_cluster": 1, "n_cta": 2, "n_warp": 0}),
        (f"cluster int32 capacity {cap32} - 1, itself, + 1",
         lambda: chain_blocks(rng, [cap32 - 1, cap32, cap32 + 1]),
         {"n_cluster": 3, "wide": False, "scratch": True}),
        ("targets past 2^31 (int64)", lambda: chain_blocks(
            rng, [3000, thr + 50, 40, 7], spread=1 << 33, back=0.3),
         {"wide": True, "n_cluster": 1, "scratch": False}),
        (f"cluster int64 capacity {cap64} + 1", lambda: chain_blocks(
            rng, [cap64 + 1, 5], spread=1 << 33, back=0.3),
         {"wide": True, "n_cluster": 1, "scratch": True}),
        ("equal gains across block edges", lambda: equal_gain_blocks(
            thr + 33, 2), {"n_cluster": 2}),
        ("longest placement last", lambda: chain_blocks(
            rng, [2, 40, 5, 300, 33, 1500, thr + 100]),
         {"n_cluster": 1, "n_cta": 4, "n_warp": 2}),
    ]
    for label, make, expect in cases:
        time_chain(results, card, label, *make(), expect=expect)


@contextlib.contextmanager
def largest_chain_launch():
    """monotone_chain_cuda wrapped for the block: the inputs of its launch
    with the most (i, j) pairs are kept (copies on the card) in the dict
    it yields, under "args"."""
    from aligngraph_tpu_torch.ops import monotone_chain as mc

    run, kept = mc.monotone_chain_cuda, {}

    def keep(t0, t1, w, off, **kw):
        m = (off[1:] - off[:-1]).double()
        pairs = float((m * (m - 1) / 2).sum())
        if pairs > kept.get("pairs", -1.0):
            kept.update(pairs=pairs, args=tuple(
                x.clone() for x in (t0, t1, w, off)))
        return run(t0, t1, w, off, **kw)

    mc.monotone_chain_cuda = keep
    try:
        yield kept
    finally:
        mc.monotone_chain_cuda = run


def counted(fn):
    """fn() with every kernel count set to 0 just before it -> (fn's
    result, launches, lanes, by_L) read just after; by_L maps "kernel L"
    to {"launches", "lanes"} for the banded kernels, and launches and
    lanes (placements) of the chain DP are under "chain"."""
    from aligngraph_tpu_torch.ops import banded_sw_cuda as k
    from aligngraph_tpu_torch.ops import monotone_chain as mc

    k.reset_launches()
    mc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return (out, {**k.LAUNCHES, **mc.LAUNCHES}, {**k.LANES, **mc.LANES},
            k.launches_by_length())


def require_launched(path: str, launches: dict, by_l: dict,
                     results: dict, need=BANDED) -> None:
    """Records the path's launches in results and fails unless every
    kernel of `need` launched on it."""
    for n, r in results.items():
        r["launches_by_path"][path] = {
            "launches": launches.get(n, 0),
            **{key.split()[1]: v for key, v in by_l.items()
               if key.split()[0] == n}}
    phase("launches", f"{path}: " + "; ".join(
        f"{key}: {v['launches']} launches, {v['lanes']} lanes"
        for key, v in by_l.items())
        + f"; chain: {launches.get('chain', 0)} launches")
    missing = [n for n in need if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{missing} not launched on the {path} path: "
                             f"{launches}")


def cuda_equals_cpu(label: str, genome, index, cfg, reads,
                    batch: int) -> dict:
    """align on "cuda" and on "cpu" (the plain path), both over the seed
    index `index` (built on the card; the CPU aligner takes a copy) in
    batches of `batch` pairs: every FIELDS entry
    and the batches by transfer layout equal -> that count
    (ReadAligner.transfer)."""
    from aligngraph_tpu_torch import ReadAligner

    t0 = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        al = ReadAligner.from_index(genome, index, cfg, batch_pairs=batch,
                                    device=dev)
        out[dev] = al.align(reads), dict(al.transfer)
    (got, tr), (cpu, cpu_tr) = out["cuda"], out["cpu"]
    for f in FIELDS:
        a, b = getattr(got, f), getattr(cpu, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: cuda != cpu on field {f}")
    if tr != cpu_tr:
        raise AssertionError(f"{label}: transfer {tr} on cuda, {cpu_tr} "
                             f"on cpu")
    phase("check", f"{label}: cuda == cpu on {reads.n_pairs} pairs in "
          f"batches of {batch}, {got.n} records, every field; batches "
          f"{tr} ({time.perf_counter() - t0:.1f} s)")
    return tr


def decode_without_sync(label: str, genome, index, cfg, reads,
                        batch: int) -> None:
    """align on "cuda" with every step of the device decode (unpack_*,
    _expand_dense, _expand_packed, _expand_full, _row_table, _to_host)
    run under torch.cuda.set_sync_debug_mode("error"): a host sync in
    any of them raises."""
    from aligngraph_tpu_torch import ReadAligner
    from aligngraph_tpu_torch.align import read_aligner as ra

    names = ("unpack_dense", "unpack_records", "_expand_dense",
             "_expand_packed", "_expand_full", "_row_table", "_to_host")
    orig = {n: getattr(ra, n) for n in names}

    def strict(fn):
        def run(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    for n in names:
        setattr(ra, n, strict(orig[n]))
    try:
        al = ReadAligner.from_index(genome, index, cfg, batch_pairs=batch,
                                    device="cuda")
        res = al.align(reads)
    finally:
        for n, fn in orig.items():
            setattr(ra, n, fn)
    phase("check", f"{label}: no host sync in the device decode of "
          f"{reads.n_pairs} pairs in batches of {batch} ({res.n} records, "
          f"batches {al.transfer})")


def read_aligner_path(results: dict) -> dict:
    """Phases 4-5: the read aligner on the bench.py workload through
    aligngraph_tpu_torch.bench.run (3 timed aligns, which must give the
    same records; the kernels' counts are set to 0 just before them and
    read just after, inside run).  Returns the aligner, the reads, the
    records of the first timed align and the walls."""
    from aligngraph_tpu_torch import Reads
    from aligngraph_tpu_torch import bench

    n_pairs, batch = 100_000, 32_768
    rep, ctx = bench.run(n_pairs, 4_600_000, batch, repeats=3,
                         device="cuda")
    phase("reads", f"index build and upload {rep['index_s']:.2f} s; warm-up "
          f"{rep['warm_s']:.2f} s")
    require_launched("read_aligner", rep["launches"], rep["launches_by_l"],
                     results)
    res, walls, aligned = ctx["records"], rep["walls"], rep["aligned"]
    share = aligned / rep["total_reads"]
    phase("reads", f"bench.run: {json.dumps(rep['line'])}; walls "
          f"{[round(w, 4) for w in walls]} s (records equal in each); "
          f"median {rep['median']:.4f} s, min {rep['wall']:.4f} s; aligned "
          f"reads/s median {rep['rps_median']:.1f}, best "
          f"{aligned / rep['wall']:.1f}; aligned {aligned}/"
          f"{rep['total_reads']} ({share:.4f}); records {res.n}; launches "
          f"{rep['launches']}; lanes {rep['lanes']}")
    phase("reads", "kernel device ms over one more align (torch.profiler): "
          + "; ".join(f"{KERNEL_NAMES[n]} {k['device_ms']:.4f} ms in "
                      f"{k['events']} events, {k['launches']} launches"
                      for n, k in rep["kernel_ms"].items()))
    if not share > 0.9:
        raise AssertionError(f"aligned share {share:.4f} <= 0.9")
    if res.pos_map.shape != (res.n, 2, L_MAIN):
        raise AssertionError(f"pos_map shape {res.pos_map.shape}")

    tr = rep["transfer"]
    phase("reads", f"transfer of one align: {tr['dense']} dense, "
          f"{tr['per_slot']} per-slot, {tr['overflow']} overflowing "
          f"batches; {tr['host_bytes']} B of record blocks copied to the "
          f"host; host seconds (aligner.split) " + ", ".join(
              f"{k} {v:.4f}" for k, v in rep["split"].items()))
    if tr["dense"] + tr["per_slot"] + tr["overflow"] != -(-n_pairs // batch):
        raise AssertionError(f"batches by layout {tr}")

    # the CUDA path against the plain CPU path: one batch, then several
    # (each batch's buffer read from pinned memory after its event), in
    # each transfer layout, and batches that overflow their buffer
    from aligngraph_tpu_torch.ops.seeding import build_index
    from aligngraph_tpu_torch.workload import make_tandem_workload

    ref, cfg, data, lens = (ctx["ref"], ctx["cfg"], ctx["reads"].data,
                            ctx["reads"].lengths)
    index = build_index(ref, cfg.seed_len, device="cuda")
    wide = dataclasses.replace(cfg, distance_high=40_000)
    for label, n, b, c, layout in (
            ("dense, one batch", 2048, batch, cfg, "dense"),
            ("dense", 4096, 1024, cfg, "dense"),
            ("per-slot (distance_high 40,000)", 4096, 1024, wide,
             "per_slot")):
        sub = Reads(n, data.shape[1], data[:2 * n], lens[:n])
        got = cuda_equals_cpu(label, ref, index, c, sub, b)
        if got[layout] != -(-n // b):
            raise AssertionError(f"{label}: batches by layout {got}")
        decode_without_sync(label, ref, index, c, sub, b)
    tg, tdata, tlens = make_tandem_workload()
    tindex = build_index(tg, cfg.seed_len, device="cuda")
    treads = Reads(len(tlens), tdata.shape[1], tdata, tlens)
    for label, dhigh in (("tandem repeat, dense", 750),
                         ("tandem repeat, per-slot", 40_000)):
        c = dataclasses.replace(cfg, distance_low=150, distance_high=dhigh)
        got = cuda_equals_cpu(label, tg, tindex, c, treads, 1024)
        if got["overflow"] < 1:
            raise AssertionError(f"{label}: no batch overflowed: {got}")
        decode_without_sync(label, tg, tindex, c, treads, 1024)
    return dict(aligner=ctx["aligner"], reads=ctx["reads"], records=res,
                walls=walls)


@contextlib.contextmanager
def pipeline_results():
    """driver.run_pipeline wrapped for the block: each call's
    PipelineResult goes to the list it yields (the CLI looks run_pipeline
    up when it runs)."""
    from aligngraph_tpu_torch.pipeline import driver

    run, kept = driver.run_pipeline, []

    def keep(*args, **kw):
        kept.append(run(*args, **kw))
        return kept[-1]

    driver.run_pipeline = keep
    try:
        yield kept
    finally:
        driver.run_pipeline = run


def pipeline_files(out: Path) -> dict:
    """name -> bytes of the FASTA a pipeline run wrote in out (extended,
    remaining, corrected_*) and in out/tmp (the stage files)."""
    files = {}
    for d, prefix in ((out, ""), (out / "tmp", "tmp/")):
        for f in sorted(os.listdir(d)):
            if f.endswith(".fa"):
                files[prefix + f] = (d / f).read_bytes()
    return files


def write_sim(work: Path, n_pairs: int, chromosomes: bool) -> list:
    """tests/test_pipeline.py's sim (seed 42, 30 kb, 10 contigs) with
    n_pairs pairs as genome.fa, target.fa, contigs.fa, r1.fa and r2.fa in
    work, the genome and the target in one record or, with chromosomes,
    cut into three (workload.split_chromosomes) -> the CLI's input flags,
    distance 300-700."""
    from aligngraph_tpu_torch import decode, write_fasta
    from aligngraph_tpu_torch.workload import make_simdata, split_chromosomes

    target, reference, reads1, reads2, contigs = make_simdata(
        seed=42, genome_len=30_000, n_pairs=n_pairs, read_len=100,
        insert=500, n_contigs=10, snp_rate=0.01, err_rate=0.003)
    work.mkdir()
    for name, seq, one in (("genome.fa", reference, "refchr"),
                           ("target.fa", target, "chr")):
        parts = split_chromosomes(seq) if chromosomes else [seq]
        ids = ([f"chr{c}" for c in range(len(parts))] if chromosomes
               else [one])
        write_fasta(work / name, ids, [decode(c) for c in parts])
    write_fasta(work / "contigs.fa", [f"ctg{i}" for i in range(len(contigs))],
                [decode(c) for c in contigs])
    for mate, seqs in (("r1", reads1), ("r2", reads2)):
        write_fasta(work / f"{mate}.fa", [f"p{i}" for i in range(n_pairs)],
                    [decode(r) for r in seqs])
    return ["--read1", str(work / "r1.fa"), "--read2", str(work / "r2.fa"),
            "--contig", str(work / "contigs.fa"), "--genome",
            str(work / "genome.fa"), "--distanceLow", "300",
            "--distanceHigh", "700"]


def pipeline_small(results: dict, work: Path) -> None:
    """Phase 6: the CLI on cuda and on cpu, with --misassemblyRemoval and
    with --part 2 --iterativeMap on the one-record sim, and with
    --iterativeMap on the three-chromosome sim."""
    from aligngraph_tpu_torch import __main__ as cli
    from aligngraph_tpu_torch.evaluate.evaluate import evaluate

    work.mkdir()
    one = write_sim(work / "one", 3000, chromosomes=False)
    three = write_sim(work / "three", 1500, chromosomes=True)
    # (name, inputs, flags, files that must be among the outputs); the
    # first run is the path whose launches count, the second covers the
    # per-part aligners, the third one part a chromosome, each part's
    # reads and contigs aligned on its own, and every kernel must launch
    # in it too
    runs = [("misassembly", one, ["--misassemblyRemoval"],
             ("extended.fa", "remaining.fa", "corrected_extended.fa",
              "corrected_remaining.fa", "tmp/_initial_contigs.0.fa",
              "tmp/_pre_extended_contigs.0.fa",
              "tmp/_extended_contigs.0.fa")),
            ("part2_iterative", one, ["--part", "2", "--iterativeMap"],
             ("extended.fa", "remaining.fa", "tmp/_initial_contigs.1.fa",
              "tmp/_pre_extended_contigs.1.fa",
              "tmp/_extended_contigs.1.fa")),
            ("chromosomes_iterative", three, ["--iterativeMap"],
             ("extended.fa", "remaining.fa", "tmp/_initial_contigs.2.fa",
              "tmp/_pre_extended_contigs.2.fa",
              "tmp/_extended_contigs.2.fa"))]
    cwd = os.getcwd()
    for name, base, flags, want in runs:
        files, evals = {}, {}
        target = Path(base[base.index("--genome") + 1]).parent / "target.fa"
        for dev in ("cuda", "cpu"):
            out = work / f"{name}_{dev}"
            out.mkdir()
            argv = base + ["--extendedContig", str(out / "extended.fa"),
                           "--remainingContig", str(out / "remaining.fa")]
            os.chdir(out)                   # the CLI's work dir is ./tmp
            t0 = time.perf_counter()
            try:
                with pipeline_results() as kept:
                    rc, launches, lanes, by_l = counted(
                        lambda: cli.main(argv + flags, device=dev))
            finally:
                os.chdir(cwd)
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"CLI {name} on {dev} exited {rc}")
            # the CLI builds the k-mer layer on the card, on the host on
            # the CPU: cuda == cpu below holds the two builds equal too
            build = kept[0].stats["graph_build"]
            if build != {"cuda": "device", "cpu": "host"}[dev]:
                raise AssertionError(f"CLI {name} on {dev}: k-mer build "
                                     f"{build}")
            if dev == "cuda" and name == "misassembly":
                require_launched("pipeline_small", launches, by_l,
                                 results)
            if dev == "cuda" and name == "chromosomes_iterative":
                require_launched("pipeline_small_chromosomes", launches,
                                 by_l, results)
                if kept[0].stats["n_parts"] != 3:
                    raise AssertionError(f"{name}: {kept[0].stats['n_parts']}"
                                         f" parts")
            files[dev] = pipeline_files(out)
            evals[dev] = evaluate(target, out / "extended.fa", device=dev)
            phase("small", f"{name} {dev}: k-mer build {build}, CLI wall "
                  f"{wall:.2f} s, launches "
                  f"{launches}, lanes {lanes}; Eval {evals[dev]}")
        if sorted(files["cuda"]) != sorted(files["cpu"]) or \
                not set(want) <= set(files["cuda"]):
            raise AssertionError(f"{name}: pipeline files differ: "
                                 f"{sorted(files['cuda'])} vs "
                                 f"{sorted(files['cpu'])}")
        diff = [f for f in files["cpu"]
                if files["cuda"][f] != files["cpu"][f]]
        if diff:
            raise AssertionError(f"{name}: cuda != cpu in {diff}")
        if evals["cuda"] != evals["cpu"] or not evals["cuda"]["n_contigs"]:
            raise AssertionError(f"{name}: Eval cuda {evals['cuda']} != cpu "
                                 f"{evals['cpu']}")
        phase("small", f"{name}: cuda == cpu, byte for byte: "
              f"{sorted(files['cuda'])}; Eval equal")


# the JAX package's figures on the same workload (BENCH_PIPE.json)
BENCH_PIPE_EVAL = {"extended": 49, "n_true_contigs": 49, "n50": 137_621,
                   "covered_length": 4_575_555, "average_identity": 0.9993,
                   "mpmb": 0.0}
# the host k-mer build's statistics on the same workload at the default
# chunk of 16,384 records (BENCH_PIPE.json; the port's host build gave the
# same on the card)
HOST_KMER_STATS = {"tuples": 54_559_637, "rows": 109_132_827,
                  "groups": 55_053_799, "dropped_rank": 0,
                  "dropped_slots": 0, "dropped_edges": 0}
KM_FIELDS = ("km_cnt", "km_contig", "km_coff", "km_contig0", "km_coff0",
             "km_mate", "km_cov", "km_votes", "km_s", "km_slen", "ed_cnt",
             "ed_pos", "ed_item")
KMER_CHUNK = 16_384
# the device k-mer build's marks (build_kmer_layer_device's `mark`)
KMER_STAGES = {"normalize", "h2d", "gather", "phase0", "emit", "group",
               "rounds", "edges", "d2h"}
# phase kmer holds the card's contig seeding to the CPU's again in
# batches of this many seeds (the 4.6 Mb drafts' ~534 k seeds take 9)
SMALL_SEED_BUDGET = 1 << 16
KMER_CHUNKS = 4


def full_workload(work: Path, **size) -> dict:
    """bench_pipeline.py's workload as aligngraph_tpu_torch.bench_pipeline
    prepares it (FASTA files in work, its config, the reads), with the
    contigs and the genome formalized for the kmer and multi phases
    (size: prepare's genome_len and depth, for a smaller copy)."""
    from aligngraph_tpu_torch import bench_pipeline
    from aligngraph_tpu_torch import formalize_contigs, formalize_genome

    t0 = time.perf_counter()
    wl = bench_pipeline.prepare(work, **size)
    wl.update(contigs=formalize_contigs(wl["cfg"].contig),
              genome=formalize_genome(wl["cfg"].genome, 1))
    phase("full", f"workload: genome {wl['genome'].total_len}, "
          f"{wl['reads'].n_pairs} pairs, {wl['n_draft_contigs']} draft "
          f"contigs ({time.perf_counter() - t0:.1f} s)")
    return wl


def seeding_cuda_vs_cpu(ra, gseq, cfg, contigs, index) -> None:
    """Phase kmer: the contig aligner's seeding of every draft contig's
    chunks, both orientations, on the card (ContigAligner.seed_hits on
    the read aligner's device index, which it must take without a copy)
    and on the CPU (`index`, the CPU's build): offsets, qpos and tpos equal,
    dtype and all; then the card's again in batches of SMALL_SEED_BUDGET
    seeds (segments straddling batches, the offsets summed over them),
    equal too.  Prints the seeds, hits and batches, the largest batch's
    device bytes (reckoned, and the peak allocated during the call above
    what was allocated before it), the card's call in CUDA-event ms (a
    warm call before it; profile_contig.measure_seeding) and the CPU's
    wall."""
    from aligngraph_tpu_torch import profile_contig
    from aligngraph_tpu_torch.align.contig_aligner import (ContigAligner,
                                                           query_segments)
    from aligngraph_tpu_torch.ops import seeding

    segs = query_segments(contigs)
    ca = ContigAligner(gseq, cfg, index=ra.index, device="cuda")
    if any(getattr(ca.index, f) is not getattr(ra.index, f)
           for f in ("sorted_kmers", "sorted_posflip", "bucket_lo")):
        raise AssertionError("the contig aligner copied the device index")
    ca.seed_hits(segs)
    got, st = profile_contig.measure_seeding(ca, segs, ca.device)
    t0 = time.perf_counter()
    want = ContigAligner(gseq, cfg, index=index, device="cpu").seed_hits(segs)
    cpu_s = time.perf_counter() - t0
    budget = seeding.CONTIG_SEED_BUDGET
    seeding.CONTIG_SEED_BUDGET = SMALL_SEED_BUDGET
    try:
        small = ca.seed_hits(segs)
    finally:
        seeding.CONTIG_SEED_BUDGET = budget
    n_small = ca.seeding["batches"]
    bad = [f"{n}{tag}" for tag, hits in (("", got), (" (small)", small))
           for n, a, b in zip(("offsets", "qpos", "tpos"), hits, want)
           if a.dtype != b.dtype or not np.array_equal(a, b)]
    if bad or not st["hits"] or n_small < 2:
        raise AssertionError(f"kmer: the card's seeding != the CPU's in "
                             f"{bad} ({st}; {n_small} small batches)")
    phase("kmer", f"contig seeding: {contigs.n_chunks} chunks of "
          f"{len(contigs.seqs)} draft contigs, both orientations: "
          f"{st['seeds']} seeds, {st['hits']} hits, {st['batches']} "
          f"batch(es); device bytes reckoned {st['batch_bytes']}, peak "
          f"allocated {st['device_peak_bytes']}; cuda "
          f"{st['device_ms']:.3f} ms (CUDA events), cpu {cpu_s * 1e3:.1f} "
          f"ms; offsets, qpos and tpos equal, and equal again on the card "
          f"in {n_small} batches of {SMALL_SEED_BUDGET} seeds")


# the card's host syncs that the tile-job build's own lines may make, by
# layer (under torch.cuda.set_sync_debug_mode("warn")): cluster, the kept
# clusters' count and their copy down; tile_diags, the placements' upload
# and the job count; a DP batch's gathers, none.  A sync raised from
# torch's own Python (once a process, seen at torch's __init__.py) is
# listed apart
JOB_SYNCS = {"cluster": 2, "chain": 0, "tile_diags": 2, "batches": 0}


def contig_jobs_cuda_vs_cpu(ra, gseq, cfg, contigs, index) -> None:
    """Phase kmer: the contig aligner's tile jobs of every draft contig
    (ContigAligner.tile_jobs, no DP) on the card, on the read aligner's
    device index, and on the CPU (`index`, the CPU's build): every
    placement's chunk, orientation and length, every job's pid, ts,
    tlen, g0, dst and src, and every DP batch's tiles, lengths, windows,
    g0 and destinations (B_TILE lanes) equal.  Prints both calls' ms
    (the card's synchronised) and the card's host syncs by layer,
    counted under torch.cuda.set_sync_debug_mode("warn") in a third
    call, which must stay within JOB_SYNCS at the port's own lines."""
    import warnings

    from aligngraph_tpu_torch.align import contig_aligner as cal

    ca = cal.ContigAligner(gseq, cfg, index=ra.index, device="cuda")
    ca.tile_jobs(contigs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ca.tile_jobs(contigs)
    torch.cuda.synchronize()
    cuda_ms = (time.perf_counter() - t0) * 1e3
    layers = {k: round(v * 1e3, 3) for k, v in ca.layer_s.items()
              if v}
    t0 = time.perf_counter()
    want = cal.ContigAligner(gseq, cfg, index=index,
                             device="cpu").tile_jobs(contigs)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    bad = [f for f in ("chunk_id", "fr", "length")
           if getattr(got, f).dtype != getattr(want, f).dtype
           or not np.array_equal(getattr(got, f), getattr(want, f))]
    bad += [f for f in ("pid", "ts", "tlen", "g0", "dst", "src")
            if getattr(got, f).dtype != getattr(want, f).dtype
            or not torch.equal(getattr(got, f).cpu(), getattr(want, f))]
    for s in range(0, want.n, B_TILE):
        bad += [f"{name} of batch {s}" for name, a, b in zip(
            ("tiles", "tlens", "windows", "g0s", "dst"),
            got.batch(s, B_TILE), want.batch(s, B_TILE))
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    if bad or not want.n:
        raise AssertionError(f"kmer: the card's tile jobs != the CPU's in "
                             f"{bad} ({got.n} and {want.n} jobs)")
    # the card's host syncs by layer, and the lines that made them: the
    # module's functions wrapped
    syncs = dict.fromkeys(JOB_SYNCS, 0)
    sites, other = collections.Counter(), collections.Counter()
    orig = {n: getattr(cal, n) for n in ("cluster_hits", "chain_clusters",
                                         "build_tile_jobs")}

    def counting(fn, layer):
        def run(*args, **kw):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    for w in seen:
                        if "synchroniz" not in str(w.message):
                            continue
                        at = f"{Path(w.filename).name}:{w.lineno}"
                        if "aligngraph_tpu_torch" in w.filename:
                            syncs[layer] += 1
                            sites[at] += 1
                        else:
                            other[f"{layer} {w.filename}:{w.lineno}"] += 1
        return run

    for name, layer in (("cluster_hits", "cluster"),
                        ("chain_clusters", "chain"),
                        ("build_tile_jobs", "tile_diags")):
        setattr(cal, name, counting(orig[name], layer))
    try:
        jobs = ca.tile_jobs(contigs)
    finally:
        for name, fn in orig.items():
            setattr(cal, name, fn)
    batch = counting(jobs.batch, "batches")
    for s in range(0, jobs.n, B_TILE):
        batch(s, B_TILE)
    over = {k: v for k, v in syncs.items() if v > JOB_SYNCS[k]}
    if over:
        raise AssertionError(f"kmer: the card's tile-job build made host "
                             f"syncs {syncs}, more than {JOB_SYNCS}, at "
                             f"{dict(sites)}; elsewhere {dict(other)}")
    phase("kmer", f"contig tile jobs: {len(want.length)} placements, "
          f"{want.n} jobs ({-(-want.n // B_TILE)} batches of {B_TILE}): "
          f"cuda {cuda_ms:.1f} ms (by layer, host clock: {layers}), cpu "
          f"{cpu_ms:.1f} ms; every job, placement, tile and window equal; "
          f"the card's host syncs by layer {syncs}, at {dict(sites)}; "
          f"in torch's own Python {dict(other)}")


def eval_align_layers(genome_path, contigs_path) -> str:
    """Eval's contig align by layer, apart from any pinned Eval, which
    runs unwrapped.  No phase calls it (it took ~59 s after phase big's
    Eval at 32 Mb); run it alone on a run's FASTA files: python3 -c
    "import chip_smoke as cs; print(cs.eval_align_layers('target.fa',
    'extended.fa'))".  Eval's query set (evaluate.eval_queries)
    and target (its records end to end), Eval's aligner on "cuda" (its
    seed index build timed) and one profile_contig.layer_align, each
    layer timed, the device synchronised around the seeding and the tile
    DP.  Its launches are no path's.  Returns the split as one line."""
    from aligngraph_tpu_torch import Config, profile_contig
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
    from aligngraph_tpu_torch.evaluate.evaluate import eval_queries
    from aligngraph_tpu_torch.io.fasta import encode, read_fasta

    t0 = time.perf_counter()
    gcat = np.concatenate([encode(s) for s in read_fasta(genome_path)[1]])
    q = eval_queries(read_fasta(contigs_path)[1])
    t1 = time.perf_counter()
    ca = ContigAligner(gcat, Config(), accept=(0.0, 0.0, 0), device="cuda")
    t2 = time.perf_counter()
    res, wall, layers, fin = profile_contig.layer_align(ca, q, ca.device)
    return (f"Eval's align by layer (eval_align_layers, after the pinned "
            f"Eval): {q.n_chunks} chunks, {res.n} placements; FASTA and "
            f"encoding {t1 - t0:.3f} s, index {t2 - t1:.3f} s, align "
            f"{wall:.3f} s (" + ", ".join(f"{k} {v:.3f}"
                                          for k, v in layers.items())
            + "; _finalize by step " + ", ".join(
                f"{k} {v:.3f}" for k, v in fin["split"].items())
            + f"; counts {fin['counts']})")


INDEX_FIELDS = ("sorted_kmers", "sorted_posflip", "bucket_lo",
                "search_steps", "suffix_bits", "seed_len", "genome_len")


def timed_build(codes, seed_len: int) -> tuple:
    """build_index on "cuda" -> (index, CUDA-event ms, the peak device
    bytes above what was allocated before it)."""
    from aligngraph_tpu_torch.ops.seeding import build_index

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    index = build_index(codes, seed_len, device="cuda")
    b.record()
    torch.cuda.synchronize()
    return (index, a.elapsed_time(b),
            torch.cuda.max_memory_allocated() - base)


def index_cuda_vs_cpu(name: str, label: str, codes, seed_len: int):
    """The seed index of `codes` built on "cuda" and on "cpu", every
    field equal -> (the card's index, the CPU's).  Prints the card's
    CUDA-event ms and peak device bytes and the CPU's wall."""
    from aligngraph_tpu_torch.ops.seeding import build_index

    got, ms, peak = timed_build(codes, seed_len)
    t0 = time.perf_counter()
    want = build_index(codes, seed_len, device="cpu")
    cpu_s = time.perf_counter() - t0
    bad = [f for f in INDEX_FIELDS
           if not (torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   if f in INDEX_FIELDS[:3]
                   else getattr(got, f) == getattr(want, f))]
    if bad or got.sorted_kmers.device.type != "cuda":
        raise AssertionError(f"{name}: {label}: the card's seed index != "
                             f"the CPU's in {bad}")
    n = len(codes)
    phase(name, f"{label}: seed index cuda == cpu, every field ({n} bases, "
          f"{got.sorted_kmers.shape[0]} k-mers, suffix_bits "
          f"{got.suffix_bits}, search_steps {got.search_steps}); cuda "
          f"{ms:.2f} ms (CUDA events), peak {peak} B above what was "
          f"allocated ({peak / max(n, 1):.1f} B a base; index "
          f"{got.nbytes} B); cpu {cpu_s:.2f} s")
    return got, want


@contextlib.contextmanager
def index_builds():
    """Every build_index call in the block, wherever the pipeline, its
    aligners or Eval make one (the name is wrapped in each module that
    calls it): the caller's module, bases, k-mers, device and CUDA-event
    ms go to the list the block gets, with the codes (`codes`) for
    peak_of_builds."""
    from aligngraph_tpu_torch.align import contig_aligner, read_aligner
    from aligngraph_tpu_torch.evaluate import evaluate
    from aligngraph_tpu_torch.ops import seeding
    from aligngraph_tpu_torch.pipeline import driver, misassembly

    mods = (driver, misassembly, contig_aligner, read_aligner, evaluate)
    builds = []

    def wrap(mod):
        def build(codes, seed_len, *, device):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            index = seeding.build_index(codes, seed_len, device=device)
            b.record()
            torch.cuda.synchronize()
            builds.append(dict(
                caller=mod.__name__.rsplit(".", 1)[1], bases=len(codes),
                kmers=index.sorted_kmers.shape[0],
                device=index.sorted_kmers.device.type,
                ms=round(a.elapsed_time(b), 2), codes=codes,
                seed_len=seed_len))
            return index
        return build

    for m in mods:
        m.build_index = wrap(m)
    try:
        yield builds
    finally:
        for m in mods:
            m.build_index = seeding.build_index


def peak_of_builds(builds: list) -> list:
    """Each recorded build run again on its codes on "cuda": its peak
    device bytes above what was allocated before it (the same codes give
    the same allocations) -> the records without their codes."""
    out = []
    for b in builds:
        b = dict(b)
        _, _, b["peak_bytes"] = timed_build(b.pop("codes"), b["seed_len"])
        b["peak_b_a_base"] = round(b["peak_bytes"] / max(b["bases"], 1), 1)
        out.append(b)
    return out


def phase0_cuda_vs_cpu(every, reads, k: int, part_len) -> str:
    """Phase 0 of the device k-mer build over every record of `every` on
    "cuda" and on "cpu": the duplicate-placement skip, then for each
    chunk of KMER_CHUNK records (p1, p2, s1, lens, keep) from its host
    gathers, each tensor's dtype and values equal (tolerance 0)."""
    from aligngraph_tpu_torch.graph import kmer_layer_jit as kj

    rows, devs = np.arange(every.n), ("cuda", "cpu")
    t0 = time.perf_counter()
    skip = {d: kj.phase0_skip(every, rows, 0, part_len, device=d)
            for d in devs}
    if not torch.equal(skip["cuda"].cpu(), skip["cpu"]):
        raise AssertionError("phase 0's skip on cuda != cpu")
    bad, n = [], 0
    for s in range(0, every.n, KMER_CHUNK):
        e = min(s + KMER_CHUNK, every.n)
        out = {d: kj.phase0_rows(
            *kj.phase0_gather(every, rows, reads, s, e, device=d),
            skip[d][s:e], k, 0, part_len) for d in devs}
        for name, a, b in zip(("p1", "p2", "s1", "lens", "keep"),
                              out["cuda"], out["cpu"]):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                bad.append((s, name))
        n += 1
    if bad:
        raise AssertionError(f"phase 0 rows on cuda != cpu at (chunk "
                             f"start, tensor) {bad[:10]}")
    return (f"phase 0 over all {every.n} records on cuda == cpu: the skip "
            f"({int((~skip['cpu']).sum())} dropped) and the rows of all "
            f"{n} chunks, tolerance 0 ({time.perf_counter() - t0:.1f} s)")


def kmer_build(wl: dict) -> dict:
    """Phase kmer: the device k-mer build against the host oracle on the
    first 4 chunks of the full workload's accepted records.  Returns the
    graph with the contig layer (g0), all accepted records (every), the
    device build over them (g_split) and its wall."""
    import copy
    import dataclasses

    from aligngraph_tpu_torch import (THRESHOLD, GraphTensors, ReadAligner,
                                      build_contig_layer, build_kmer_layer)
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
    from aligngraph_tpu_torch.graph import kmer_layer_jit as kj

    cfg, reads, genome = wl["cfg"], wl["reads"], wl["genome"]
    k, iv = cfg.k_mer, cfg.insert_variation
    gseq = np.asarray(genome.seq, np.int8)
    index_cuda_vs_cpu("kmer", "genome, seed 15", gseq, 15)
    dev_index, index = index_cuda_vs_cpu("kmer", "genome, seed 13", gseq,
                                         cfg.seed_len)
    t0 = time.perf_counter()
    ra = ReadAligner.from_index(gseq, dev_index, cfg, device="cuda")
    rali = ra.align(reads)
    # the driver's hand-off: the contig aligner seeds on the read
    # aligner's device index
    cali = ContigAligner(gseq, cfg, index=ra.index,
                         device="cuda").align(wl["contigs"])
    seeding_cuda_vs_cpu(ra, gseq, cfg, wl["contigs"], index)
    contig_jobs_cuda_vs_cpu(ra, gseq, cfg, wl["contigs"], index)
    del ra, index, dev_index
    # the driver's C13 filter; one part, so every record is in it
    ok = np.nonzero(rali.ratio_ok(THRESHOLD))[0][:KMER_CHUNKS * KMER_CHUNK]
    recs = dataclasses.replace(rali, **{
        f.name: getattr(rali, f.name)[ok] for f in dataclasses.fields(rali)})
    g0 = GraphTensors.create(genome.part_seq(0))
    build_contig_layer(g0, wl["contigs"], cali)
    phase("kmer", f"aligned {reads.n_pairs} pairs and {cali.n} contig "
          f"placements on cuda, contig layer built "
          f"({time.perf_counter() - t0:.1f} s); {recs.n} records = "
          f"{KMER_CHUNKS} chunks of {KMER_CHUNK}; {g0.km_cnt.shape[0]} "
          f"positions")

    g_host = copy.deepcopy(g0)
    t0 = time.perf_counter()
    st_host = build_kmer_layer(g_host, recs, reads, k, iv,
                               chunk_records=KMER_CHUNK)
    host_s = time.perf_counter() - t0
    g_dev = copy.deepcopy(g0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st_dev = kj.build_kmer_layer_device(g_dev, recs, reads, k, iv,
                                        chunk_records=KMER_CHUNK,
                                        device="cuda")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [f for f in KM_FIELDS
           if getattr(g_dev, f).dtype != getattr(g_host, f).dtype
           or not np.array_equal(getattr(g_dev, f), getattr(g_host, f))]
    if bad or dataclasses.asdict(st_dev) != dataclasses.asdict(st_host):
        raise AssertionError(f"device k-mer build != host oracle: fields "
                             f"{bad}, stats {st_dev} vs {st_host}")
    state_bytes = sum(getattr(g0, f).shape[0] * 4 * int(np.prod(
        getattr(g0, f).shape[1:])) for f in KM_FIELDS)
    if peak < state_bytes:
        raise AssertionError(f"peak device memory {peak} B < the state's "
                             f"{state_bytes} B: the build did not run on "
                             f"the card")
    phase("kmer", f"host oracle {host_s:.3f} s, device {dev_s:.3f} s "
          f"({host_s / dev_s:.1f}x); all {len(KM_FIELDS)} fields and the "
          f"stats equal: {dataclasses.asdict(st_dev)}; peak device memory "
          f"{peak / 2**30:.2f} GiB (state {state_bytes / 2**30:.2f} GiB)")

    # the device build's time split over all accepted records (the full
    # size of the pipeline's stage): CUDA events at each stage's ends
    acc = np.nonzero(rali.ratio_ok(THRESHOLD))[0]
    every = dataclasses.replace(rali, **{
        f.name: getattr(rali, f.name)[acc] for f in dataclasses.fields(rali)})
    g_split = copy.deepcopy(g0)
    split: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = kj.build_kmer_layer_device(g_split, every, reads, k, iv,
                                    chunk_records=KMER_CHUNK, device="cuda",
                                    split=split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dataclasses.asdict(st) != HOST_KMER_STATS:
        raise AssertionError(f"full-size device build stats {st} != "
                             f"{HOST_KMER_STATS}")
    phase("kmer", f"all {every.n} records ({-(-every.n // KMER_CHUNK)} "
          f"chunks): wall {wall:.3f} s; split, CUDA-event ms (normalize is "
          f"phase 0's duplicate skip, h2d the state's upload, gather each "
          f"chunk's host gathers and upload, phase0 its rows on the card): "
          + ", ".join(f"{n} {t:.2f}" for n, t in split.items()))
    phase("kmer", phase0_cuda_vs_cpu(every, reads, k, g0.part_len))

    # one chunk's update: its wall, then torch.profiler's device time
    rows = np.arange(recs.n)
    skip = kj.phase0_skip(recs, rows, 0, g0.part_len, device="cuda")
    cmpack = kj._cmpack(g0, "cuda")
    args = kj.phase0_rows(
        *kj.phase0_gather(recs, rows, reads, 0, KMER_CHUNK, device="cuda"),
        skip[:KMER_CHUNK], k, 0, g0.part_len)
    win = 2 * iv + 5 * kj.EP
    n_pos = int(g0.km_cnt.shape[0])

    def one_chunk(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kj._chunk_update(state, cmpack, *args, k=k, win=win, n_pos=n_pos)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # a fresh copy of the state each time, made outside the timed region
    chunk_s = one_chunk(kj._state_from_graph(g0, "cuda"))
    state = kj._state_from_graph(g0, "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_s = one_chunk(state)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own entries (kernels, copies, fills): the host ops
    # that launched them carry the same time again
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in ops) / 1e6
    phase("kmer", f"one chunk ({KMER_CHUNK} records): wall {chunk_s:.4f} s "
          f"({prof_s:.4f} s under the profiler); device busy {busy:.4f} s "
          f"in {sum(e.count for e in ops)} device ops, idle share "
          f"{1 - busy / chunk_s:.3f} of the unprofiled wall; top 10 by "
          f"device time:")
    for e in ops[:10]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}",
              flush=True)
    return dict(g0=g0, every=every, g_split=g_split, wall=wall)


WINDOW = 5            # the multi phase's sliding window


def window_sum_plain(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[i] = x[i] + ... + x[i + window - 1], windows past the end summing
    what is there (int64 prefix sums)."""
    c = torch.cat([x.new_zeros(1, dtype=torch.int64),
                   torch.cumsum(x, 0, dtype=torch.int64)])
    i = torch.arange(x.numel(), device=x.device)
    return (c[(i + window).clamp(max=x.numel())] - c[i]).to(x.dtype)


def multi_device(results: dict, ra: dict, km: dict, wl: dict,
                 smi: str) -> None:
    """Phase multi: the multi-device paths at world size 1 over NCCL, on
    the objects of phases 4 and kmer, each equal to its single-device
    counterpart; then the dry run as a subprocess."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
    from aligngraph_tpu_torch.parallel import mesh as pm
    from aligngraph_tpu_torch.parallel.coverage import (
        make_sharded_coverage, span_coverage)
    from aligngraph_tpu_torch.parallel.halo import sliding_window_sum_sharded
    from aligngraph_tpu_torch.parallel.kmer_shard import (
        build_kmer_layer_sharded)

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    pm.init_group("cuda", 0, 1, str(wl["work"].parent / "nccl_group"))
    try:
        mesh = pm.make_mesh("cuda")
        # NCCL starts its communicator at the group's first collective
        one = torch.ones(1, device=mesh.device)
        _, first_s = walled(lambda: dist.all_reduce(one, group=mesh.group))
        phase("multi", f"{dist.get_backend()} group of {mesh.world_size} "
              f"on {mesh.device} ({time.perf_counter() - t0:.2f} s, of "
              f"which the first collective {first_s:.3f} s); {smi}")

        align = pm.make_sharded_aligner(mesh, ra["aligner"])
        (res, launches, lanes, by_l), wall = walled(
            lambda: counted(lambda: align(ra["reads"])))
        require_launched("multi", launches, by_l, results)
        want = ra["records"]
        bad = [f for f in FIELDS if getattr(res.records, f).dtype
               != getattr(want, f).dtype
               or not np.array_equal(getattr(res.records, f),
                                     getattr(want, f))]
        if bad or not sum(res.per_rank) == res.total == want.n:
            raise AssertionError(f"sharded aligner != align: fields {bad}, "
                                 f"records {res.per_rank} / {res.total} vs "
                                 f"{want.n}")
        phase("multi", f"make_sharded_aligner: {ra['reads'].n_pairs} pairs, "
              f"{res.total} records == align in every field; wall "
              f"{wall:.4f} s (align's timed walls "
              f"{[round(w, 4) for w in ra['walls']]} s); launches "
              f"{launches}; {smi}")

        every = km["every"]
        G = int(km["g0"].part_len)
        starts = torch.from_numpy(every.target_start.reshape(-1)).cuda()
        ends = torch.from_numpy(every.target_end.reshape(-1)).cuda()
        cov_fn = make_sharded_coverage(mesh, G)
        cov_sh, sh_s = walled(lambda: cov_fn(starts, ends))
        cov, plain_s = walled(lambda: span_coverage(starts, ends, G))
        if not torch.equal(cov_sh, cov):
            raise AssertionError("sharded coverage != span_coverage")
        phase("multi", f"make_sharded_coverage: {starts.numel()} spans over "
              f"G {G} == span_coverage; wall {sh_s * 1e3:.3f} ms vs "
              f"{plain_s * 1e3:.3f} ms plain; {smi}")

        win_fn = sliding_window_sum_sharded(mesh, WINDOW)
        win_sh, sh_s = walled(lambda: win_fn(cov))
        win, plain_s = walled(lambda: window_sum_plain(cov, WINDOW))
        if not torch.equal(win_sh, win):
            raise AssertionError("sharded window sum != plain")
        phase("multi", f"sliding_window_sum_sharded (window {WINDOW}) on "
              f"{cov.numel()} positions == plain; wall {sh_s * 1e3:.3f} ms "
              f"vs {plain_s * 1e3:.3f} ms plain; {smi}")

        cfg, reads = wl["cfg"], wl["reads"]
        g_sh = copy.deepcopy(km["g0"])
        st, wall = walled(lambda: build_kmer_layer_sharded(
            g_sh, every, reads, cfg.k_mer, cfg.insert_variation, mesh,
            chunk_records=KMER_CHUNK))
        bad = [f for f in KM_FIELDS
               if getattr(g_sh, f).dtype != getattr(km["g_split"], f).dtype
               or not np.array_equal(getattr(g_sh, f),
                                     getattr(km["g_split"], f))]
        if bad or dataclasses.asdict(st) != HOST_KMER_STATS:
            raise AssertionError(f"sharded k-mer build != device build: "
                                 f"fields {bad}, stats {st}")
        # the single-device build again, after the sharded one: the two
        # walls in turns (host phase 0 varies within a call)
        g_dev = copy.deepcopy(km["g0"])
        _, dev_s = walled(lambda: kj.build_kmer_layer_device(
            g_dev, every, reads, cfg.k_mer, cfg.insert_variation,
            chunk_records=KMER_CHUNK, device="cuda"))
        del g_dev
        phase("multi", f"build_kmer_layer_sharded: {every.n} records, "
              f"chunks of {KMER_CHUNK}: all {len(KM_FIELDS)} arrays == the "
              f"device build, stats == HOST_KMER_STATS; wall {wall:.3f} s; "
              f"build_kmer_layer_device {km['wall']:.3f} s before it, "
              f"{dev_s:.3f} s after it; {smi}")
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "aligngraph_tpu_torch.dryrun", "--nproc",
         "1"], cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the dry run exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    phase("multi", f"{proc.stdout.strip()} "
          f"({time.perf_counter() - t0:.1f} s, process start included); "
          f"{smi}")


def pipeline_full(results: dict, wl: dict, smi: str) -> None:
    """Phase 7: aligngraph_tpu_torch.bench_pipeline's run_pipeline (the
    device k-mer build, by the CLI's rule) and Eval on cuda at
    bench_pipeline.py's workload; then the CLI from FASTA files on the
    same workload (cli_full)."""
    from aligngraph_tpu_torch import bench_pipeline

    (res, wall), launches, lanes, by_l = counted(
        lambda: bench_pipeline.pipeline(wl, device="cuda"))
    require_launched("pipeline_full", launches, by_l, results)
    st = res.stats["stage_seconds"]
    phase("full", f"run_pipeline wall {wall:.2f} s; k-mer build "
          f"{res.stats['graph_build']}; stages "
          + ", ".join(f"{k} {st[k]:.2f} s" for k in
                      ("alignment", "contig_layer", "kmer_build",
                       "traverse", "refinement"))
          + "; alignment threads " + ", ".join(
              f"{k} {v:.2f} s"
              for k, v in res.stats["alignment_threads"].items())
          + f"; read records {res.stats['read_alignments']}, contig "
          f"placements {res.stats['contig_placements']}; native traversal "
          f"{res.stats['native_traversal']}; launches {launches}; lanes "
          f"{lanes}; kmer stats {res.stats['kmer_build']}")
    if not res.stats["native_traversal"]:
        raise AssertionError("the native C++ traversal did not load")
    if res.stats["graph_build"] != "device":
        raise AssertionError(f"k-mer build {res.stats['graph_build']} on "
                             f"cuda")
    if res.stats["kmer_build"] != HOST_KMER_STATS:
        raise AssertionError(f"device k-mer build stats "
                             f"{res.stats['kmer_build']} != the host "
                             f"build's {HOST_KMER_STATS}")
    t0 = time.perf_counter()
    line, e_launches, e_lanes, e_by_l = counted(
        lambda: bench_pipeline.report(wl, res, wall, device="cuda"))
    eval_s = time.perf_counter() - t0
    require_launched("eval", e_launches, e_by_l, results, need=WITH_CHAIN)
    # the main path: run_pipeline, then Eval of its extended contigs
    for n, r in results.items():
        r["launches"] = launches[n] + e_launches[n]
    got = {"extended": line["extended"], **line["eval"]}
    phase("full", f"eval {eval_s:.2f} s, launches {e_launches}, lanes "
          f"{e_lanes}; bench_pipeline's line {json.dumps(line)}; {smi}")
    phase("full", "Eval vs the JAX package's BENCH_PIPE.json: " + ", ".join(
        f"{k} {got[k]} vs {v}" for k, v in BENCH_PIPE_EVAL.items()))
    diff = {k: (got[k], v) for k, v in BENCH_PIPE_EVAL.items()
            if got[k] != v}
    if diff:
        raise AssertionError(f"Eval != BENCH_PIPE.json: {diff}")
    cli_full(results, wl, smi)


def cli_full(results: dict, wl: dict, smi: str) -> None:
    """Phase 7, the CLI: the workload's reads as r1.fa and r2.fa (pair i
    named p{i}), then python -m aligngraph_tpu_torch's main on cuda from
    those files (formalize_reads in memory: 115 MB of FASTA is under
    stream_reads_threshold): the k-mer layer built on the device, and
    extended.fa, remaining.fa and the tmp/ stage files equal to the
    in-memory run's byte for byte."""
    from aligngraph_tpu_torch import __main__ as cli
    from aligngraph_tpu_torch.workload import write_reads_fasta

    work, cfg, reads = wl["work"], wl["cfg"], wl["reads"]
    t0 = time.perf_counter()
    write_reads_fasta(work, reads.data, reads.lengths)
    write_s = time.perf_counter() - t0
    out = work / "cli"
    out.mkdir()
    argv = ["--read1", str(work / "r1.fa"), "--read2", str(work / "r2.fa"),
            "--contig", cfg.contig, "--genome", cfg.genome,
            "--distanceLow", "300", "--distanceHigh", "700",
            "--extendedContig", str(out / "extended.fa"),
            "--remainingContig", str(out / "remaining.fa")]
    cwd = os.getcwd()
    os.chdir(out)                       # the CLI's work dir is ./tmp
    t0 = time.perf_counter()
    try:
        with pipeline_results() as kept:
            rc, launches, lanes, by_l = counted(
                lambda: cli.main(argv, device="cuda"))
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}")
    require_launched("cli_full", launches, by_l, results)
    for n, r in results.items():
        r["launches"] += launches[n]
    res = kept[0]
    names = ["extended.fa", "remaining.fa"] + [
        f"tmp/{f}" for f in sorted(os.listdir(out / "tmp"))
        if f.endswith(".fa")]
    want = sorted(f"tmp/{f}" for f in os.listdir(work / "tmp")
                  if f.endswith(".fa"))
    diff = [f for f in names if (out / f).read_bytes()
            != (work / f).read_bytes()]
    if names[2:] != want or len(want) < 3 or diff:
        raise AssertionError(f"CLI != the in-memory run: stage files "
                             f"{names[2:]} vs {want}, differing {diff}")
    if res.stats["graph_build"] != "device":
        raise AssertionError(f"CLI k-mer build {res.stats['graph_build']}")
    nbytes = sum((work / f).stat().st_size for f in ("r1.fa", "r2.fa"))
    phase("full", f"CLI from FASTA ({reads.n_pairs} pairs, {nbytes} B, "
          f"written in {write_s:.2f} s): formalize "
          f"{res.stats['formalize_seconds']:.2f} s, run_pipeline "
          f"{res.wall_seconds:.2f} s, CLI wall {wall:.2f} s; k-mer build "
          f"{res.stats['graph_build']}; {names} equal to the in-memory "
          f"run's, byte for byte; launches {launches}, lanes {lanes}; {smi}")


# phase big: aligngraph_tpu_torch.bigscale at 16 Mb (two 8 Mb parts), 20x;
# cut from 32 Mb so that the smoke with phase masb stays within ~900 s
BIG_MB, BIG_DEPTH, BIG_PART = 16.0, 20.0, 2
BIG_CHECK_PAIRS = 2048
# the big run's product, recorded on the H100 by the first passing run at
# this size (PERF.md), so that any change shows; None: print it, compare
# nothing.  Eval's identity: 0.9991 here, 0.9988 at 32 Mb, 0.99912 at
# 64.4 Mb, 0.9993 on the 4.6 Mb workload; it moves with the region (0.9981
# to 0.9994 over 1 Mb windows of the 32 Mb run's contigs), and on the 1-2
# Mb window's share of that workload the JAX package writes the port's
# contigs byte for byte, at 0.9983 (PERF.md; scripts/eval_windows.py,
# scripts/bigscale_window.py)
BIG_EVAL = {"extended": 184, "extended_bases": 15_914_481,
            "n_contigs": 184, "n_true_contigs": 184, "n50": 143_389,
            "covered_length": 15_919_120, "mpmb": 0.0,
            "average_identity": 0.9991}
BIG_KMER_STATS = {"tuples": 151_817_610, "rows": 303_642_462,
                  "groups": 153_279_450, "dropped_rank": 0,
                  "dropped_slots": 0, "dropped_edges": 0}
# the Eval figures a phase pins, beside average_identity to 4 places
EVAL_KEYS = ("n_contigs", "n_true_contigs", "n50", "covered_length", "mpmb")


@contextlib.contextmanager
def kept_kmer_part(wanted):
    """driver.build_kmer_layer_device wrapped for the block: for the part
    whose part_offset `wanted` accepts, just before its build, a copy of
    its graph after the contig layer (g0), its first KMER_CHUNKS chunks of
    records as the build gets them (recs), the reads and the part's offset
    (lo) go to the dict the block gets, and the copy's seconds to its
    copy_s."""
    import copy

    from aligngraph_tpu_torch.pipeline import driver

    build = driver.build_kmer_layer_device
    kept = {"copy_s": 0.0}

    def keep(g, recs, reads, *args, part_offset, rows, **kw):
        if wanted(part_offset):
            t = time.perf_counter()
            kept.update(g0=copy.deepcopy(g), lo=part_offset, reads=reads,
                        recs=driver._subset_pairs(
                            recs, rows[:KMER_CHUNKS * KMER_CHUNK]))
            kept["copy_s"] += time.perf_counter() - t
        return build(g, recs, reads, *args, part_offset=part_offset,
                     rows=rows, **kw)

    driver.build_kmer_layer_device = keep
    try:
        yield kept
    finally:
        driver.build_kmer_layer_device = build


def part_kmer_vs_oracle(name: str, label: str, kept: dict, cfg) -> None:
    """The kept part's device k-mer build (kept_kmer_part) against the host
    oracle on its KMER_CHUNKS chunks of KMER_CHUNK records: all 13 arrays
    and the stats equal."""
    import copy
    import dataclasses

    from aligngraph_tpu_torch import build_kmer_layer
    from aligngraph_tpu_torch.graph import kmer_layer_jit as kj

    g0, recs, lo, reads = kept["g0"], kept["recs"], kept["lo"], kept["reads"]
    k, iv = cfg.k_mer, cfg.insert_variation
    g_host = copy.deepcopy(g0)
    t0 = time.perf_counter()
    st_host = build_kmer_layer(g_host, recs, reads, k, iv, part_offset=lo,
                               chunk_records=KMER_CHUNK)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st_dev = kj.build_kmer_layer_device(g0, recs, reads, k, iv,
                                        part_offset=lo,
                                        chunk_records=KMER_CHUNK,
                                        device="cuda")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    state = kj.state_bytes(g0.km_cnt.shape[0])
    bad = [f for f in KM_FIELDS
           if getattr(g0, f).dtype != getattr(g_host, f).dtype
           or not np.array_equal(getattr(g0, f), getattr(g_host, f))]
    if bad or dataclasses.asdict(st_dev) != dataclasses.asdict(st_host) \
            or recs.n != KMER_CHUNKS * KMER_CHUNK:
        raise AssertionError(f"{name}: {label}'s device k-mer build != "
                             f"host oracle: fields {bad}, stats {st_dev} "
                             f"vs {st_host}, {recs.n} records")
    phase(name, f"{label} (offset {lo}, {g0.km_cnt.shape[0]} positions): "
          f"first {recs.n} accepted records, host oracle {host_s:.3f} s, "
          f"device {dev_s:.3f} s; all {len(KM_FIELDS)} fields and the stats "
          f"equal: {dataclasses.asdict(st_dev)}; peak device memory "
          f"{peak / 2**30:.2f} GiB (state {state / 2**30:.2f} GiB)")


def big_genome(results: dict, work: Path, smi: str) -> None:
    """Phase big: bigscale.run on "cuda" (the launches of the big-genome
    path), its invariants, the read aligner on cuda against cpu on
    BIG_CHECK_PAIRS pairs at the run's index, and part 2's device
    k-mer build against the host oracle on the part's first KMER_CHUNKS
    chunks of accepted records (index, graph and records as run_pipeline
    gave them to its aligners and its build: the driver's ReadAligner,
    whose device index the contig aligner shares, and
    build_kmer_layer_device are wrapped for the run to keep them)."""
    from aligngraph_tpu_torch import ReadAligner, Reads
    from aligngraph_tpu_torch import bigscale
    from aligngraph_tpu_torch.pipeline import driver

    index, real = {}, driver.ReadAligner

    class KeepIndex(real):
        """The driver's read aligner, its device seed index kept (the
        driver drops its own name for the index once the aligners hold
        it)."""

        @classmethod
        def from_index(cls, *args, **kw):
            ra = super().from_index(*args, **kw)
            index["index"] = ra.index
            return ra

    driver.ReadAligner = KeepIndex
    try:
        # part 2 is the one at a non-zero offset
        with kept_kmer_part(lambda lo: lo > 0) as kept:
            t0 = time.perf_counter()
            (line1, line2, ctx), launches, lanes, by_l = counted(
                lambda: bigscale.run(BIG_MB, BIG_DEPTH, BIG_PART,
                                     device="cuda", work_dir=str(work)))
            wall = time.perf_counter() - t0
    finally:
        driver.ReadAligner = real
    require_launched("big", launches, by_l, results, need=WITH_CHAIN)
    for n, r in results.items():
        r["launches"] += launches[n]
    mem = {k: round(v.get("device_peak_bytes", 0) / 2**30, 2)
           for k, v in line1["stage_memory"].items()}
    phase("big", f"{BIG_MB:g} Mb, {BIG_DEPTH:g}x, --part {BIG_PART}: "
          f"{line1['n_pairs']} pairs; setup {line1['setup_seconds']} s, "
          f"run_pipeline {line1['value']} s, stages "
          f"{line1['stage_seconds']} (kmer_build with {kept['copy_s']:.1f} s "
          f"of this phase's copy of part 2), alignment threads "
          f"{line1['alignment_threads']}, eval {line2['eval_s']} s, "
          f"phase wall {wall:.1f} s; {smi}")
    phase("big", f"peak device GiB by stage {mem}, Eval "
          f"{line2['device_peak_bytes'] / 2**30:.2f}; k-mer state bytes "
          f"reckoned {line1['kmer_state_bytes']}, allocated "
          f"{line1['kmer_state_bytes_measured']}; max RSS of this process "
          f"(every phase and the copy of part 2) {line1['max_rss_gb']} GB of "
          f"{line1['host_ram_bytes'] / 1e9:.1f}; launches {launches}; lanes "
          f"{lanes}")
    gb = {k: dict(rss=round(v["host_rss_bytes"] / 1e9, 2),
                  heap=round((v["host_heap_bytes"] or 0) / 1e9, 2),
                  **{a: round(b / 1e9, 3) for a, b in v["arrays"].items()})
          for k, v in line1["stage_memory"].items()}
    phase("big", f"host GB at each stage's end (RSS, live heap, arrays; "
          f"this process holds every earlier phase's objects): {gb}")
    phase("big", f"extended {line1['extended']} ({line1['extended_bases']} "
          f"bases), remaining {line1['remaining']}, aligned pair fraction "
          f"{line1['aligned_pair_fraction']}; kmer stats "
          f"{line1['kmer_stats']}; Eval {line2}")
    ks = line1["kmer_stats"]
    bad = {k: v for k, v in ks.items() if k.startswith("dropped_") and v}
    if bad or not line1["extended"]:
        raise AssertionError(f"big: dropped {bad}, extended "
                             f"{line1['extended']}")
    if not (line2["mpmb"] == 0.0
            and line2["n_true_contigs"] >= 0.95 * line1["extended"]):
        raise AssertionError(f"big: Eval {line2} for {line1['extended']} "
                             f"extended contigs")
    got = dict(extended=line1["extended"],
               extended_bases=line1["extended_bases"],
               **{k: line2[k] for k in EVAL_KEYS},
               average_identity=round(line2["average_identity"], 4))
    if BIG_EVAL is None or BIG_KMER_STATS is None:
        phase("big", f"no pins yet: BIG_EVAL = {got}; BIG_KMER_STATS = "
              f"{ks}")
    elif (got, ks) != (BIG_EVAL, BIG_KMER_STATS):
        raise AssertionError(f"big: {got} {ks} != the recorded {BIG_EVAL} "
                             f"{BIG_KMER_STATS}")

    # the read aligner on cuda against cpu at the run's index
    cfg, reads, genome = ctx["cfg"], ctx["reads"], ctx["genome"]
    del ctx
    t0 = time.perf_counter()
    gseq = np.asarray(genome.seq, np.int8)
    index = index.pop("index")
    n = BIG_CHECK_PAIRS
    sub = Reads(n, reads.max_len, reads.data[:2 * n], reads.lengths[:n])
    got = ReadAligner.from_index(gseq, index, cfg, device="cuda").align(sub)
    cpu = ReadAligner.from_index(gseq, index.to("cpu"), cfg,
                                 device="cpu").align(sub)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(cpu, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"big: cuda != cpu on field {f}")
    del index
    phase("big", f"read aligner cuda == cpu on {n} pairs, {got.n} records, "
          f"every field, the run's index of {len(gseq)} bases "
          f"({time.perf_counter() - t0:.1f} s)")
    part_kmer_vs_oracle("big", "part 2", kept, cfg)


# phase chroms: BASELINE.json config 2's layout (S. cerevisiae R64's 16
# chromosomes, workload.YEAST_R64), 20x, --iterativeMap --part 1
CHROMS_DEPTH, CHROMS_SEED = 20.0, 288
CHROMS_KMER_PART = "chrXII"
# the run's product, recorded on the H100 by the first passing run
# (PERF.md), kept as BIG_EVAL is kept; an entry None: print it, compare
# the rest
CHROMS_EVAL = {"extended": 128, "n_contigs": 128, "n_true_contigs": 128,
               "n50": 156_365, "covered_length": 12_020_145, "mpmb": 0.0,
               "average_identity": 0.9989}
CHROMS_KMER_STATS = {"tuples": 114_545_539, "rows": 229_170_194,
                     "groups": 114_735_300, "dropped_rank": 0,
                     "dropped_slots": 0, "dropped_edges": 0}


def chromosomes(results: dict, work: Path, smi: str) -> None:
    """Phase chroms: the CLI (main, on "cuda") with --iterativeMap at
    --part 1 on a 16-chromosome genome (workload.make_multichrom_workload
    at workload.YEAST_R64's lengths, CHROMS_DEPTH, CHROMS_SEED; FASTA by
    write_multichrom_fasta), then Eval of its extended contigs against the
    16-record target on "cuda"; its invariants and pins; then the device
    k-mer build of CHROMS_KMER_PART's part against the host oracle on
    its first KMER_CHUNKS chunks of records."""
    import resource

    from aligngraph_tpu_torch import Config
    from aligngraph_tpu_torch import __main__ as cli
    from aligngraph_tpu_torch.evaluate.evaluate import evaluate
    from aligngraph_tpu_torch.workload import (
        YEAST_R64, make_multichrom_workload, write_multichrom_fasta)

    t_phase = time.perf_counter()
    names = [n for n, _ in YEAST_R64]
    lens = [ln for _, ln in YEAST_R64]
    wl = make_multichrom_workload(lens, CHROMS_DEPTH, CHROMS_SEED)
    work.mkdir()
    write_multichrom_fasta(work, names, wl)
    n_pairs, n_contigs = len(wl["lens"]), len(wl["contigs"])
    ref_lens = [len(r) for r in wl["refs"]]
    del wl
    xii = names.index(CHROMS_KMER_PART)
    lo_xii = sum(ref_lens[:xii])
    phase("chroms", f"{len(names)} chromosomes, {sum(ref_lens)} reference "
          f"bases, {n_pairs} pairs, {n_contigs} draft contigs; set-up "
          f"{time.perf_counter() - t_phase:.1f} s")

    out = work / "cli"
    out.mkdir()
    argv = ["--read1", str(work / "r1.fa"), "--read2", str(work / "r2.fa"),
            "--contig", str(work / "contigs.fa"), "--genome",
            str(work / "genome.fa"), "--distanceLow", "300",
            "--distanceHigh", "700", "--iterativeMap",
            "--extendedContig", str(out / "extended.fa"),
            "--remainingContig", str(out / "remaining.fa")]
    cwd = os.getcwd()
    os.chdir(out)                       # the CLI's work dir is ./tmp
    t0 = time.perf_counter()
    try:
        with pipeline_results() as kept_runs, \
                kept_kmer_part(lambda lo: lo == lo_xii) as kept:
            rc, launches, lanes, by_l = counted(
                lambda: cli.main(argv, device="cuda"))
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"chroms: the CLI exited {rc}")
    require_launched("chroms", launches, by_l, results)
    res = kept_runs[0]
    st = res.stats
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    metrics, e_launches, e_lanes, e_by_l = counted(
        lambda: evaluate(work / "target.fa", out / "extended.fa",
                         device="cuda"))
    eval_s = time.perf_counter() - t0
    eval_peak = torch.cuda.max_memory_allocated()
    require_launched("chroms_eval", e_launches, e_by_l, results)
    for n, r in results.items():
        r["launches"] += launches[n] + e_launches[n]

    stage = st["stage_seconds"]
    phase("chroms", f"CLI --iterativeMap --part 1: {st['n_parts']} parts, "
          f"k-mer build {st['graph_build']}, CLI wall {wall:.2f} s, "
          f"run_pipeline {res.wall_seconds:.2f} s; formalize "
          f"{st['formalize_seconds']:.2f} s; stages " + ", ".join(
              f"{k} {stage[k]:.2f} s" for k in
              ("alignment", "contig_layer", "kmer_build", "traverse",
               "refinement"))
          + f"; read records {st['read_alignments']}, contig placements "
          f"{st['contig_placements']}; Eval {eval_s:.2f} s; {smi}")
    for p, f in sorted(st["parts"].items()):
        phase("chroms", f"part {p} ({names[p]}, {ref_lens[p]} b): reads "
              f"{f['read_index_s']:.2f} s index + {f['reads_s']:.2f} s "
              f"({f['read_records']} records), contigs on that index "
              f"{f['contigs_s']:.2f} s "
              f"({f['contig_placements']} placements), contig layer "
              f"{f['contig_layer_s']:.2f} s, k-mer build "
              f"{f['kmer_build_s']:.2f} s ({f['kmer_records']} records), "
              f"traverse {f['traverse_s']:.2f} s")
    mem = st["memory"]
    dev_peak = max(v.get("device_peak_bytes", 0) for v in mem.values())
    phase("chroms", f"peak device GiB: stages {dev_peak / 2**30:.2f}, Eval "
          f"{eval_peak / 2**30:.2f}; host: the alignment stage's RSS "
          f"{mem['alignment']['host_rss_bytes'] / 1e9:.2f} GB (per-part "
          f"records before their join {st['part_records_bytes'] / 1e9:.3f} "
          f"GB), max RSS of this process (every phase so far) "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} "
          f"GB; launches {launches}, lanes {lanes}; Eval launches "
          f"{e_launches}")
    phase("chroms", f"extended {len(res.extended_ids)}, remaining "
          f"{len(res.remaining_ids)}; kmer stats {st['kmer_build']}; Eval "
          f"{metrics}")
    if st["n_parts"] != len(names) or st["graph_build"] != "device":
        raise AssertionError(f"chroms: {st['n_parts']} parts, k-mer build "
                             f"{st['graph_build']}")
    need = {f"{k} L{L}" for k in KERNEL_NAMES for L in (L_MAIN, L_TILE)}
    if not need <= set(by_l):
        raise AssertionError(f"chroms: kernels not launched at L 100 and "
                             f"L 512: {sorted(need - set(by_l))}")
    ks = st["kmer_build"]
    bad = {k: v for k, v in ks.items() if k.startswith("dropped_") and v}
    n_ext = len(res.extended_ids)
    if bad or not n_ext:
        raise AssertionError(f"chroms: dropped {bad}, extended {n_ext}")
    if not (metrics["mpmb"] == 0.0
            and metrics["n_true_contigs"] >= 0.95 * n_ext):
        raise AssertionError(f"chroms: Eval {metrics} for {n_ext} extended "
                             f"contigs")
    got_eval = dict(extended=n_ext, **{k: metrics[k] for k in EVAL_KEYS},
                    average_identity=round(metrics["average_identity"], 4))
    if CHROMS_EVAL is None or CHROMS_KMER_STATS is None:
        phase("chroms", f"no pins yet: CHROMS_EVAL = {got_eval}; "
              f"CHROMS_KMER_STATS = {ks}")
    elif got_eval != CHROMS_EVAL or ks != CHROMS_KMER_STATS:
        raise AssertionError(f"chroms: {got_eval} {ks} != the recorded "
                             f"{CHROMS_EVAL} {CHROMS_KMER_STATS}")
    part_kmer_vs_oracle("chroms", f"part {xii} ({CHROMS_KMER_PART})", kept,
                        Config.from_argv(argv))
    phase("chroms", f"phase wall {time.perf_counter() - t_phase:.1f} s")


# phase masb: BASELINE.json config 3, misassembly removal over A.
# thaliana chr1's length (TAIR10 Chr1, NC_003070.9) with chimeric drafts
MASB_LEN, MASB_DEPTH, MASB_SEED = 30_427_671, 40.0, 3702
# the card against the CPU: remove_misassembly over a small instance's
# drafts (homes of a chimera's halves >= 100 kb apart in 500 kb)
MASB_CHECK = dict(genome_len=500_000, depth=40.0, seed=3703,
                  min_apart=100_000)
# the run's product, recorded on the H100 by the first passing run
# (PERF.md), kept as BIG_EVAL is kept; an entry None: print it, compare
# the rest
MASB_EVAL = {
    "drafts": {"n_contigs": 9028, "n_true_contigs": 9090, "n50": 3363,
               "covered_length": 27_585_279, "mpmb": 5.872126451927484,
               "average_identity": 0.9871},
    "uncorrected": {"n_contigs": 1720, "n_true_contigs": 1782,
                    "n50": 105_911, "covered_length": 29_801_098,
                    "mpmb": 5.032631766274879, "average_identity": 0.9881},
    "corrected": {"n_contigs": 1760, "n_true_contigs": 1782, "n50": 105_425,
                  "covered_length": 29_818_320, "mpmb": 3.6402836703184374,
                  "average_identity": 0.9893}}
MASB_KMER_STATS = {"tuples": 577_458_845, "rows": 1_155_449_911,
                   "groups": 583_659_817, "dropped_rank": 0,
                   "dropped_slots": 0, "dropped_edges": 0}
# phase masb's k-mer build with phase 0 on the host (its numpy rows and
# skip; on NVIDIA H100 80GB HBM3, 700.00 W, see PERF.md): the stage's
# seconds and its CUDA-event split, s
MASB_KMER_HOST_PHASE0 = {"kmer_build": 51.99, "normalize": 0.58,
                         "h2d": 36.77, "emit": 1.60, "group": 1.21,
                         "rounds": 8.51, "edges": 1.74, "d2h": 1.56}
MASB_SPLITS = {
    "extended": {"contigs_in": 367, "whole_safe": 367, "contigs_split": 0,
                 "pieces_out": 367},
    "remaining": {"contigs_in": 1502, "whole_safe": 1337,
                  "contigs_split": 42, "pieces_out": 1544},
    "chimeras": {
        "forward": {"split": 40, "whole": 9, "kept": 45, "absent": 0},
        "rc": {"split": 2, "whole": 14, "kept": 78, "absent": 0}}}


# phase masb's seed index builds by caller: the alignment stage's,
# refinement's (in its contig aligner), stage (5)'s over each file's
# contigs and over the genome for each file, Eval's target
MASB_BUILDS = {"driver": 1, "contig_aligner": 1, "misassembly": 4,
               "evaluate": 1}


def secs(d: dict) -> str:
    """A dict of seconds as one line, 3 places."""
    return ", ".join(f"{k} {v:.3f}" for k, v in d.items())


def masb_index_builds(builds: list) -> None:
    """Phase masb's seed index builds (index_builds), each on the card,
    with its peak (peak_of_builds); then stage (5)'s index over
    extended.fa's contigs and their N separators (misassembly's first
    build) on "cuda" and on "cpu", every field equal."""
    axis = next(b for b in builds if b["caller"] == "misassembly")
    axis = (axis["codes"], axis["seed_len"])
    off = [b["caller"] for b in builds if b["device"] != "cuda"]
    callers = collections.Counter(b["caller"] for b in builds)
    if off or callers != MASB_BUILDS:
        raise AssertionError(f"masb: seed index builds by caller {callers}, "
                             f"not {MASB_BUILDS}; off the card: {off}")
    rows = peak_of_builds(builds)
    builds.clear()
    phase("masb", f"seed index builds on the card ({len(rows)}; ms of the "
          f"run, peak bytes of the same build again): " + json.dumps(rows))
    index_cuda_vs_cpu("masb", "stage (5)'s index over extended.fa", *axis)


def masb_cuda_vs_cpu(work: Path) -> str:
    """remove_misassembly(..., which="remaining", chaff=...) over
    make_misassembly_workload(**MASB_CHECK)'s drafts on "cuda" and on
    "cpu": the corrected bytes equal, with at least one ": part"."""
    from aligngraph_tpu_torch import Config, Reads, formalize_contigs
    from aligngraph_tpu_torch.pipeline.misassembly import remove_misassembly
    from aligngraph_tpu_torch.workload import (make_misassembly_workload,
                                               write_misassembly_fasta)

    work.mkdir()
    wl = make_misassembly_workload(**MASB_CHECK)
    write_misassembly_fasta(work, wl)
    reads = Reads(len(wl["lens"]), wl["data"].shape[1], wl["data"],
                  wl["lens"])
    contigs = formalize_contigs(work / "contigs.fa")
    cfg = Config(distance_low=300, distance_high=700)
    out, walls, st = [], [], []
    for dev in ("cuda", "cpu"):
        st.append({})
        t0 = time.perf_counter()
        path = remove_misassembly(
            str(work / "contigs.fa"), cfg, wl["ref"], reads,
            which="remaining", chaff=(contigs.chaff_ids, contigs.chaff_seqs),
            out_path=str(work / f"corrected_{dev}.fa"), device=dev,
            stats=st[-1])
        walls.append(time.perf_counter() - t0)
        out.append(Path(path).read_bytes())
    parts = out[0].count(b" : part")
    if out[0] != out[1] or not parts:
        raise AssertionError(f"masb: remove_misassembly on cuda != cpu "
                             f"({len(out[0])} and {len(out[1])} bytes) or "
                             f"no part ({parts})")
    return (f"remove_misassembly at {MASB_CHECK['genome_len']} bases, "
            f"{len(wl['lens'])} pairs, {contigs.n_real} drafts "
            f"({len(wl['chimera_index'])} chimeras): cuda == cpu, "
            f"{len(out[0])} bytes, {parts} ': part' headers, "
            f"{st[0]['contigs_split']} split, {st[0]['whole_safe']} kept "
            f"whole; cuda {walls[0]:.2f} s, cpu {walls[1]:.2f} s")


def misassembly_phase(results: dict, work: Path, smi: str) -> None:
    """Phase masb: BASELINE.json config 3 on "cuda".  run_pipeline with
    misassembly_removal=True on make_misassembly_workload(MASB_LEN,
    MASB_DEPTH, MASB_SEED) (the reads in memory; genome, target and
    drafts through FASTA and the formalizers, as bigscale.run), --part 1,
    the device k-mer build; then Eval on "cuda", on one target index, of
    the drafts, of the uncorrected output (extended.fa then
    remaining.fa, one file) and of the corrected one
    (corrected_extended.fa then corrected_remaining.fa) against the
    target.  Prints the stages, stage (5) by file, memory, the ": part"
    headers and what became of the chimeras, relocations and inversions
    apart; checks the invariants (the corrected output's MPMB below both
    the drafts' and the uncorrected output's) and the pins MASB_EVAL,
    MASB_KMER_STATS, MASB_SPLITS; then masb_cuda_vs_cpu."""
    import resource

    from aligngraph_tpu_torch import (Config, Reads, formalize_contigs,
                                      formalize_genome)
    from aligngraph_tpu_torch.bigscale import check_state_fits
    from aligngraph_tpu_torch.evaluate.evaluate import evaluate, genome_index
    from aligngraph_tpu_torch.io.fasta import read_fasta
    from aligngraph_tpu_torch.pipeline.driver import run_pipeline
    from aligngraph_tpu_torch.workload import (chimera_outcomes,
                                               make_misassembly_workload,
                                               outcomes_by_strand,
                                               write_misassembly_fasta)

    t_phase = time.perf_counter()
    work.mkdir()
    wl = make_misassembly_workload(MASB_LEN, MASB_DEPTH, MASB_SEED)
    write_misassembly_fasta(work, wl)
    reads = Reads(len(wl["lens"]), wl["data"].shape[1], wl["data"],
                  wl["lens"])
    chimeras = [f"c{i}" for i in wl["chimera_index"]]
    chimera_rc = wl["chimera_rc"]
    n_cut, n_drafts = wl["n_cut"], len(wl["contigs"])
    del wl
    cfg = Config(read1="-", read2="-", contig=str(work / "contigs.fa"),
                 genome=str(work / "genome.fa"), distance_low=300,
                 distance_high=700, part=1, misassembly_removal=True,
                 graph_build="device",
                 extended_contig=str(work / "extended.fa"),
                 remaining_contig=str(work / "remaining.fa"),
                 work_dir=str(work / "tmp"))
    contigs = formalize_contigs(cfg.contig)
    genome = formalize_genome(cfg.genome, cfg.part)
    need = check_state_fits(genome.part_len, "cuda")
    phase("masb", f"{MASB_LEN} bases, {MASB_DEPTH:g}x: {reads.n_pairs} "
          f"pairs, {n_cut} drafts cut, {n_drafts} after the joins, "
          f"{len(chimeras)} chimeras ({contigs.n_real} over 200 bp); k-mer "
          f"state {max(need) / 2**30:.2f} GiB; set-up "
          f"{time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    with largest_chain_launch() as chain_run, index_builds() as builds:
        res, launches, lanes, by_l = counted(
            lambda: run_pipeline(cfg, reads=reads, contigs=contigs,
                                 genome=genome, device="cuda"))
    wall = time.perf_counter() - t0
    del reads, contigs, genome
    require_launched("masb", launches, by_l, results, need=WITH_CHAIN)
    chain_launches = [chain_run]
    st = res.stats
    stage = st["stage_seconds"]
    phase("masb", f"run_pipeline {res.wall_seconds:.2f} s + stage (5) "
          f"{stage['misassembly_removal']:.2f} s (call {wall:.2f} s); "
          f"stages " + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
          + "; alignment threads " + ", ".join(
              f"{k} {v:.2f}" for k, v in st["alignment_threads"].items())
          + f"; read records {st['read_alignments']}, contig placements "
          f"{st['contig_placements']}; {smi}")
    threads = st["alignment_threads"]
    phase("masb", f"read thread {threads['reads']:.2f} s, its host seconds "
          f"(aligner.split): wait {threads['reads_wait_s']:.2f}, copy out "
          f"{threads['reads_copy_out_s']:.2f}, concatenation "
          f"{threads['reads_concat_s']:.2f}; stage (5)'s read aligns " + "; "
          .join(f"{w} {f['reads_s']:.2f} s (wait {f['reads_wait_s']:.2f}, "
                f"copy out {f['reads_copy_out_s']:.2f}, concatenation "
                f"{f['reads_concat_s']:.2f}), {f['read_records']} records"
                for w, f in st["misassembly"].items() if "reads_s" in f))
    split = {n: round(v / 1e3, 2) for n, v in st["kmer_split"][0].items()}
    if len(st["kmer_split"]) != 1 or set(split) != KMER_STAGES:
        raise AssertionError(f"masb: k-mer build split {st['kmer_split']}, "
                             f"not one part's {sorted(KMER_STAGES)}")
    phase("masb", f"kmer_build {stage['kmer_build']:.2f} s, split by CUDA "
          f"events (s) {split}; with phase 0 on the host "
          f"{MASB_KMER_HOST_PHASE0}")
    phase("masb", "the alignment stage's contig align by layer (s, host "
          "clock): " + secs(st["contig_align_layers"]))
    for which, f in st["misassembly"].items():
        phase("masb", f"stage (5) {which}: " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float)
            else f"{k} {{{secs(v)}}}" if k == "contigs_layer_s"
            else f"{k} {v}"
            for k, v in f.items() if not k.endswith("_ids")))
    mem = {k: dict(dev=round(v.get("device_peak_bytes", 0) / 2**30, 2),
                   rss=round(v["host_rss_bytes"] / 1e9, 2),
                   max_rss=round(v["host_max_rss_bytes"] / 1e9, 2))
           for k, v in st["memory"].items()}
    phase("masb", f"peak device GiB, host RSS and peak RSS GB by stage: "
          f"{mem}; launches {launches}, lanes {lanes}")

    # the uncorrected output (extended.fa then remaining.fa) and the
    # corrected one, each in one file
    headers = {w: (work / f"corrected_{w}.fa").read_bytes().count(b" : part")
               for w in ("extended", "remaining")}
    for name, pre in (("uncorrected", ""), ("corrected", "corrected_")):
        with open(work / f"{name}_all.fa", "wb") as f:
            for w in ("extended", "remaining"):
                f.write((work / f"{pre}{w}.fa").read_bytes())
    t0 = time.perf_counter()
    with index_builds() as eval_builds:
        index = genome_index(work / "target.fa", device="cuda")
    builds += eval_builds
    phase("masb", f"Eval's target index, built once for the three Evals: "
          f"{time.perf_counter() - t0:.2f} s")
    evals, e_launches = {}, {n: 0 for n in results}
    for name, path in (("drafts", work / "contigs.fa"),
                       ("uncorrected", work / "uncorrected_all.fa"),
                       ("corrected", work / "corrected_all.fa")):
        t0, es = time.perf_counter(), {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with largest_chain_launch() as kept:
            m, el, _, e_by_l = counted(
                lambda: evaluate(work / "target.fa", path, device="cuda",
                                 index=index, stats=es))
        # the align's peak (seed lookups, tile DP, _finalize) above the
        # resident index, and that per aligned base out of the tile DP
        peak = torch.cuda.max_memory_allocated() - base
        per_base = peak / max(es["finalize_counts"]["bases"], 1)
        chain_launches.append(kept)
        require_launched(f"masb_eval_{name}", el, e_by_l, results,
                         need=WITH_CHAIN)
        for n in results:
            e_launches[n] += el[n]
        evals[name] = {**{k: m[k] for k in EVAL_KEYS},
                       "average_identity": round(m["average_identity"], 4)}
        phase("masb", f"Eval of the {name} {time.perf_counter() - t0:.2f} s "
              f"(upload {es['index_s']:.2f}, align {es['align_s']:.2f}; by "
              f"layer {secs(es['layer_s'])}; of it _finalize "
              f"{es['finalize_s']:.2f}: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in es["finalize_split"].items())
              + f"; counts {es['finalize_counts']}; device peak above "
              f"the index {peak / 2**30:.3f} GiB, {per_base:.1f} B an "
              f"aligned base): {m}; {smi}")
    del index
    for n, r in results.items():
        r["launches"] += launches[n] + e_launches[n]

    outs = chimera_outcomes(
        chimeras, st["misassembly"],
        {w: read_fasta(work / f"{w}.fa")[0] for w in st["misassembly"]})
    splits = {which: {k: f[k] for k in ("contigs_in", "whole_safe",
                                        "contigs_split", "pieces_out")}
              for which, f in st["misassembly"].items()}
    splits["chimeras"] = by = outcomes_by_strand(outs, chimera_rc)
    phase("masb", f"': part' headers: {headers}; of {len(chimeras)} "
          f"chimeras (split; kept whole: a placement over >= 0.8 of the "
          f"contig; kept in one piece otherwise; in no output), the "
          f"{sum(by['forward'].values())} relocations (second draft as it "
          f"is) {by['forward']}, the {sum(by['rc'].values())} inversions "
          f"(second draft reverse-complemented) {by['rc']}; splits "
          f"{splits}; max RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} "
          f"GB")

    ks = st["kmer_build"]
    bad = {k: v for k, v in ks.items() if k.startswith("dropped_") and v}
    n_split = sum(f["contigs_split"] for f in st["misassembly"].values())
    if st["graph_build"] != "device" or bad or not res.extended_ids:
        raise AssertionError(f"masb: k-mer build {st['graph_build']}, "
                             f"dropped {bad}, extended "
                             f"{len(res.extended_ids)}")
    need_l = {f"{k} L{L}" for k in KERNEL_NAMES for L in (L_MAIN, L_TILE)}
    if not need_l <= set(by_l):
        raise AssertionError(f"masb: kernels not launched at L 100 and "
                             f"L 512: {sorted(need_l - set(by_l))}")
    d_mpmb, u_mpmb, c_mpmb = (evals[k]["mpmb"] for k in
                              ("drafts", "uncorrected", "corrected"))
    if not (d_mpmb > 0 and c_mpmb < d_mpmb and c_mpmb < u_mpmb
            and n_split > 0):
        raise AssertionError(f"masb: MPMB drafts {d_mpmb}, uncorrected "
                             f"{u_mpmb}, corrected {c_mpmb}, contigs split "
                             f"{n_split}")
    unpinned = {k: evals[k] for k, v in MASB_EVAL.items() if v is None}
    if unpinned:
        phase("masb", f"no pin yet: MASB_EVAL entries {unpinned}")
    pinned = {k: v for k, v in MASB_EVAL.items() if v is not None}
    if ({k: evals[k] for k in pinned}, ks, splits) != (
            pinned, MASB_KMER_STATS, MASB_SPLITS):
        raise AssertionError(f"masb: {evals} {ks} {splits} != the recorded "
                             f"{MASB_EVAL} {MASB_KMER_STATS} {MASB_SPLITS}")
    del res
    # the chain kernel on its largest launch of this main path, against
    # the plain version; these figures stand for it in the JSON line
    big = max(chain_launches, key=lambda k: k["pairs"])
    time_chain(results, card_figures(torch.cuda.get_device_name(0)),
               CHAIN_MAIN, *big.pop("args"))
    del chain_launches
    for key in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by"):
        results["chain"][key] = results["chain"]["shapes"][CHAIN_MAIN][key]
    masb_index_builds(builds)
    phase("masb", masb_cuda_vs_cpu(work / "check"))
    phase("masb", f"phase wall {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from aligngraph_tpu_torch import native
    from aligngraph_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", f"nvcc built and loaded {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if native.get_lib() is None or native.get_fasta_lib() is None \
            or native.get_chain_lib() is None:
        raise AssertionError("g++ did not build the C++ traversal, FASTA "
                             "parser and chain DP (aligngraph_tpu_torch/"
                             "native)")
    phase("build", f"g++ built and loaded the C++ traversal, FASTA parser "
          f"and chain DP into aligngraph_tpu_torch/_build/ in "
          f"{time.perf_counter() - t0:.1f} s")
    card = card_figures(kind)
    phase("device", f"{card['sms']} SMs, max SM clock "
          f"{card['max_sm_clock_mhz']:.0f} MHz: "
          f"{card['int32_ops_per_s'] / 1e12:.2f} T int32 ops/s; "
          f"{card['bytes_per_s'] / 1e12:.2f} TB/s")

    results = kernel_results()
    check_kernels(results, card)
    check_chain(results, card)

    ra = read_aligner_path(results)
    with tempfile.TemporaryDirectory() as tmp:
        pipeline_small(results, Path(tmp) / "small")
        wl = full_workload(Path(tmp) / "full")
        km = kmer_build(wl)
        multi_device(results, ra, km, wl, smi)
        del km
        pipeline_full(results, wl, smi)
    del ra
    with tempfile.TemporaryDirectory() as tmp:
        big_genome(results, Path(tmp) / "big", smi)
    with tempfile.TemporaryDirectory() as tmp:
        chromosomes(results, Path(tmp) / "chroms", smi)
    # every earlier phase's objects are gone before the largest run
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        misassembly_phase(results, Path(tmp) / "masb", smi)

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
