"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises (non-zero exit):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit, the SM count and the maximum SM clock.
  2. build: compiles aligngraph_tpu_torch/csrc/*.cu with nvcc (sm_90a) and
     the C++ traversal and FASTA parser with g++, all into
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
     L.
  5. check: align on the first 2,048 pairs on "cuda" and on "cpu" (the
     plain path); every PairAlignments field must be equal.
  6. pipeline small: tests/test_pipeline.py's sim (seed 42, 30 kb, 3,000
     pairs, 10 contigs) through the CLI (aligngraph_tpu_torch.__main__.main)
     on "cuda" and on "cpu", with --misassemblyRemoval and with --part 2
     --iterativeMap: the extended, remaining and corrected FASTA and every
     tmp/ stage file byte-equal, every kernel launched on "cuda" in the
     first; the CLI's k-mer build on the device on "cuda" and on the
     host on "cpu", so the bytes hold the two builds equal; Eval of the
     extended contigs on both devices equal.
  kmer: the device k-mer layer build on bench_pipeline.py's workload
     (seed 7, 4.6 Mb, depth 25 = 575,000 pairs of 100 bp, 1,424 draft
     contigs, distance 300-700, one part): both aligners on "cuda" as the
     driver runs them, the contig layer, then the first 4 chunks of
     16,384 accepted records through the host oracle (build_kmer_layer,
     numpy) and through build_kmer_layer_device on "cuda": every k-mer
     and edge array and every build statistic equal; both walls and the
     peak device memory.  Then the device build over all accepted
     records (stats equal to HOST_KMER_STATS), split by CUDA events
     (normalize = phase 0's duplicate skip on the host, h2d = each chunk's
     phase 0 rows and their upload, emit = emission and expansion, group,
     rounds, edges, d2h), and one chunk's wall, device busy time and top
     10 CUDA ops under torch.profiler.
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
     path of python3 -m aligngraph_tpu_torch.bigscale) on "cuda" at 32 Mb,
     20x (3,200,000 pairs), --part 2, seed 11, graph_build="device",
     ratio_check=True, then Eval: walls per stage, peak device memory per
     stage, the k-mer state's bytes (reckoned and allocated), host RSS
     (peak, and per stage its RSS, live heap and named arrays' bytes);
     every kernel launched; every dropped_* 0, extended > 0, Eval MPMB
     0.0, true contigs >= 95% of extended, and the extended contigs, Eval
     and the k-mer stats equal to the recorded BIG_EVAL and
     BIG_KMER_STATS (identity to 4 places).  Then the
     read aligner on "cuda" against "cpu" on 2,048 pairs at the run's
     32 Mb index (every field equal), and part 2's device k-mer build (16
     Mb positions, part_offset 16 Mb; the graph after its contig layer and
     the records as run_pipeline hands them to the build) against the
     host oracle on the part's first 4 chunks of 16,384 accepted records:
     all 13 arrays and the stats equal.
Then a JSON line of per-kernel results (launches: the main paths',
run_pipeline then Eval at 4.6 Mb, the CLI at 4.6 Mb, then phase big),
nvidia-smi's line, and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
    return {n: {"name": KERNEL_NAMES[n], "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[n], "launches": 0, "max_abs_err": 0,
                "ms": None, "plain_ms": None, "bound_ms": None,
                "bound_by": None,
                # no PyTorch call computes a banded affine-gap local DP or
                # its traceback
                "library_ms": None, "launches_by_path": {}, "shapes": {}}
            for n in ("score", "dp", "traceback")}


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
    for n, r in results.items():
        main = r["shapes"]["L100 pad16"]
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            r[key] = main[key]
        for label, t in r["shapes"].items():
            phase("kernels", f"{KERNEL_NAMES[n]} {label} ({t['lanes']} "
                  f"lanes): {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} "
                  f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                  f"{t['ops']:.4g} ops, {t['bytes']:.4g} B), "
                  f"{t['bound_ms'] / t['ms']:.3f} of it")


def counted(fn):
    """fn() with every kernel count set to 0 just before it -> (fn's
    result, launches, lanes, by_L) read just after; by_L maps "kernel L"
    to {"launches", "lanes"}."""
    from aligngraph_tpu_torch.ops import banded_sw_cuda as k

    k.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(k.LAUNCHES), dict(k.LANES), k.launches_by_length()


def require_launched(path: str, launches: dict, by_l: dict,
                     results: dict) -> None:
    for n, r in results.items():
        r["launches_by_path"][path] = {
            "launches": launches[n],
            **{key.split()[1]: v for key, v in by_l.items()
               if key.split()[0] == n}}
    phase("launches", f"{path}: " + "; ".join(
        f"{key}: {v['launches']} launches, {v['lanes']} lanes"
        for key, v in by_l.items()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the {path} "
                             f"path: {launches}")


def read_aligner_path(results: dict) -> dict:
    """Phases 4-5: the read aligner on the bench.py workload through
    aligngraph_tpu_torch.bench.run (3 timed aligns, which must give the
    same records; the kernels' counts are set to 0 just before them and
    read just after, inside run).  Returns the aligner, the reads, the
    records of the first timed align and the walls."""
    from aligngraph_tpu_torch import ReadAligner, Reads
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

    # the CUDA path against the plain CPU path on 2,048 pairs
    n_chk = 2048
    data, lens = ctx["reads"].data, ctx["reads"].lengths
    sub = Reads(n_chk, data.shape[1], data[:2 * n_chk], lens[:n_chk])
    t0 = time.perf_counter()
    got = ctx["aligner"].align(sub)
    cpu = ReadAligner.build(ctx["ref"], ctx["cfg"], batch_pairs=batch,
                            device="cpu").align(sub)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(cpu, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"cuda != cpu on field {f}")
    phase("check", f"cuda == cpu on {n_chk} pairs, {got.n} records, every "
          f"field ({time.perf_counter() - t0:.1f} s)")
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


def pipeline_small(results: dict, work: Path) -> None:
    """Phase 6: the CLI on cuda and on cpu, with --misassemblyRemoval and
    with --part 2 --iterativeMap."""
    from aligngraph_tpu_torch import __main__ as cli
    from aligngraph_tpu_torch import decode, write_fasta
    from aligngraph_tpu_torch.evaluate.evaluate import evaluate
    from aligngraph_tpu_torch.workload import make_simdata

    target, reference, reads1, reads2, contigs = make_simdata(
        seed=42, genome_len=30_000, n_pairs=3000, read_len=100, insert=500,
        n_contigs=10, snp_rate=0.01, err_rate=0.003)
    work.mkdir()
    write_fasta(work / "genome.fa", ["refchr"], [decode(reference)])
    write_fasta(work / "target.fa", ["chr"], [decode(target)])
    write_fasta(work / "contigs.fa", [f"ctg{i}" for i in range(len(contigs))],
                [decode(c) for c in contigs])
    n = len(reads1)
    for mate, seqs in (("r1", reads1), ("r2", reads2)):
        write_fasta(work / f"{mate}.fa", [f"p{i}" for i in range(n)],
                    [decode(r) for r in seqs])
    base = ["--read1", str(work / "r1.fa"), "--read2", str(work / "r2.fa"),
            "--contig", str(work / "contigs.fa"), "--genome",
            str(work / "genome.fa"), "--distanceLow", "300",
            "--distanceHigh", "700"]
    # (name, flags, files that must be among the outputs); the first run
    # is the path whose launches count, the second covers the per-part
    # aligners
    runs = [("misassembly", ["--misassemblyRemoval"],
             ("extended.fa", "remaining.fa", "corrected_extended.fa",
              "corrected_remaining.fa", "tmp/_initial_contigs.0.fa",
              "tmp/_pre_extended_contigs.0.fa",
              "tmp/_extended_contigs.0.fa")),
            ("part2_iterative", ["--part", "2", "--iterativeMap"],
             ("extended.fa", "remaining.fa", "tmp/_initial_contigs.1.fa",
              "tmp/_pre_extended_contigs.1.fa",
              "tmp/_extended_contigs.1.fa"))]
    cwd = os.getcwd()
    for name, flags, want in runs:
        files, evals = {}, {}
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
            files[dev] = pipeline_files(out)
            evals[dev] = evaluate(work / "target.fa", out / "extended.fa",
                                  device=dev)
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
    from aligngraph_tpu_torch.ops.seeding import build_index

    cfg, reads, genome = wl["cfg"], wl["reads"], wl["genome"]
    k, iv = cfg.k_mer, cfg.insert_variation
    t0 = time.perf_counter()
    gseq = np.asarray(genome.seq, np.int8)
    index = build_index(gseq, cfg.seed_len)
    rali = ReadAligner.from_index(gseq, index, cfg,
                                  device="cuda").align(reads)
    cali = ContigAligner(gseq, cfg, index=index,
                         device="cuda").align(wl["contigs"])
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
    # size of the pipeline's stage): a CUDA event after each stage
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    acc = np.nonzero(rali.ratio_ok(THRESHOLD))[0]
    every = dataclasses.replace(rali, **{
        f.name: getattr(rali, f.name)[acc] for f in dataclasses.fields(rali)})
    g_split = copy.deepcopy(g0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark("start")
    st = kj.build_kmer_layer_device(g_split, every, reads, k, iv,
                                    chunk_records=KMER_CHUNK, device="cuda",
                                    mark=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dataclasses.asdict(st) != HOST_KMER_STATS:
        raise AssertionError(f"full-size device build stats {st} != "
                             f"{HOST_KMER_STATS}")
    split: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    phase("kmer", f"all {every.n} records ({-(-every.n // KMER_CHUNK)} "
          f"chunks): wall {wall:.3f} s; split, CUDA-event ms (normalize is "
          f"phase 0's duplicate skip on the host, the card idle; h2d holds "
          f"each chunk's phase 0 rows): " + ", ".join(
              f"{n} {t:.2f}" for n, t in split.items()))

    # one chunk's update: its wall, then torch.profiler's device time
    rows = np.arange(recs.n)
    skip = kj.phase0_skip(recs, rows, 0, g0.part_len)
    cmpack = kj._cmpack(g0, "cuda")
    args = kj._upload(kj.phase0_rows(recs, rows, reads, k, skip, 0,
                                     KMER_CHUNK, 0, g0.part_len), "cuda")
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
    require_launched("eval", e_launches, e_by_l, results)
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


# phase big: aligngraph_tpu_torch.bigscale at 32 Mb (two 16 Mb parts), 20x
BIG_MB, BIG_DEPTH, BIG_PART = 32.0, 20.0, 2
BIG_CHECK_PAIRS = 2048
# the big run's product, recorded on the H100 (PERF.md), so that any change
# shows.  Eval's identity here is 0.9988, under the 0.999 that the 64.4 Mb
# run (0.99912) and the 4.6 Mb workload (0.9993) reach: it moves with the
# region (0.9981 to 0.9994 over 1 Mb windows of these contigs), and on the
# 1-2 Mb window's share of this workload the JAX package writes the port's
# contigs byte for byte, at 0.9983 (PERF.md; scripts/eval_windows.py,
# scripts/bigscale_window.py)
BIG_EVAL = {"extended": 338, "extended_bases": 31_108_244,
            "n_contigs": 338, "n_true_contigs": 338, "n50": 148_046,
            "covered_length": 31_117_580, "mpmb": 0.0,
            "average_identity": 0.9988}
BIG_KMER_STATS = {"tuples": 303_645_809, "rows": 607_363_419,
                  "groups": 306_737_990, "dropped_rank": 0,
                  "dropped_slots": 0, "dropped_edges": 0}


def big_genome(results: dict, work: Path, smi: str) -> None:
    """Phase big: bigscale.run on "cuda" (the launches of the big-genome
    path), its invariants, the read aligner on cuda against cpu on
    BIG_CHECK_PAIRS pairs at the run's 32 Mb index, and part 2's device
    k-mer build against the host oracle on the part's first KMER_CHUNKS
    chunks of accepted records (graph and records as run_pipeline gave
    them to its build: the driver's build_index and
    build_kmer_layer_device are wrapped for the run to keep them)."""
    import copy
    import dataclasses

    from aligngraph_tpu_torch import ReadAligner, Reads, build_kmer_layer
    from aligngraph_tpu_torch import bigscale
    from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
    from aligngraph_tpu_torch.pipeline import driver

    n_rec = KMER_CHUNKS * KMER_CHUNK
    kept = {"copy_s": 0.0}
    build_index, build_kmer = driver.build_index, driver.build_kmer_layer_device

    def keep_index(*args, **kw):
        kept["index"] = build_index(*args, **kw)
        return kept["index"]

    def keep_part2(g, recs, *args, part_offset, rows, **kw):
        if part_offset:                  # part 2, before its build
            t = time.perf_counter()
            kept.update(g0=copy.deepcopy(g), lo=part_offset,
                        recs=driver._subset_pairs(recs, rows[:n_rec]))
            kept["copy_s"] += time.perf_counter() - t
        return build_kmer(g, recs, *args, part_offset=part_offset,
                          rows=rows, **kw)

    driver.build_index, driver.build_kmer_layer_device = keep_index, keep_part2
    try:
        t0 = time.perf_counter()
        (line1, line2, ctx), launches, lanes, by_l = counted(
            lambda: bigscale.run(BIG_MB, BIG_DEPTH, BIG_PART, device="cuda",
                                 work_dir=str(work)))
        wall = time.perf_counter() - t0
    finally:
        driver.build_index, driver.build_kmer_layer_device = \
            build_index, build_kmer
    require_launched("big", launches, by_l, results)
    for n, r in results.items():
        r["launches"] += launches[n]
    mem = {k: round(v.get("device_peak_bytes", 0) / 2**30, 2)
           for k, v in line1["stage_memory"].items()}
    phase("big", f"{BIG_MB:g} Mb, {BIG_DEPTH:g}x, --part {BIG_PART}: "
          f"{line1['n_pairs']} pairs; setup {line1['setup_seconds']} s, "
          f"run_pipeline {line1['value']} s, stages "
          f"{line1['stage_seconds']} (kmer_build with {kept['copy_s']:.1f} s "
          f"of this phase's copy of part 2), eval {line2['eval_s']} s, "
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
               **{k: line2[k] for k in BIG_EVAL if k in line2},
               **line1["kmer_stats"])
    got["average_identity"] = round(got["average_identity"], 4)
    if got != {**BIG_EVAL, **BIG_KMER_STATS}:
        raise AssertionError(f"big: {got} != the recorded "
                             f"{BIG_EVAL} {BIG_KMER_STATS}")

    # the read aligner on cuda against cpu at the run's 32 Mb index
    cfg, reads, genome = ctx["cfg"], ctx["reads"], ctx["genome"]
    del ctx
    t0 = time.perf_counter()
    gseq = np.asarray(genome.seq, np.int8)
    index = kept.pop("index")
    n = BIG_CHECK_PAIRS
    sub = Reads(n, reads.max_len, reads.data[:2 * n], reads.lengths[:n])
    got = ReadAligner.from_index(gseq, index, cfg, device="cuda").align(sub)
    cpu = ReadAligner.from_index(gseq, index, cfg, device="cpu").align(sub)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(cpu, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"big: cuda != cpu on field {f}")
    del index
    phase("big", f"read aligner cuda == cpu on {n} pairs, {got.n} records, "
          f"every field, the run's index of {len(gseq)} bases "
          f"({time.perf_counter() - t0:.1f} s)")

    # part 2's k-mer build against the host oracle
    g0, recs, lo = kept["g0"], kept["recs"], kept["lo"]
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
            or recs.n != n_rec:
        raise AssertionError(f"big: part 2's device k-mer build != host "
                             f"oracle: fields {bad}, stats {st_dev} vs "
                             f"{st_host}, {recs.n} records")
    phase("big", f"part 2 (offset {lo}, {g0.km_cnt.shape[0]} positions): "
          f"first {recs.n} accepted records, host oracle {host_s:.3f} s, "
          f"device {dev_s:.3f} s; all {len(KM_FIELDS)} fields and the stats "
          f"equal: {dataclasses.asdict(st_dev)}; peak device memory "
          f"{peak / 2**30:.2f} GiB (state {state / 2**30:.2f} GiB)")


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

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
