"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises (non-zero exit):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles aligngraph_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels: each hand-written kernel against its plain PyTorch version
     on the same CUDA tensors, at the read aligner's shapes (L 100, pad 16,
     98,304 score lanes; a few thousand dp/traceback lanes; pad 8; ~30%
     indel lanes; rlen-0 lanes).  Everything is integer: tolerance 0.
     CUDA-event times, kernel vs plain.
  4. main path: ReadAligner.build(..., device="cuda").align on the
     benchmark workload (4.6 Mb genome, 100,000 pairs of 100 bp, insert
     500, 1% SNPs, seed 0, batch_pairs 32,768); 3 timed runs after a
     warm-up; every kernel must have launched.
  5. check: align on the first 2,048 pairs on "cuda" and on "cpu" (the
     plain path); every PairAlignments field must be equal.
Then a JSON line of per-kernel results, nvidia-smi's line, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

L_MAIN = 100          # read length of the benchmark workload
PAD_MAIN = 16         # Config.band_pad
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
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def check_kernels(results: dict) -> None:
    from aligngraph_tpu_torch.ops import banded_sw as plain
    from aligngraph_tpu_torch.ops import banded_sw_cuda as k

    rng = np.random.default_rng(0)
    cases = [("L100 pad16 score", B_SCORE, PAD_MAIN, True),
             ("L100 pad16", B_DP, PAD_MAIN, True),
             ("L100 pad8", B_DP, 8, False)]
    for label, B, pad, timed in cases:
        reads, rlens, windows, g0 = (torch.from_numpy(a).cuda() for a in
                                     dp_lanes(rng, B, L_MAIN, pad))
        ref = plain.banded_sw(reads, rlens, windows, pad)
        if B == B_SCORE:
            score = k.sw_score_cuda(reads, rlens, windows, pad)
            torch.cuda.synchronize()
            err = max_err(score, ref.score)
            results["score"]["max_abs_err"] = max(
                results["score"]["max_abs_err"], err)
            if timed:
                results["score"]["ms"] = cuda_ms(
                    lambda: k.sw_score_cuda(reads, rlens, windows, pad), 20)
                results["score"]["plain_ms"] = cuda_ms(
                    lambda: plain.banded_sw(reads, rlens, windows, pad), 2)
            phase("kernels", f"{label}: score lanes {B} max_abs_err {err}")
            continue
        score = k.sw_score_cuda(reads, rlens, windows, pad)
        res = k.banded_sw_cuda(reads, rlens, windows, pad)
        torch.cuda.synchronize()
        err_score = max_err(score, ref.score)
        err_dp = max(max_err(res.score, ref.score),
                     max_err(res.best_i, ref.best_i),
                     max_err(res.best_b, ref.best_b),
                     max_err(res.tb, ref.tb))
        pm_ref = plain.sw_traceback(ref.tb, ref.best_i, ref.best_b, g0, pad)
        tb_k = res.tb.permute(1, 0, 2).contiguous()
        pm = k.sw_traceback_cuda(tb_k, res.best_i, res.best_b, g0, pad)
        torch.cuda.synchronize()
        s_all, pm_all = k.banded_sw_posmap_cuda(reads, rlens, windows, g0,
                                                pad)
        torch.cuda.synchronize()
        err_tb = max(max_err(pm, pm_ref), max_err(s_all, ref.score),
                     max_err(pm_all, pm_ref))
        # the two-pass fast path against the plain composition
        smin = torch.full_like(rlens, 20)
        s_f, pm_f = k.banded_sw_posmap_fast(reads, rlens, windows, g0, pad,
                                            smin=smin)
        s_p, pm_p = plain.banded_sw_posmap_plain(reads, rlens, windows, g0,
                                                 pad, smin=smin)
        torch.cuda.synchronize()
        err_fast = max(max_err(s_f, s_p), max_err(pm_f, pm_p))
        for name, err in (("score", err_score), ("dp", err_dp),
                          ("traceback", max(err_tb, err_fast))):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
        if timed:
            results["dp"]["ms"] = cuda_ms(
                lambda: k.sw_dp_cuda(reads, rlens, windows, pad), 20)
            results["dp"]["plain_ms"] = cuda_ms(
                lambda: plain.banded_sw(reads, rlens, windows, pad), 2)
            results["traceback"]["ms"] = cuda_ms(
                lambda: k.sw_traceback_cuda(tb_k, res.best_i, res.best_b,
                                            g0, pad), 20)
            results["traceback"]["plain_ms"] = cuda_ms(
                lambda: plain.sw_traceback(ref.tb, ref.best_i, ref.best_b,
                                           g0, pad), 2)
        n_indel_need = int((ref.score > plain.gapless_diag(
            reads, rlens, windows, pad)[0]).sum())
        phase("kernels", f"{label}: lanes {B} (gapped best {n_indel_need}) "
              f"max_abs_err score {err_score} dp {err_dp} traceback "
              f"{err_tb} fast-path {err_fast}")
    bad = {n: r["max_abs_err"] for n, r in results.items()
           if r["max_abs_err"] != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    for n, r in results.items():
        phase("kernels", f"{KERNEL_NAMES[n]}: {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms")


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

    from aligngraph_tpu_torch import Config, ReadAligner, Reads
    from aligngraph_tpu_torch.ops import _build
    from aligngraph_tpu_torch.ops import banded_sw_cuda as k
    from aligngraph_tpu_torch.ops.seeding import build_index
    from aligngraph_tpu_torch.workload import make_workload

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", f"nvcc built and loaded {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")

    results = {n: {"name": KERNEL_NAMES[n], "route": "cuda",
                   "source": SOURCE, "replaces": REPLACES[n], "launches": 0,
                   "max_abs_err": 0, "ms": None, "plain_ms": None}
               for n in ("score", "dp", "traceback")}
    check_kernels(results)

    # --- main path: what bench.py runs
    n_pairs, batch = 100_000, 32_768
    ref, data, lens = make_workload(n_pairs=n_pairs)
    reads = Reads(n_pairs, data.shape[1], data, lens)
    cfg = Config(distance_low=100, distance_high=900)
    t0 = time.perf_counter()
    index = build_index(ref, cfg.seed_len)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aligner = ReadAligner.from_index(ref, index, cfg, batch_pairs=batch,
                                     device="cuda")
    torch.cuda.synchronize()
    phase("main", f"index build (host) {index_s:.2f} s, to device "
          f"{time.perf_counter() - t0:.2f} s; bucket table "
          f"{aligner.index.bucket_lo.numel()} int32, suffix_bits "
          f"{aligner.index.suffix_bits}")
    t0 = time.perf_counter()
    aligner.align(Reads(batch, data.shape[1], data[:2 * batch],
                        lens[:batch]))
    tail = n_pairs % batch
    aligner.align(Reads(tail, data.shape[1], data[:2 * tail], lens[:tail]))
    torch.cuda.synchronize()
    phase("main", f"warm-up {time.perf_counter() - t0:.2f} s")

    k.reset_launches()
    walls, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        res = aligner.align(reads)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(res)
    launches = dict(k.LAUNCHES)
    for n, r in results.items():
        r["launches"] = launches[n]
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    for other in outs[1:]:
        for f in FIELDS:
            if not np.array_equal(getattr(other, f), getattr(outs[0], f)):
                raise AssertionError(f"align is not deterministic: {f}")
    res = outs[0]
    aligned = 2 * len(np.unique(res.pair_id))
    share = aligned / (2 * n_pairs)
    med = statistics.median(walls)
    phase("main", f"walls {[round(w, 4) for w in walls]} s; median "
          f"{med:.4f} s, min {min(walls):.4f} s; aligned reads/s median "
          f"{aligned / med:.1f}, best {aligned / min(walls):.1f}; aligned "
          f"{aligned}/{2 * n_pairs} ({share:.4f}); records {res.n}; "
          f"launches {launches}; lanes {dict(k.LANES)}")
    if not share > 0.9:
        raise AssertionError(f"aligned share {share:.4f} <= 0.9")
    if res.pos_map.shape != (res.n, 2, L_MAIN):
        raise AssertionError(f"pos_map shape {res.pos_map.shape}")

    # --- the CUDA path against the plain CPU path on 2,048 pairs
    n_chk = 2048
    sub = Reads(n_chk, data.shape[1], data[:2 * n_chk], lens[:n_chk])
    t0 = time.perf_counter()
    got = aligner.align(sub)
    cpu = ReadAligner.from_index(ref, index, cfg, batch_pairs=batch,
                                 device="cpu").align(sub)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(cpu, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"cuda != cpu on field {f}")
    phase("check", f"cuda == cpu on {n_chk} pairs, {got.n} records, every "
          f"field ({time.perf_counter() - t0:.1f} s)")

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
