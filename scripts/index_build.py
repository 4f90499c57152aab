"""One genome-sized seed-index build: its time, its peak device bytes and
its device time by op.

    python3 scripts/index_build.py [--mb 30.427671] [--seed 3702]
        [--seed-len 13] [--reps 3] [--device cuda] [--out DIR]

The genome is phase masb's target (chip_smoke.py: the first draw of
workload.make_misassembly_workload at MASB_SEED, 30,427,671 bases at the
default --mb).  ops/seeding.build_index runs on --device --reps times
after one warm-up call: the host wall of each call and, on a CUDA
device, its CUDA-event ms and its peak device bytes above what was
allocated before it.  One more call runs under torch.profiler: the time
of its kernels summed by the op that launched them (self device time;
self host time on the CPU).  Every build is held to a CPU build of the
same codes, field for field.

Prints one JSON line (and writes DIR/index_build.json); raises without a
CUDA device when --device is cuda.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aligngraph_tpu_torch.ops.seeding import build_index  # noqa: E402

FIELDS = ("sorted_kmers", "sorted_posflip", "bucket_lo")
SCALARS = ("search_steps", "suffix_bits", "seed_len", "genome_len")


def masb_target(n: int, seed: int) -> np.ndarray:
    """make_misassembly_workload's target: its first draw."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, n).astype(np.int8)


def check(got, want) -> None:
    for f in FIELDS:
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"{f} differs from the CPU build")
    for f in SCALARS:
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{f} {getattr(got, f)} != "
                                 f"{getattr(want, f)}")


def timed_call(codes, seed_len, dev) -> tuple:
    """One build_index call -> (its figures, the index)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    t = time.perf_counter()
    idx = build_index(codes, seed_len, device=dev)
    out = {}
    if cuda:
        b.record()
        torch.cuda.synchronize()
        out["ms"] = a.elapsed_time(b)
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["wall_s"] = time.perf_counter() - t
    return out, idx


def op_split(codes, seed_len, dev) -> dict:
    """One build_index call under torch.profiler -> aten op -> {"ms",
    "calls"}, the ops whose own kernels (own host time on the CPU) took
    any time, longest first.  The kernels' and the profiler's own entries
    are left out: their time is already their op's."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        build_index(codes, seed_len, device=dev)
        if cuda:
            torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if not e.key.startswith("aten::"):
            continue
        us = (getattr(e, "self_device_time_total", None)
              if cuda else e.self_cpu_time_total)
        if us is None:                      # torch before 2.4
            us = e.self_cuda_time_total
        if us > 0:
            ops[e.key] = {"ms": us / 1e3, "calls": e.count}
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]["ms"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=30.427671)
    ap.add_argument("--seed", type=int, default=3702)
    ap.add_argument("--seed-len", type=int, default=13)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("index_build --device cuda needs a CUDA device "
                           "and none is available")
    n = int(round(args.mb * 1e6))
    codes = masb_target(n, args.seed)
    report = dict(genome_len=n, seed_len=args.seed_len, device=str(dev),
                  torch=torch.__version__)
    if dev.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    want = build_index(codes, args.seed_len, device="cpu")
    report["cpu_build_s"] = time.perf_counter() - t
    report["kmers"] = int(want.sorted_kmers.shape[0])
    report["suffix_bits"] = want.suffix_bits
    report["index_bytes"] = want.nbytes
    calls = []
    for _ in range(args.reps + 1):        # the first call warms up
        figures, idx = timed_call(codes, args.seed_len, dev)
        check(idx, want)
        del idx
        calls.append(figures)
    report["warm_up"], report["calls"] = calls[0], calls[1:]
    report["ops"] = op_split(codes, args.seed_len, dev)
    line = json.dumps(report)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "index_build.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
