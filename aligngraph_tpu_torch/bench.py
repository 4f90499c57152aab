"""Benchmark: aligned reads/s of the PE read aligner on one CUDA device,
bench.py on the port.

    python3 -m aligngraph_tpu_torch.bench

The environment sets the size, as for bench.py: BENCH_PAIRS (default
100,000 pairs), BENCH_GENOME (4,600,000 bases), BENCH_BATCH (32,768 pairs
a device batch).  The workload is bench.py's (workload.make_workload,
seed 0: a random genome, a reference with 1% SNPs, 100 bp reads at a
500 bp insert with 0.3% errors) under Config(distance_low=100,
distance_high=900).  After the index build, a warm-up (one batch, the
tail batch, warm_heap(1 << 30)), five timed ReadAligner.align calls,
each ending in a device synchronise; the five must give the same records.

Prints ONE JSON line on stdout, bench.py's:
  {"metric": "aligned_reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": R}
value is the aligned reads over the fastest of the five walls, as in
bench.py.  vs_baseline is value over BOWTIE2_8T_BASELINE, bench.py's
constant for bowtie2 on 8 CPU threads (a documented order of magnitude,
not a measurement): it compares the card with that CPU aligner, not with
any other accelerator.

On stderr, a "#" line with what bench.py prints there (total and aligned
reads, the wall, the walls, the index build, the warm-up, the records),
the median wall and the aligned reads/s at the median, the launches and
lanes of each hand-written kernel over the timed aligns (by kernel and
read length, banded_sw_cuda.LAUNCHES_BY_L), the device and the card's
name and power limit; and on CUDA a second "#" line with each kernel's
device milliseconds over one more align under torch.profiler.

There is no fallback to the CPU: without a CUDA device it raises.  From
Python, main(device="cpu") runs the same on the CPU (the kernels' plain
versions), and run(...) returns the numbers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.bigscale import nvidia_smi
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.ops import banded_sw_cuda
from aligngraph_tpu_torch.utils.hostmem import warm_heap
from aligngraph_tpu_torch.workload import make_workload

BOWTIE2_8T_BASELINE = 1.0e5   # reads/s, bench.py's constant (see above)
KERNEL_NAMES = {"score": "sw_score_kernel", "dp": "sw_dp_kernel",
                "traceback": "sw_traceback_kernel"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_device_ms(aligner: ReadAligner, reads: Reads,
                     dev: torch.device) -> dict:
    """One more align under torch.profiler -> kernel -> {"device_ms": the
    summed device time of its launches, "events": the profiler's events
    of it, "launches": its launch count in that align}."""
    from torch.profiler import ProfilerActivity, profile

    banded_sw_cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        aligner.align(reads)
        _sync(dev)
    out = {}
    for name, kname in KERNEL_NAMES.items():
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kname in e.name]
        out[name] = {"device_ms": sum(e.time_range.end - e.time_range.start
                                      for e in evs) / 1e3,
                     "events": len(evs),
                     "launches": banded_sw_cuda.LAUNCHES[name]}
    return out


def same_records(a: PairAlignments, b: PairAlignments) -> bool:
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def run(n_pairs: int = 100_000, genome_len: int = 4_600_000,
        batch: int = 32_768, *, repeats: int = 5, device="cuda"):
    """The benchmark -> (report, ctx).  report: "line" (the JSON line's
    dict) and the numbers of the "#" lines; ctx: the aligner, the reads,
    the reference and the records of the first timed align."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the read-aligner benchmark needs a CUDA device "
                           "and none is available")
    ref, data, lens = make_workload(genome_len=genome_len, n_pairs=n_pairs)
    reads = Reads(n_pairs, data.shape[1], data, lens)
    cfg = Config(distance_low=100, distance_high=900)
    t0 = time.perf_counter()
    aligner = ReadAligner.build(ref, cfg, batch_pairs=batch, device=dev)
    _sync(dev)
    index_s = time.perf_counter() - t0

    # warm-up: the kernels' build and first launches on a full batch and
    # on the tail batch's smaller shape, and warm host heap pages
    # (utils/hostmem.py), so that the timed aligns are steady
    warm_heap(1 << 30)
    t0 = time.perf_counter()
    nw = min(batch, n_pairs)
    aligner.align(Reads(nw, reads.max_len, data[:2 * nw], lens[:nw]))
    tail = n_pairs % batch
    if tail:
        aligner.align(Reads(tail, reads.max_len, data[:2 * tail],
                            lens[:tail]))
    _sync(dev)
    warm_s = time.perf_counter() - t0

    banded_sw_cuda.reset_launches()
    walls, first = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = aligner.align(reads)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        if first is None:
            first = res
        elif not same_records(res, first):
            raise AssertionError("align is not deterministic: a timed "
                                 "align's records differ from the first's")
    by_l = banded_sw_cuda.launches_by_length()
    launches, lanes = dict(banded_sw_cuda.LAUNCHES), \
        dict(banded_sw_cuda.LANES)

    aligned = 2 * len(np.unique(first.pair_id))
    best, med = min(walls), statistics.median(walls)
    report = dict(
        line={"metric": "aligned_reads_per_s_per_chip",
              "value": round(aligned / best, 1), "unit": "reads/s",
              "vs_baseline": round(aligned / best / BOWTIE2_8T_BASELINE, 2)},
        total_reads=2 * n_pairs, aligned=aligned, records=first.n,
        walls=walls, wall=best, median=med, rps_median=aligned / med,
        index_s=index_s, warm_s=warm_s, launches=launches, lanes=lanes,
        launches_by_l=by_l, device=str(dev),
        card=nvidia_smi() if dev.type == "cuda" else None,
        kernel_ms=kernel_device_ms(aligner, reads, dev)
        if dev.type == "cuda" else None)
    return report, dict(aligner=aligner, reads=reads, ref=ref, cfg=cfg,
                        records=first)


def main(device="cuda") -> int:
    rep, _ = run(int(os.environ.get("BENCH_PAIRS", 100_000)),
                 int(os.environ.get("BENCH_GENOME", 4_600_000)),
                 int(os.environ.get("BENCH_BATCH", 32_768)), device=device)
    print(json.dumps(rep["line"]), flush=True)
    total, aligned = rep["total_reads"], rep["aligned"]
    print(f"# total_reads={total} aligned={aligned} "
          f"({aligned / total:.1%}) wall={rep['wall']:.4f}s "
          f"walls={[round(w, 4) for w in rep['walls']]} "
          f"median={rep['median']:.4f}s "
          f"rps_median={rep['rps_median']:.1f} "
          f"index_build={rep['index_s']:.2f}s warmup={rep['warm_s']:.2f}s "
          f"records={rep['records']} launches_by_L="
          f"{json.dumps(rep['launches_by_l'])} device={rep['device']} "
          f"card={rep['card']}", file=sys.stderr, flush=True)
    if rep["kernel_ms"] is not None:
        print("# kernel device ms over one more align (torch.profiler): "
              + "; ".join(f"{KERNEL_NAMES[n]} {k['device_ms']:.4f} ms in "
                          f"{k['events']} events, {k['launches']} launches"
                          for n, k in rep["kernel_ms"].items()),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
