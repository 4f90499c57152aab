"""The read aligner's host split at phase masb's size, for this checkout
and for other checkouts, in turns: each other, this, this, each other in
reverse order.

    python3 scripts/read_split.py [--other DIR ...] [--mb 30.427671]
        [--depth 40] [--seed 3702] [--min-apart 1000000] [--reps 2]
        [--device cuda] [--out DIR]

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory).  Each turn is
a process of its own that imports that checkout's aligngraph_tpu_torch
and makes chip_smoke.py's phase masb workload (make_misassembly_workload
at --mb million bases, --depth, --seed; genome and drafts through FASTA
and the formalizers, the reads in memory).  It then runs, on --device:

  1. the read align of every pair alone, --reps times, on the seed index
     and ReadAligner that run_pipeline's alignment stage builds;
  2. the alignment stage as run_pipeline runs it (driver._align: the
     index, then the read and the contig aligner on two host threads).

The same wrappers time the host in every checkout: the wait for a
batch's result (read_aligner._wait), the rest of ReadAligner._decode
(the host decode, or the copy of a batch's records out of its block) and
the concatenation of the batches (np.concatenate called from align
itself, outside _decode).  On CUDA, events around each align give the
card's span, and events around each ReadAligner._enqueue the sum of the
batches' spans (each batch's first device op to its last: an upper bound
on the card's busy time).  Each turn prints one JSON line: the walls,
those host seconds, ReadAligner.split where the checkout has it,
ReadAligner.transfer, the record count and the sha256 of every
PairAlignments field's bytes, then the stage's wall and
stats["alignment_threads"].  Every align of every turn must give the same
records.  Then the card's name and power limit.  Writes
DIR/read_split.json when --out is given.

CPU, small: --device cpu --mb 0.2 --depth 5 --min-apart 50000 (~20 s a
turn).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

WORKER = r"""
import collections, dataclasses, hashlib, json, sys, tempfile, time
from pathlib import Path
root, device = sys.argv[1], sys.argv[2]
mb, depth, seed, min_apart, reps = (float(sys.argv[3]), float(sys.argv[4]),
                                    int(sys.argv[5]), int(sys.argv[6]),
                                    int(sys.argv[7]))
sys.path.insert(0, root)
import numpy as np
import torch
from aligngraph_tpu_torch import (Config, Reads, formalize_contigs,
                                  formalize_genome)
from aligngraph_tpu_torch.align import read_aligner as ra
from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.ops.seeding import build_index
from aligngraph_tpu_torch.pipeline import driver
from aligngraph_tpu_torch.workload import (make_misassembly_workload,
                                           write_misassembly_fasta)
assert ra.__file__.startswith(root), ra.__file__
cuda = torch.device(device).type == "cuda"
host = collections.Counter()
spans = []
inside = [0]
wait, decode, enqueue = ra._wait, ra.ReadAligner._decode, \
    ra.ReadAligner._enqueue


def sync():
    if cuda:
        torch.cuda.synchronize()


def event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def timed_wait(ev):
    t0 = time.perf_counter()
    wait(ev)
    host["wait_s"] += time.perf_counter() - t0


def timed_decode(self, *args, **kw):
    inside[0] += 1
    t0 = time.perf_counter()
    try:
        return decode(self, *args, **kw)
    finally:
        inside[0] -= 1
        host["decode_total_s"] += time.perf_counter() - t0


def timed_enqueue(self, *args, **kw):
    if not cuda:
        return enqueue(self, *args, **kw)
    a = event()
    out = enqueue(self, *args, **kw)
    spans.append((a, event()))
    return out


class TimedNumpy:
    # read_aligner's numpy, with the concatenations that align makes
    # itself (outside _decode) timed
    def __getattr__(self, name):
        return getattr(np, name)

    def concatenate(self, *args, **kw):
        if inside[0]:
            return np.concatenate(*args, **kw)
        t0 = time.perf_counter()
        out = np.concatenate(*args, **kw)
        host["concat_s"] += time.perf_counter() - t0
        return out


ra._wait = timed_wait
ra.ReadAligner._decode = timed_decode
ra.ReadAligner._enqueue = timed_enqueue
ra.np = TimedNumpy()


def host_split():
    out = dict(wait_s=host["wait_s"],
               decode_s=host["decode_total_s"] - host["wait_s"],
               concat_s=host["concat_s"])
    host.clear()
    return out


def hashes(res):
    return {f.name: hashlib.sha256(np.ascontiguousarray(
        getattr(res, f.name)).tobytes()).hexdigest()
        for f in dataclasses.fields(PairAlignments)}


def batch_ms():
    sync()
    ms = sum(a.elapsed_time(b) for a, b in spans) if cuda else None
    spans.clear()
    return ms


with tempfile.TemporaryDirectory() as tmp:
    work = Path(tmp)
    t0 = time.perf_counter()
    wl = make_misassembly_workload(round(mb * 1e6), depth, seed,
                                   min_apart=min_apart)
    write_misassembly_fasta(work, wl)
    reads = Reads(len(wl["lens"]), wl["data"].shape[1], wl["data"],
                  wl["lens"])
    del wl
    cfg = Config(read1="-", read2="-", contig=str(work / "contigs.fa"),
                 genome=str(work / "genome.fa"), distance_low=300,
                 distance_high=700, part=1,
                 extended_contig=str(work / "extended.fa"),
                 remaining_contig=str(work / "remaining.fa"),
                 work_dir=str(work / "tmp"))
    contigs = formalize_contigs(cfg.contig)
    genome = formalize_genome(cfg.genome, cfg.part)
    cfg.validate(max_read_length=reads.max_read_length or None)
    gseq = np.asarray(genome.seq, np.int8)
    setup = time.perf_counter() - t0

    sync()
    t0 = time.perf_counter()
    aligner = ra.ReadAligner.from_index(
        gseq, build_index(gseq, cfg.seed_len, device=device), cfg,
        device=device)
    sync()
    index_s = time.perf_counter() - t0
    aligns, digest, n = [], None, None
    for _ in range(reps):
        host.clear()
        spans.clear()
        sync()
        a = event() if cuda else None
        t0 = time.perf_counter()
        res = aligner.align(reads)
        sync()
        wall = time.perf_counter() - t0
        span = a.elapsed_time(event()) if cuda else None
        h = hashes(res)
        if digest is not None and (h, res.n) != (digest, n):
            raise SystemExit("an align's records differ from the first's")
        digest, n = h, res.n
        del res
        aligns.append(dict(
            wall_s=wall, device_span_ms=span, batch_spans_ms=batch_ms(),
            host=host_split(), split=getattr(aligner, "split", None),
            transfer=dict(aligner.transfer)))
    del aligner

    stats = {}
    host.clear()
    spans.clear()
    sync()
    t0 = time.perf_counter()
    rali, cali = driver._align(cfg, reads, contigs, genome, gseq, stats,
                               device)
    sync()
    stage = dict(wall_s=time.perf_counter() - t0, batch_spans_ms=batch_ms(),
                 host=host_split(), threads=stats["alignment_threads"],
                 placements=cali.n)
    if (hashes(rali), rali.n) != (digest, n):
        raise SystemExit("the alignment stage's records differ from the "
                         "align's")
print(json.dumps({
    "root": root, "device": device, "setup_s": setup, "index_s": index_s,
    "pairs": reads.n_pairs, "records": n, "aligns": aligns, "stage": stage,
    "sha256": digest}), flush=True)
"""


def run_turn(root: Path, args) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", WORKER, str(root), args.device, str(args.mb),
         str(args.depth), str(args.seed), str(args.min_apart),
         str(args.reps)],
        capture_output=True, text=True, cwd=root)
    if out.returncode:
        sys.stderr.write(out.stderr[-8000:])
        raise SystemExit(f"turn in {root} failed ({out.returncode})")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--mb", type=float, default=30.427671)
    ap.add_argument("--depth", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=3702)
    ap.add_argument("--min-apart", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    others = [p.resolve() for p in args.other]
    turns = [*others, HERE, HERE, *reversed(others)] if others else [HERE]
    lines = [run_turn(root, args) for root in turns]
    same = {json.dumps([x["records"], x["sha256"]]) for x in lines}
    if len(same) != 1:
        raise SystemExit(f"turns differ in their records: {sorted(same)}")
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "read_split.json").write_text(json.dumps(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
