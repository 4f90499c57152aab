"""The device k-mer build's time split at phase masb's size, for this
checkout and for other checkouts, in turns: each other, this, this, each
other in reverse order.

    python3 scripts/kmer_split.py [--other DIR ...] [--mb 30.427671]
        [--depth 40] [--seed 3702] [--min-apart 1000000] [--device cuda]
        [--out DIR]

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory).  Each turn is
a process of its own that imports that checkout's aligngraph_tpu_torch,
makes chip_smoke.py's phase masb workload (make_misassembly_workload at
--mb million bases, --depth, --seed; genome, target and drafts through
FASTA and the formalizers, the reads in memory) and runs run_pipeline on
it with --part 1 and the device k-mer build, without stage (5).  The
driver's build_kmer_layer_device is wrapped so that each of its `mark`
names closes a span that began at the mark before (the first at the
call): on a CUDA device a CUDA event, on the CPU the host clock; the
spans are summed by name in ms.  Each turn prints one JSON line: the
split, kmer_build's seconds, the stage seconds and the wall, the build's
statistics, the stage's memory record and the sha256 of extended.fa;
every turn must give the same statistics and the same extended.fa.
Then the card's name and power limit.  Writes DIR/kmer_split.json when
--out is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

WORKER = r"""
import dataclasses, hashlib, json, sys, tempfile, time
from pathlib import Path
root, device = sys.argv[1], sys.argv[2]
mb, depth, seed, min_apart = (float(sys.argv[3]), float(sys.argv[4]),
                              int(sys.argv[5]), int(sys.argv[6]))
sys.path.insert(0, root)
import torch
from aligngraph_tpu_torch import (Config, Reads, formalize_contigs,
                                  formalize_genome)
from aligngraph_tpu_torch.pipeline import driver
from aligngraph_tpu_torch.workload import (make_misassembly_workload,
                                           write_misassembly_fasta)
assert driver.__file__.startswith(root), driver.__file__
cuda = torch.device(device).type == "cuda"
spans = {}
build = driver.build_kmer_layer_device

def clock():
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()

def timed_build(*args, mark=None, **kw):
    marks = [("start", clock())]

    def both(name):
        marks.append((name, clock()))
        if mark:
            mark(name)
    out = build(*args, mark=both, **kw)
    if cuda:
        torch.cuda.synchronize()
    for (_, a), (name, b) in zip(marks, marks[1:]):
        ms = a.elapsed_time(b) if cuda else (b - a) * 1e3
        spans[name] = spans.get(name, 0.0) + ms
    return out

driver.build_kmer_layer_device = timed_build
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
                 distance_high=700, part=1, graph_build="device",
                 extended_contig=str(work / "extended.fa"),
                 remaining_contig=str(work / "remaining.fa"),
                 work_dir=str(work / "tmp"))
    contigs = formalize_contigs(cfg.contig)
    genome = formalize_genome(cfg.genome, cfg.part)
    setup = time.perf_counter() - t0
    res = driver.run_pipeline(cfg, reads=reads, contigs=contigs,
                              genome=genome, device=device)
    st = res.stats
    ext = hashlib.sha256((work / "extended.fa").read_bytes()).hexdigest()
print(json.dumps({
    "root": root, "setup_s": setup, "wall_s": res.wall_seconds,
    "kmer_build_s": st["stage_seconds"]["kmer_build"],
    "split_ms": spans, "driver_kmer_split": st.get("kmer_split"),
    "stage_seconds": st["stage_seconds"], "kmer_stats": st["kmer_build"],
    "kmer_memory": st["memory"].get("kmer_build.0"),
    "extended_sha256": ext}), flush=True)
"""


def run_turn(root: Path, args) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", WORKER, str(root), args.device, str(args.mb),
         str(args.depth), str(args.seed), str(args.min_apart)],
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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    others = [p.resolve() for p in args.other]
    turns = [*others, HERE, HERE, *reversed(others)] if others else [HERE]
    lines = [run_turn(root, args) for root in turns]
    same = {json.dumps([x["kmer_stats"], x["extended_sha256"]])
            for x in lines}
    if len(same) != 1:
        raise SystemExit(f"turns differ in k-mer stats or extended.fa: "
                         f"{sorted(same)}")
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "kmer_split.json").write_text(json.dumps(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
