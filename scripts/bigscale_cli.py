"""The big-genome workload through the CLI from FASTA files: the reads of
aligngraph_tpu_torch.bigscale's run written as r1.fa and r2.fa, then
`python3 -m aligngraph_tpu_torch` on them, to compare with bigscale's
in-memory run of the same data.

    python3 scripts/bigscale_cli.py [genome_mb] [depth] [part]
        [--dir D] [--device cuda|cpu]

Defaults 64.4 Mb, 20x, --part 2 and D = $BIGSCALE_DIR.  It makes
workload.make_bigscale_workload(genome_mb, depth) (seed 11) and writes
into D genome.fa, target.fa and contigs.fa as bigscale.run writes them,
and the reads (pair i named p{i}, workload.write_reads_fasta); frees the
workload; then runs the CLI's main in D/cli (work dir D/cli/tmp) with
bigscale's settings: distance 300-700, --part, --ratioCheck, and the
k-mer build of the CLI's rule (the device build on CUDA).  Past
stream_reads_threshold (2^28 bytes of FASTA) formalize_reads fills a
memmap under the work dir.

Prints one JSON line: the seconds of the workload, of writing the FASTA
files, of formalizing the inputs (stats["formalize_seconds"]), of
run_pipeline and of the whole CLI call; the FASTA bytes and whether the
reads went through the memmap; the k-mer build; the peak host RSS of the
process (ru_maxrss, after the workload was freed it is the CLI's) and per
stage run_pipeline's memory record (RSS, live heap, peak device bytes);
the extended contigs and the sha256 of extended.fa; and, when D holds an
extended.fa of bigscale's run (BIGSCALE_DIR=D python3 -m
aligngraph_tpu_torch.bigscale ...), whether the CLI's equals it byte for
byte.  The card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aligngraph_tpu_torch import workload  # noqa: E402
from aligngraph_tpu_torch.__main__ import main as cli  # noqa: E402
from aligngraph_tpu_torch.bigscale import nvidia_smi  # noqa: E402
from aligngraph_tpu_torch.io.fasta import decode, write_fasta  # noqa: E402
from aligngraph_tpu_torch.utils import heap  # noqa: E402
from chip_smoke import pipeline_results  # noqa: E402


def write_inputs(d: Path, gmb: float, depth: float) -> dict:
    """The workload's five FASTA files in d -> their seconds and bytes."""
    t0 = time.time()
    target, ref, data, lens, contig_seqs = workload.make_bigscale_workload(
        int(gmb * 1e6), depth)
    made = time.time() - t0
    t0 = time.time()
    write_fasta(d / "genome.fa", ["chr"], [decode(ref)])
    write_fasta(d / "target.fa", ["chr"], [decode(target)])
    write_fasta(d / "contigs.fa",
                [f"c{i}" for i in range(len(contig_seqs))],
                [decode(c) for c in contig_seqs])
    workload.write_reads_fasta(d, data, lens)
    return dict(n_pairs=len(lens), workload_seconds=made,
                write_seconds=time.time() - t0,
                read_fasta_bytes=sum((d / f).stat().st_size
                                     for f in ("r1.fa", "r2.fa")))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("genome_mb", type=float, nargs="?", default=64.4)
    ap.add_argument("depth", type=float, nargs="?", default=20.0)
    ap.add_argument("part", type=int, nargs="?", default=2)
    ap.add_argument("--dir", default=os.environ.get("BIGSCALE_DIR"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.dir:
        ap.error("give --dir or set BIGSCALE_DIR")
    d = Path(args.dir).resolve()
    out = d / "cli"
    out.mkdir(parents=True, exist_ok=True)
    line = dict(genome_mb=args.genome_mb, depth=args.depth, part=args.part,
                device=args.device, **write_inputs(d, args.genome_mb,
                                                   args.depth))
    heap.trim()

    argv_cli = ["--read1", str(d / "r1.fa"), "--read2", str(d / "r2.fa"),
                "--contig", str(d / "contigs.fa"),
                "--genome", str(d / "genome.fa"), "--distanceLow", "300",
                "--distanceHigh", "700", "--part", str(args.part),
                "--ratioCheck", "--extendedContig", str(out / "extended.fa"),
                "--remainingContig", str(out / "remaining.fa")]
    cwd = os.getcwd()
    os.chdir(out)                       # the CLI's work dir is ./tmp
    t0 = time.time()
    try:
        with pipeline_results() as kept:
            rc = cli(argv_cli, device=args.device)
    finally:
        os.chdir(cwd)
    cli_s = time.time() - t0
    res = kept[0]
    ext = (out / "extended.fa").read_bytes()
    theirs = d / "extended.fa"
    line.update(
        rc=rc, cli_seconds=cli_s, pipeline_seconds=res.wall_seconds,
        formalize_seconds=res.stats["formalize_seconds"],
        reads_memmap=(out / "tmp" / "_reads.npy").exists(),
        graph_build=res.stats["graph_build"],
        stage_seconds=res.stats["stage_seconds"],
        kmer_stats=res.stats["kmer_build"],
        aligned_pair_fraction=res.stats.get("aligned_pair_fraction"),
        max_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        * 1024,
        stage_memory={k: {m: v.get(m) for m in (
            "host_max_rss_bytes", "host_rss_bytes", "host_heap_bytes",
            "device_peak_bytes")} for k, v in res.stats["memory"].items()},
        extended=len(res.extended_ids),
        extended_bases=int(sum(len(s) for s in res.extended_seqs)),
        extended_sha256=hashlib.sha256(ext).hexdigest(),
        equal_to_bigscale=(theirs.read_bytes() == ext
                           if theirs.exists() else None),
        card=nvidia_smi() if args.device == "cuda" else None)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
