"""The big-genome run: scripts/bigscale_run.py's run (configs 3/4 of
BASELINE.json: a genome of tens to hundreds of Mb at 20x, cut into parts
with --part) on the port.

    python3 -m aligngraph_tpu_torch.bigscale [genome_mb] [depth] [part]

Defaults 200 Mb, 20x, --part 2, as the script's.  The workload is
workload.make_bigscale_workload (seed 11): the reads stay in memory, the
reference, the target and the draft contigs go through FASTA files under
$BIGSCALE_DIR (default: a temp dir, removed at the end) and the
formalizers.  The config is the script's (distance 300-700, --part) with
graph_build="device" and ratio_check=True.  run_pipeline runs on the
card, then Eval of extended.fa against the target.

Prints the script's two JSON lines with its keys.  The first adds the
alignment stage's split (the index build, the read and the contig
threads: stats["alignment_threads"] of run_pipeline) and the run's
memory: the peak device bytes of the whole run and of each stage, and
at each stage's end the host RSS, the live heap and the bytes of the
large host arrays by name (stats["memory"] of run_pipeline), the host
seed index's bytes and the seconds of the heap trims between stages,
the k-mer state's bytes per part as kmer_layer_jit.state_bytes reckons
them and as the card allocated them, and per position; the peak host
RSS, the host's RAM, and the card's name and power limit as nvidia-smi
gives them.  The second adds Eval's peak
device bytes.

Before it makes the data, and again on the formalized genome's parts, it
raises MemoryError when the largest part's k-mer state and the build's
working reserve (KMER_RESERVE_BYTES) exceed the card's memory.  There is no fallback to the CPU: without a CUDA device it
raises.  From Python, main(argv, device="cpu") runs the same on the CPU,
and run(...) returns the two lines, the pipeline's result and its
inputs.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.graph.kmer_layer_jit import state_bytes
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import (Reads, formalize_contigs,
                                               formalize_genome)
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.utils.hostmem import warm_heap
from aligngraph_tpu_torch.workload import make_bigscale_workload

READ_LEN = 100
# device bytes the k-mer build needs beside its state: one chunk's working
# set and the largest field's upload
KMER_RESERVE_BYTES = 8 << 30


def part_positions(part_len: int) -> int:
    """The position axis GraphTensors.create gives a part: part_len plus
    its overflow segment."""
    return part_len + max(1024, part_len // 10)


def check_state_fits(part_lens, device) -> list:
    """The k-mer state bytes of parts of part_lens bases (state_bytes); on
    a CUDA device, raises MemoryError when the largest with
    KMER_RESERVE_BYTES exceeds the card's memory."""
    need = [state_bytes(part_positions(int(n))) for n in part_lens]
    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        if max(need) + KMER_RESERVE_BYTES > total:
            raise MemoryError(
                f"a part's k-mer state takes {max(need) / 2**30:.1f} GiB "
                f"and the build {KMER_RESERVE_BYTES / 2**30:.0f} GiB more; "
                f"the card has {total / 2**30:.1f} GiB: use a larger "
                f"--part")
    return need


def nvidia_smi() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def host_ram_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def json_value(v):
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


def run(gmb: float, depth: float, part: int, *, device, work_dir):
    """The whole run in work_dir -> (first JSON line's dict, second's,
    {"result": the PipelineResult, "reads", "genome", "cfg": its
    inputs})."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the big-genome run needs a CUDA device and none "
                           "is available")
    glen = int(gmb * 1e6)
    n_pairs = int(depth * glen / (2 * READ_LEN))
    d = Path(work_dir)
    # before the data: the largest part formalize_genome cuts from glen
    check_state_fits([glen - (part - 1) * (glen // part)], dev)
    warm_heap(1 << 30)
    t0 = time.time()
    target, ref, data, lens, contig_seqs = make_bigscale_workload(glen,
                                                                  depth)
    reads = Reads(n_pairs, READ_LEN, data, lens)
    d.mkdir(parents=True, exist_ok=True)
    write_fasta(d / "genome.fa", ["chr"], [decode(ref)])
    write_fasta(d / "target.fa", ["chr"], [decode(target)])
    write_fasta(d / "contigs.fa",
                [f"c{i}" for i in range(len(contig_seqs))],
                [decode(c) for c in contig_seqs])
    del target, ref, contig_seqs
    cfg = Config(read1="-", read2="-", contig=str(d / "contigs.fa"),
                 genome=str(d / "genome.fa"), distance_low=300,
                 distance_high=700, part=part,
                 extended_contig=str(d / "extended.fa"),
                 remaining_contig=str(d / "remaining.fa"),
                 work_dir=str(d / "tmp"), graph_build="device",
                 ratio_check=True)
    contigs = formalize_contigs(cfg.contig)
    genome = formalize_genome(cfg.genome, part)
    need = check_state_fits(genome.part_len, dev)
    setup_s = time.time() - t0
    print(f"# setup {setup_s:.0f}s: {gmb:g} Mb genome, {n_pairs} pairs, "
          f"{contigs.n_real} contigs, part={part}; k-mer state "
          f"{max(need) / 2**30:.2f} GiB a part", file=sys.stderr, flush=True)

    t0 = time.time()
    res = run_pipeline(cfg, reads=reads, contigs=contigs, genome=genome,
                       device=dev)
    wall = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    st = {k: round(v, 1) for k, v in
          res.stats.get("stage_seconds", {}).items()}
    memory = res.stats["memory"]
    peaks = [m["device_peak_bytes"] for m in memory.values()
             if "device_peak_bytes" in m]
    measured = res.stats["kmer_state_bytes"]
    n_pos = [part_positions(int(n)) for n in genome.part_len]
    line1 = dict(
        metric="bigscale_wall_seconds", value=round(wall, 1), unit="s",
        genome_mb=gmb, depth=depth, part=part, n_pairs=n_pairs,
        extended=len(res.extended_ids),
        extended_bases=int(sum(len(s) for s in res.extended_seqs)),
        remaining=len(res.remaining_ids), max_rss_gb=round(rss_gb, 1),
        stage_seconds=st, kmer_stats=res.stats.get("kmer_build"),
        alignment_threads={k: round(v, 1) for k, v in
                           res.stats["alignment_threads"].items()},
        aligned_pair_fraction=res.stats.get("aligned_pair_fraction"),
        setup_seconds=round(setup_s, 1),
        device_peak_bytes=max(peaks) if peaks else None,
        stage_memory=memory,
        seed_index_bytes=res.stats.get("seed_index_bytes"),
        heap_trim_seconds=res.stats.get("heap_trim_seconds"),
        kmer_state_bytes=need,
        kmer_state_bytes_measured=measured,
        kmer_state_bytes_per_position=[m / n for m, n in
                                       zip(measured, n_pos)] or None,
        host_ram_bytes=host_ram_bytes(),
        device=str(dev),
        card=nvidia_smi() if dev.type == "cuda" else None)
    print(json.dumps(line1), flush=True)
    if not res.extended_ids:
        raise AssertionError("bigscale run produced zero extended contigs")

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    m = evaluate(d / "target.fa", d / "extended.fa",
                 out_path=str(d / "stats.txt"), device=dev)
    m["eval_s"] = round(time.time() - t0, 1)
    if dev.type == "cuda":
        m["device_peak_bytes"] = torch.cuda.max_memory_allocated()
    line2 = {k: json_value(v) for k, v in m.items()}
    print(json.dumps(line2), flush=True)
    return line1, line2, dict(result=res, reads=reads, genome=genome,
                              cfg=cfg)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    gmb = float(argv[0]) if len(argv) > 0 else 200.0
    depth = float(argv[1]) if len(argv) > 1 else 20.0
    part = int(argv[2]) if len(argv) > 2 else 2
    d = os.environ.get("BIGSCALE_DIR")
    if d:
        run(gmb, depth, part, device=device, work_dir=d)
    else:
        with tempfile.TemporaryDirectory(prefix="bigscale") as tmp:
            run(gmb, depth, part, device=device, work_dir=tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
