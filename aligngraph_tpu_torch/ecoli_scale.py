"""End-to-end pipeline at E. coli scale (BASELINE.json config 1),
scripts/ecoli_scale_run.py on the port.

    python3 -m aligngraph_tpu_torch.ecoli_scale [n_pairs] [genome_len]

Defaults 300,000 pairs and 4,600,000 bases, as the script's.  The
workload is the script's: workload.make_workload(..., seed=7,
return_target=True) (a target, a reference with 1% SNPs, 100 bp reads of
the target at a 500 bp insert), then draft contigs cut from the target by
workload.cut_contigs on a fresh generator seeded 7; the reference and the
contigs go through FASTA files, the reads stay in memory.  run_pipeline
(distance 100-900) on the device, with the k-mer layer build that
pipeline/driver.graph_build_for picks (the device build on CUDA); then
Eval of extended.fa against the target.

Prints the script's two JSON lines on stdout, with its keys: the run
(its size, extended and remaining contigs, extended bases, the wall and
the alignment seconds, the k-mer build's statistics), then Eval's
metrics with eval_s.  On stderr the script's "setup:" line, and a "#"
line with the k-mer build that ran, the hand-written kernels' launches
and lanes in the pipeline (by kernel and read length), the device and the
card's name and power limit.  Raises when no contig is extended, as the
script does.

main() works in a directory of its own under the temp dir
(WORK_DIR_NAME), never in the script's /tmp/ecoli_scale.  There is no
fallback to the CPU: without a CUDA device it raises.  From Python,
main(argv, device="cpu") runs the same on the CPU, and run(...) returns
the two lines.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from aligngraph_tpu_torch.bigscale import json_value, nvidia_smi
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import (Reads, formalize_contigs,
                                               formalize_genome)
from aligngraph_tpu_torch.ops import banded_sw_cuda
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.workload import cut_contigs, make_workload

WORK_DIR_NAME = "aligngraph_tpu_torch.ecoli_scale"


def run(n_pairs: int = 300_000, glen: int = 4_600_000, *, device,
        work_dir):
    """The whole run in work_dir -> (first JSON line's dict, second's)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the E. coli-scale run needs a CUDA device and "
                           "none is available")
    rng = np.random.default_rng(7)
    t0 = time.time()
    ref, data, lens, target = make_workload(
        genome_len=glen, n_pairs=n_pairs, seed=7, return_target=True)
    reads = Reads(n_pairs, data.shape[1], data, lens)
    contig_seqs = cut_contigs(rng, target)
    print(f"setup: {len(contig_seqs)} contigs, {n_pairs} pairs, "
          f"{glen / 1e6:.1f} Mb genome [{time.time() - t0:.1f}s]",
          file=sys.stderr, flush=True)

    d = Path(work_dir)
    d.mkdir(parents=True, exist_ok=True)
    write_fasta(d / "genome.fa", ["chr"], [decode(ref)])
    write_fasta(d / "contigs.fa",
                [f"c{i}" for i in range(len(contig_seqs))],
                [decode(c) for c in contig_seqs])
    cfg = Config(read1="-", read2="-", contig=str(d / "contigs.fa"),
                 genome=str(d / "genome.fa"), distance_low=100,
                 distance_high=900,
                 extended_contig=str(d / "extended.fa"),
                 remaining_contig=str(d / "remaining.fa"),
                 work_dir=str(d / "tmp"))
    banded_sw_cuda.reset_launches()
    res = run_pipeline(cfg, reads=reads,
                       contigs=formalize_contigs(cfg.contig),
                       genome=formalize_genome(cfg.genome, 1), device=dev,
                       auto_graph_build=True)
    launches = banded_sw_cuda.launches_by_length()
    line1 = {
        "n_pairs": n_pairs, "genome_mb": glen / 1e6,
        "extended": len(res.extended_ids),
        "remaining": len(res.remaining_ids),
        "extended_bases": int(sum(len(s) for s in res.extended_seqs)),
        "wall_s": round(res.wall_seconds, 1),
        "align_s": round(res.align_seconds, 1),
        "kmer_stats": res.stats.get("kmer_build"),
    }
    print(json.dumps(line1), flush=True)
    print(f"# graph_build={res.stats['graph_build']} launches_by_L="
          f"{json.dumps(launches)} device={dev} "
          f"card={nvidia_smi() if dev.type == 'cuda' else None}",
          file=sys.stderr, flush=True)
    if not res.extended_ids:
        raise AssertionError("scale run produced ZERO extended contigs — "
                             "workload miscalibrated")

    write_fasta(d / "target.fa", ["chr"], [decode(target)])
    t0 = time.time()
    m = evaluate(d / "target.fa", d / "extended.fa",
                 out_path=str(d / "stats.txt"), device=dev)
    m["eval_s"] = round(time.time() - t0, 1)
    line2 = {k: json_value(v) for k, v in m.items()}
    print(json.dumps(line2), flush=True)
    return line1, line2


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_pairs = int(argv[0]) if len(argv) > 0 else 300_000
    glen = int(argv[1]) if len(argv) > 1 else 4_600_000
    run(n_pairs, glen, device=device,
        work_dir=Path(tempfile.gettempdir()) / WORK_DIR_NAME)
    return 0


if __name__ == "__main__":
    sys.exit(main())
