"""End-to-end pipeline benchmark at BASELINE.json config 1's scale,
bench_pipeline.py on the port.

    python3 -m aligngraph_tpu_torch.bench_pipeline

The environment sets the size, as for bench_pipeline.py:
BENCH_PIPE_GENOME (default 4,600,000 bases), BENCH_PIPE_DEPTH (25) and
BENCH_PIPE_PAIRS (default depth * genome / 200).  The workload is
bench_pipeline.py's (workload.make_pipeline_workload, seed 7: a target
genome, a reference = target + 1% SNPs + small indels, 100 bp PE reads of
the target, ~3 kb draft contigs of it with insert-bridgeable gaps); the
reference, the target and the contigs go through FASTA files in the work
directory, the reads stay in memory.  One run_pipeline (distance
300-700) on the device, with the k-mer layer build that
pipeline/driver.graph_build_for picks (the device build on CUDA), then
Eval of extended.fa against the target.

Prints bench_pipeline.py's ONE JSON line on stdout (pipeline_wall_s, its
stages, the workload's size, the extension product, Eval's metrics and
the k-mer build's statistics), and on stderr a "#" line with the k-mer
build that ran, the seconds of the pipeline's input formalization, the
hand-written kernels' launches and lanes in the pipeline and in Eval (by
kernel and read length), the device and the card's name and power
limit.  Exits 1 when the pipeline extends no contig.

main() works in a directory of its own under the temp dir
(WORK_DIR_NAME), so that it never shares one with bench_pipeline.py's
/tmp/bench_pipeline.  There is no fallback to the CPU: without a CUDA
device it raises.  From Python, main(device="cpu") runs the same on the
CPU, and prepare / pipeline / report run its parts.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from aligngraph_tpu_torch.bigscale import nvidia_smi
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import (Reads, formalize_contigs,
                                               formalize_genome)
from aligngraph_tpu_torch.ops import banded_sw_cuda
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.utils.hostmem import warm_heap
from aligngraph_tpu_torch.workload import make_pipeline_workload

READ_LEN = 100
WORK_DIR_NAME = "aligngraph_tpu_torch.bench_pipeline"
EVAL_KEYS = ("n_contigs", "n_true_contigs", "n50", "covered_length",
             "average_identity", "mpmb")


def prepare(work_dir, genome_len: int = 4_600_000, depth: float = 25.0,
            n_pairs=None) -> dict:
    """The workload: genome.fa, target.fa and contigs.fa in work_dir ->
    {"work", "cfg" (outputs in work_dir, work dir work_dir/tmp), "reads",
    "genome_len", "depth", "n_draft_contigs", "setup_s"}."""
    warm_heap(1 << 30)
    t0 = time.perf_counter()
    target, ref, data, lens, contig_seqs = make_pipeline_workload(
        genome_len, depth, READ_LEN, n_pairs=n_pairs)
    d = Path(work_dir)
    d.mkdir(parents=True, exist_ok=True)
    write_fasta(d / "genome.fa", ["chr"], [decode(ref)])
    write_fasta(d / "target.fa", ["chr"], [decode(target)])
    write_fasta(d / "contigs.fa",
                [f"c{i}" for i in range(len(contig_seqs))],
                [decode(c) for c in contig_seqs])
    cfg = Config(read1="-", read2="-", contig=str(d / "contigs.fa"),
                 genome=str(d / "genome.fa"), distance_low=300,
                 distance_high=700,
                 extended_contig=str(d / "extended.fa"),
                 remaining_contig=str(d / "remaining.fa"),
                 work_dir=str(d / "tmp"))
    return dict(work=d, cfg=cfg, reads=Reads(len(lens), READ_LEN, data, lens),
                genome_len=genome_len, depth=depth,
                n_draft_contigs=len(contig_seqs),
                setup_s=time.perf_counter() - t0)


def pipeline(wl: dict, *, device):
    """run_pipeline on wl's inputs, the contigs and the genome formalized
    inside the timed region as in bench_pipeline.py -> (the
    PipelineResult, its wall in seconds)."""
    cfg = wl["cfg"]
    t0 = time.perf_counter()
    res = run_pipeline(cfg, reads=wl["reads"],
                       contigs=formalize_contigs(cfg.contig),
                       genome=formalize_genome(cfg.genome, 1),
                       device=device, auto_graph_build=True)
    return res, time.perf_counter() - t0


def report(wl: dict, res, wall: float, *, device) -> dict:
    """Eval of extended.fa against the target (when the pipeline extended
    any contig) -> bench_pipeline.py's JSON line as a dict."""
    n_ext = len(res.extended_ids)
    ev = {}
    if n_ext:
        m = evaluate(wl["work"] / "target.fa", wl["work"] / "extended.fa",
                     device=device)
        ev = {k: (round(float(m[k]), 4) if isinstance(m[k], float)
                  else int(m[k])) for k in EVAL_KEYS if k in m}
    return {
        "metric": "pipeline_wall_s",
        "value": round(wall, 2),
        "unit": "s",
        "stages": {k: round(v, 2) for k, v in
                   res.stats.get("stage_seconds", {}).items()},
        "n_pairs": wl["reads"].n_pairs,
        "genome_mb": wl["genome_len"] / 1e6,
        "depth": wl["depth"],
        "n_draft_contigs": wl["n_draft_contigs"],
        "extended": n_ext,
        "extended_bases": int(sum(len(s) for s in res.extended_seqs)),
        "eval": ev,
        "kmer_stats": res.stats.get("kmer_build"),
    }


def main(device="cuda") -> int:
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("the pipeline benchmark needs a CUDA device and "
                           "none is available")
    glen = int(os.environ.get("BENCH_PIPE_GENOME", 4_600_000))
    depth = float(os.environ.get("BENCH_PIPE_DEPTH", 25))
    n_pairs = int(os.environ.get("BENCH_PIPE_PAIRS",
                                 int(depth * glen / (2 * READ_LEN))))
    wl = prepare(Path(tempfile.gettempdir()) / WORK_DIR_NAME, glen, depth,
                 n_pairs)
    banded_sw_cuda.reset_launches()
    res, wall = pipeline(wl, device=device)
    pipe_launches = banded_sw_cuda.launches_by_length()
    banded_sw_cuda.reset_launches()
    line = report(wl, res, wall, device=device)
    eval_launches = banded_sw_cuda.launches_by_length()
    print(json.dumps(line), flush=True)
    print(f"# graph_build={res.stats['graph_build']} "
          f"formalize={res.stats['formalize_seconds']:.2f}s "
          f"setup={wl['setup_s']:.2f}s "
          f"launches_by_L pipeline={json.dumps(pipe_launches)} "
          f"eval={json.dumps(eval_launches)} device={device} "
          f"card={nvidia_smi() if cuda else None}", file=sys.stderr,
          flush=True)
    if line["extended"] == 0:
        print("FAIL: pipeline produced zero extended contigs",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
