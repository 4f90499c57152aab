"""The placements that the JAX package's contig aligner and the port's give
draft contigs of the big-genome workload, part by part, on the CPU.

    python3 scripts/contig_placements.py GMB DEPTH PART CONTIG [CONTIG ...]

Makes the workload of `python3 -m aligngraph_tpu_torch.bigscale GMB DEPTH
PART` (workload.make_bigscale_workload, seed 11), keeps the named draft
contigs (c<i> is the i-th, as bigscale names them) and aligns them against
each of the genome's PART parts with each package's per-part contig
alignment, the one its pipeline runs when PART > 1.  Prints one JSON line
per placement: the package, the contig, its strand, its start and end on
the whole genome, its aligned bases and its score.  Memory: ~8 GB at
200 Mb.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    gmb, depth, part, names = float(argv[0]), float(argv[1]), int(argv[2]), \
        argv[3:]
    from aligngraph_tpu_torch.io.fasta import decode, write_fasta
    from aligngraph_tpu_torch.workload import make_bigscale_workload

    target, ref, data, _, contig_seqs = make_bigscale_workload(
        int(gmb * 1e6), depth)
    del target, data
    d = Path(tempfile.mkdtemp())
    write_fasta(d / "genome.fa", ["chr"], [decode(ref)])
    write_fasta(d / "contigs.fa", names,
                [decode(contig_seqs[int(n[1:])]) for n in names])
    del ref, contig_seqs

    import aligngraph_tpu.config as jc
    import aligngraph_tpu.io.formalize as jf
    import aligngraph_tpu.pipeline.driver as jd
    import aligngraph_tpu_torch.config as tc
    import aligngraph_tpu_torch.io.formalize as tf
    import aligngraph_tpu_torch.pipeline.driver as td

    runs = (("jax", jc, jf, lambda g, c, cfg: jd._align_contigs_per_part(
                g, c, cfg)),
            ("torch", tc, tf, lambda g, c, cfg: td._align_contigs_per_part(
                g, c, cfg, "cpu", {})))
    for pkg, cmod, fmod, align in runs:
        contigs = fmod.formalize_contigs(d / "contigs.fa")
        genome = fmod.formalize_genome(d / "genome.fa", part)
        cfg = cmod.Config(read1="-", read2="-", contig=str(d / "contigs.fa"),
                          genome=str(d / "genome.fa"), part=part)
        ca = align(genome, contigs, cfg)
        for i in range(len(ca.chunk_id)):
            print(json.dumps({
                "package": pkg,
                "contig": contigs.ids[contigs.chunk_real[ca.chunk_id[i]]],
                "fr": int(ca.fr[i]), "target_start": int(ca.target_start[i]),
                "target_end": int(ca.target_end[i]),
                "aligned": int((ca.pos_map[i] >= 0).sum()),
                "score": int(ca.score[i])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
