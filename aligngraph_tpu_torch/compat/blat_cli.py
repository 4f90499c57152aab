"""pblat/blat-compatible CLI frontend to the port's contig aligner, on a
CUDA device.

Consumes the exact invocation the reference makes (AlignGraph.cpp:
3648-3653, 2976-2981): `pblat <db.fa> <query.fa> -noHead <out.psl>
[-fastMap] [-threads=N]` and writes headerless PSL, the same text as
aligngraph_tpu.compat.blat_cli.

Raw output (no acceptance thresholds) — the reference binary applies its
own INIT_CONTIG_THRESHOLD / refinement filters when parsing the PSL.
"""

from __future__ import annotations

import sys

USAGE = "usage: pblat database query [-noHead] output.psl [-fastMap]\n"


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "--help" in argv:
        sys.stdout.write(USAGE)
        return 0
    pos = [a for a in argv if not a.startswith("-")]
    if len(pos) < 3:
        sys.stderr.write(USAGE)
        return 1
    db_path, q_path, out_path = pos[0], pos[1], pos[2]

    from aligngraph_tpu_torch.compat.textout import psl_lines
    from aligngraph_tpu_torch.config import Config
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
    from aligngraph_tpu_torch.compat.common import genome_axis, query_contigs

    # sep > chain join gap: no cross-record chains
    gids, genome, rec_starts, rec_lens = genome_axis(db_path, 30_000)
    contigs = query_contigs(q_path)
    cfg = Config(fast_map="-fastMap" in argv)
    if len(genome) < cfg.seed_len or not contigs.n_real:
        open(out_path, "w").close()
        return 0
    ali = ContigAligner(genome, cfg, accept=(0.0, 0.0, 0),
                        device=device).align(contigs)
    row_names = [contigs.ids[int(ali.chunk_id[r])] for r in range(ali.n)]
    with open(out_path, "w") as f:
        for line in psl_lines(ali, row_names, gids, rec_starts, rec_lens):
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
