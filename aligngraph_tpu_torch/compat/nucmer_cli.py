"""nucmer-compatible CLI frontend to the port's contig aligner, on a CUDA
device.

Consumes the exact invocations the reference makes
(`nucmer <ref.fa> <qry.fa> -p <prefix>`, AlignGraph.cpp:3634-3641,
2960-2970; `nucmer -h` availability probe, :4688) and writes
`<prefix>.delta` in the subset of the NUCMER delta format the
reference's `delta2psl` reader consumes (AlignGraph.cpp:588-729), the same
text as aligngraph_tpu.compat.nucmer_cli.  The engine runs in fastMap mode
(sparser anchoring).
"""

from __future__ import annotations

import os
import sys

USAGE = "USAGE: nucmer [options] <Reference> <Query> -p <prefix>\n"


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "--help" in argv:
        sys.stdout.write(USAGE)
        return 0
    prefix = "out"
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-p" and i + 1 < len(argv):
            prefix = argv[i + 1]
            i += 2
            continue
        if not a.startswith("-"):
            pos.append(a)
        i += 1
    if len(pos) < 2:
        sys.stderr.write(USAGE)
        return 1
    db_path, q_path = pos[0], pos[1]
    out_path = prefix + ".delta"

    from aligngraph_tpu_torch.compat.textout import delta_lines
    from aligngraph_tpu_torch.config import Config
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
    from aligngraph_tpu_torch.compat.common import genome_axis, query_contigs

    # sep > chain join gap: no cross-record chains
    gids, genome, rec_starts, rec_lens = genome_axis(db_path, 30_000)
    contigs = query_contigs(q_path)
    cfg = Config(fast_map=True)
    with open(out_path, "w") as f:
        # reader skips the first two lines (AlignGraph.cpp:605-606)
        f.write(f"{os.path.abspath(db_path)} {os.path.abspath(q_path)}\n")
        f.write("NUCMER\n")
        if len(genome) < cfg.seed_len or not contigs.n_real:
            return 0
        ali = ContigAligner(genome, cfg, accept=(0.0, 0.0, 0),
                            device=device).align(contigs)
        row_names = [contigs.ids[int(ali.chunk_id[r])] for r in range(ali.n)]
        row_sizes = [int(ali.source_size[r]) for r in range(ali.n)]
        for line in delta_lines(ali, row_names, row_sizes, gids,
                                rec_starts, rec_lens):
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
