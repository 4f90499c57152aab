"""bowtie2-compatible CLI frontend to the port's PE read aligner, on a
CUDA device.

Consumes the exact invocation the reference makes (AlignGraph.cpp:
3601-3609): `bowtie2 -f --no-mixed -k 5 -p 8 --local ... -I dLow -X dHigh
--no-discordant -x <prefix> -1 <fa> -2 <fa> --reorder` and writes SAM to
stdout (or -S) in bowtie2's -k pair layout, the same text as
aligngraph_tpu.compat.bowtie2_cli.  The genome is `<prefix>.fa` (the
reference always builds the index from that file, :3599).
"""

from __future__ import annotations

import sys

USAGE = """aligngraph-tpu-torch bowtie2-compatible aligner
Usage:
  bowtie2 [options]* -x <bt2-idx> -1 <m1> -2 <m2> [-S <sam>]
"""


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "-h" in argv or "--help" in argv:
        sys.stdout.write(USAGE)
        return 0

    opts = {"-I": "0", "-X": "99999"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-x", "-1", "-2", "-S", "-I", "-X", "-k", "-p", "--mp",
                 "--rdg", "--rfg", "--score-min"):
            opts[a] = argv[i + 1]
            i += 2
        else:
            i += 1
    if "-x" not in opts or "-1" not in opts or "-2" not in opts:
        sys.stderr.write(USAGE)
        return 1

    import numpy as np

    from aligngraph_tpu_torch.compat.textout import sam_lines
    from aligngraph_tpu_torch.config import Config
    from aligngraph_tpu_torch.io.fasta import encode, read_fasta
    from aligngraph_tpu_torch.io.formalize import Reads
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner
    from aligngraph_tpu_torch.compat.common import genome_axis

    dlow = int(opts["-I"])
    dhigh = int(opts["-X"])
    # no seeds or concordant pairs across records
    gids, genome, rec_starts, rec_lens = genome_axis(opts["-x"] + ".fa",
                                                     dhigh + 1024)

    ids1, s1 = read_fasta(opts["-1"])
    ids2, s2 = read_fasta(opts["-2"])
    n = min(len(s1), len(s2))
    lens = np.array([min(len(s1[i]), len(s2[i])) for i in range(n)],
                    np.int32)
    L = int(lens.max()) if n else 0
    data = np.full((2 * n, L), 4, np.int8)
    for i in range(n):
        data[2 * i, :lens[i]] = encode(s1[i])[:lens[i]]
        data[2 * i + 1, :lens[i]] = encode(s2[i])[:lens[i]]
    reads = Reads(n, L, data, lens)

    cfg = Config(distance_low=dlow, distance_high=dhigh)
    P = 4096
    while P > 256 and P // 2 >= n:
        P //= 2
    aligner = ReadAligner.build(genome, cfg, batch_pairs=P, c13=False,
                                device=device)
    pairs = aligner.align(reads)

    out = opts.get("-S")
    f = open(out, "w") if out else sys.stdout
    for rid, rl in zip(gids, rec_lens):
        f.write(f"@SQ\tSN:{rid}\tLN:{int(rl)}\n")
    for line in sam_lines(pairs, n, gids, rec_starts):
        f.write(line + "\n")
    if out:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
