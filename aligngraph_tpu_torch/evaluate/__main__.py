"""Eval CLI — E1 (`Eval-AlignGraph genome.fa contigs.fa stats.txt`,
Eval-AlignGraph.cpp:549-571), on a CUDA device.

usage: python -m aligngraph_tpu_torch.evaluate genome.fa contigs.fa stats.txt
"""

import sys

USAGE = ("usage: python -m aligngraph_tpu_torch.evaluate "
         "genome.fa contigs.fa stats.txt")


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(USAGE, file=sys.stderr)
        return 2
    from aligngraph_tpu_torch.evaluate.evaluate import evaluate

    metrics = evaluate(argv[0], argv[1], out_path=argv[2], device=device)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
