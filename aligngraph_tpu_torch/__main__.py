"""CLI entrypoint of the PyTorch / CUDA port — C1 (`main` + `print`,
AlignGraph.cpp:4696-4796, 4304-4327).  The same flag surface as the
reference and as `python -m aligngraph_tpu`; the aligners run on the CUDA
device (there is no CPU fallback: without a GPU the command fails):

  python -m aligngraph_tpu_torch --read1 r1.fa --read2 r2.fa --contig c.fa
      --genome g.fa --distanceLow 300 --distanceHigh 700
      --extendedContig out.fa --remainingContig rem.fa
      [--kMer k --insertVariation v --coverage c --part p --fastMap
       --ratioCheck --iterativeMap --misassemblyRemoval --uniqueExtension
       --resume]

From Python, main(argv, device="cpu") runs the same pipeline on the plain
CPU versions of the kernels.
"""

from __future__ import annotations

import sys

USAGE = """\
aligngraph_tpu_torch: reference-guided genome reassembly on a CUDA GPU
(AlignGraph-compatible capability surface, in-engine aligners)

usage: python -m aligngraph_tpu_torch --read1 reads_1.fa --read2 reads_2.fa
    --contig contigs.fa --genome genome.fa --distanceLow dLow
    --distanceHigh dHigh --extendedContig extended.fa
    --remainingContig remaining.fa
    [--kMer k --insertVariation iv --coverage c --part p --fastMap
     --ratioCheck --iterativeMap --misassemblyRemoval --uniqueExtension
     --resume]
"""


def main(argv=None, device="cuda") -> int:
    from aligngraph_tpu_torch.config import Config, ConfigError

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    try:
        cfg = Config.from_argv(argv)
    except ConfigError as e:
        print(f"error: {e}\n\n{USAGE}", file=sys.stderr)
        return 2

    import torch

    from aligngraph_tpu_torch.pipeline.checkpoint import Checkpoint
    from aligngraph_tpu_torch.pipeline.driver import run_pipeline

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("aligngraph_tpu_torch runs its aligners on a "
                           "CUDA device and none is available")
    ckpt = Checkpoint(cfg.work_dir)
    try:
        cfg.validate()
    except ConfigError as e:
        if not cfg.resume:
            print(f"error: {e}\n\n{USAGE}", file=sys.stderr)
            return 2
    result = run_pipeline(cfg, checkpoint=ckpt, device=device)
    print(f"FINISHED: {len(result.extended_ids)} extended contigs, "
          f"{len(result.remaining_ids)} remaining, "
          f"{result.wall_seconds:.1f}s total "
          f"({result.align_seconds:.1f}s alignment)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
