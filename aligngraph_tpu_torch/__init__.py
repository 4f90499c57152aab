"""aligngraph_tpu_torch — the PyTorch / CUDA port of aligngraph_tpu.

A second package beside the JAX one, held against it: the same inputs give
the same outputs, field by field.  This slice holds the PE read aligner
(`ReadAligner`, the bowtie2 replacement):

  ops/seeding.py        canonical k-mer index (host) + seed lookup and
                        candidate selection (torch)
  ops/banded_sw.py      banded affine local DP, traceback, gapless fast
                        path: the plain torch versions, used on the CPU
  ops/banded_sw_cuda.py wrappers of the hand-written Hopper kernels in
                        csrc/banded_sw.cu, used for CUDA tensors
  ops/_build.py         nvcc build of csrc/ at first use, ctypes binding
  align/read_aligner.py ReadAligner.build / from_index / align
  workload.py           the synthetic PE benchmark workload
  profile_align.py      per-layer host times and device idle share of one
                        align (python3 -m aligngraph_tpu_torch.profile_align)

Host modules that import no JAX are reused from aligngraph_tpu (Config,
Reads, PairAlignments, utils.hostmem) and re-exported here, so callers of
the port need no import from the JAX package.  Nothing here imports jax,
and nothing is built or loaded at import time: the CUDA kernels are
compiled on first use.
"""

from aligngraph_tpu.align.types import PairAlignments  # noqa: F401
from aligngraph_tpu.config import Config  # noqa: F401
from aligngraph_tpu.io.formalize import Reads  # noqa: F401
from aligngraph_tpu_torch.align.read_aligner import ReadAligner  # noqa: F401
