"""aligngraph_tpu_torch — the PyTorch / CUDA port of aligngraph_tpu.

A second package beside the JAX one, held against it: the same inputs give
the same outputs, field by field and byte for byte.  It runs the whole
reassembly pipeline with its aligners on one device:

  ops/seeding.py          canonical k-mer index (host) + seed lookup and
                          candidate selection (torch)
  ops/banded_sw.py        banded affine local DP, traceback, gapless fast
                          path: the plain torch versions, used on the CPU
  ops/banded_sw_cuda.py   wrappers of the hand-written Hopper kernels in
                          csrc/banded_sw.cu, used for CUDA tensors
  ops/_build.py           nvcc build of csrc/ at first use, ctypes binding
  align/read_aligner.py   ReadAligner (the bowtie2 replacement)
  align/contig_aligner.py ContigAligner (the BLAT/NUCMER replacement)
  parallel/coverage.py    span_coverage (misassembly removal's coverage)
  graph/kmer_layer_jit.py the k-mer layer build on the device
                          (build_kmer_layer_device, cfg.graph_build
                          "device"): torch sorts, scans and scatters
  pipeline/driver.py      run_pipeline; refinement.py, misassembly.py
  evaluate/evaluate.py    evaluate (Eval-AlignGraph)
  __main__.py             python -m aligngraph_tpu_torch (the CLI)
  compat/                 bowtie2 / pblat / nucmer compatible CLIs
  workload.py             the synthetic benchmark workloads
  profile_align.py        per-layer host times and device idle share of
                          one align (python3 -m
                          aligngraph_tpu_torch.profile_align)

Host modules that import no JAX are reused from aligngraph_tpu (config,
io, align/types, graph (the contig layer, the host k-mer build oracle,
traversal), native, pipeline/checkpoint, utils) and the names a caller
needs are re-exported here, so callers of the port need no import
from the JAX package.  Nothing here imports jax, and nothing is built or
loaded at import time: the CUDA kernels are compiled on first use.
"""

from aligngraph_tpu.align.types import PairAlignments  # noqa: F401
from aligngraph_tpu.config import THRESHOLD, Config  # noqa: F401
from aligngraph_tpu.graph.contig_layer import build_contig_layer  # noqa: F401
from aligngraph_tpu.graph.kmer_layer import build_kmer_layer  # noqa: F401
from aligngraph_tpu.graph.model import GraphTensors  # noqa: F401
from aligngraph_tpu.io.fasta import decode, write_fasta  # noqa: F401
from aligngraph_tpu.io.formalize import (  # noqa: F401
    Reads, formalize_contigs, formalize_genome)
from aligngraph_tpu_torch.align.read_aligner import ReadAligner  # noqa: F401
