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
                          and its position-sharded form
  parallel/mesh.py        torch.distributed process groups (NCCL on cuda,
                          gloo on cpu), the rank launcher run_ranks and
                          the data-parallel read aligner
  parallel/halo.py        halo exchange between position blocks
  parallel/kmer_shard.py  the k-mer layer build, position-sharded
  dryrun.py               python -m aligngraph_tpu_torch.dryrun: every
                          multi-device path once on tiny shapes
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

The host modules it shares with the JAX package (config, io,
align/types, graph/{model, contig_layer, kmer_layer, traverse}, native,
pipeline/checkpoint, compat/textout, utils) are the port's own copies, and
the names a caller needs are re-exported here: nothing of the port imports
jax or aligngraph_tpu.  Nothing is built or loaded at import time: the
CUDA kernels (nvcc) and the C++ traversal and FASTA parser (g++) are
compiled on first use into the git-ignored aligngraph_tpu_torch/_build/.
A work dir written by the JAX package cannot be resumed by the port: its
checkpoints pickle the JAX package's classes.
"""

# Host malloc tuning (utils/hostmem.py): keep freed pages on the heap so
# large numpy temporaries reuse warm memory.
from aligngraph_tpu_torch.utils.hostmem import tune_host_malloc as _thm

_thm()

from aligngraph_tpu_torch.align.types import PairAlignments  # noqa: E402,F401
from aligngraph_tpu_torch.config import THRESHOLD, Config  # noqa: E402,F401
from aligngraph_tpu_torch.graph.contig_layer import (  # noqa: E402,F401
    build_contig_layer)
from aligngraph_tpu_torch.graph.kmer_layer import (  # noqa: E402,F401
    build_kmer_layer)
from aligngraph_tpu_torch.graph.model import GraphTensors  # noqa: E402,F401
from aligngraph_tpu_torch.io.fasta import (  # noqa: E402,F401
    decode, write_fasta)
from aligngraph_tpu_torch.io.formalize import (  # noqa: E402,F401
    Reads, formalize_contigs, formalize_genome)
from aligngraph_tpu_torch.align.read_aligner import (  # noqa: E402,F401
    ReadAligner)
