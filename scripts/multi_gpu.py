"""The port's multi-device paths at full size on N ranks, each held to its
single-device counterpart on rank 0, with every rank's walls.

    python3 scripts/multi_gpu.py [--nproc N] [--device cuda|cpu]
                                 [--genome-len G] [--depth D]

Every rank (parallel/mesh.run_ranks: NCCL on cuda, rank r on cuda:r;
gloo on cpu) makes bench_pipeline.py's workload (chip_smoke.full_workload;
default 4.6 Mb, depth 25, 575,000 pairs) and then, each step started
together by one all_reduce and timed on every rank's host clock after a
synchronise:
  align     make_sharded_aligner over the reads (after a warm-up on 4,096
            pairs that loads the kernels and starts the communicator);
            rank 0 aligns all pairs alone with ReadAligner.align and
            compares every field (the per-rank batches differ from the
            single-device ones, so a batch that sheds candidates could
            differ: reported, not asserted)
  kmer      build_kmer_layer_sharded over the C13-accepted records of the
            sharded align, chunks of 16,384, on the contig layer of each
            rank's own ContigAligner; rank 0 then runs
            build_kmer_layer_device on the same records: all 13 arrays
            and the statistics must be equal
  coverage  make_sharded_coverage over both mates' spans of those
            records (G padded to a multiple of N), equal to span_coverage
            on rank 0; then sliding_window_sum_sharded (window 5) over it,
            equal to the plain windowed sum
Prints one JSON line: the world size, the device, each step's wall on
every rank, rank 0's single-device walls and the comparisons; then the
card's name and power limit.  Fails if an equality that must hold does
not.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from aligngraph_tpu_torch import (THRESHOLD, GraphTensors,  # noqa: E402
                                  ReadAligner, Reads, build_contig_layer)
from aligngraph_tpu_torch.align.contig_aligner import (  # noqa: E402
    ContigAligner)
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj  # noqa: E402
from aligngraph_tpu_torch.ops.seeding import build_index  # noqa: E402
from aligngraph_tpu_torch.parallel.coverage import (  # noqa: E402
    make_sharded_coverage, pad_spans, span_coverage)
from aligngraph_tpu_torch.parallel.halo import (  # noqa: E402
    sliding_window_sum_sharded)
from aligngraph_tpu_torch.parallel.kmer_shard import (  # noqa: E402
    build_kmer_layer_sharded)
from aligngraph_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_blocks, make_sharded_aligner, run_ranks)
from aligngraph_tpu_torch.pipeline.driver import _subset_pairs  # noqa: E402


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _step(mesh, fn):
    """fn() started on every rank together (one all_reduce), timed on this
    rank's host clock up to a synchronise: (result, seconds)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
    _sync(mesh)
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _alone(mesh, fn):
    """fn() on this rank alone, timed: (result, seconds)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _equal(a, b, fields) -> list:
    """The fields in which two objects' arrays differ (dtype or values)."""
    return [f for f in fields if getattr(a, f).dtype != getattr(b, f).dtype
            or not np.array_equal(getattr(a, f), getattr(b, f))]


def rank_run(mesh, size: dict, work: str) -> dict:
    """Every step on this rank; rank 0's result carries the comparisons."""
    r, S, dev = mesh.rank, mesh.world_size, mesh.device
    wl = cs.full_workload(Path(work) / f"rank{r}", **size)
    cfg, reads, genome = wl["cfg"], wl["reads"], wl["genome"]
    gseq = np.asarray(genome.seq, np.int8)
    index = build_index(gseq, cfg.seed_len, device=dev)
    aligner = ReadAligner.from_index(gseq, index, cfg, device=dev)
    walls, out = {}, {}

    align = make_sharded_aligner(mesh, aligner)
    n_w = min(reads.n_pairs, 4096)
    align(Reads(n_w, reads.max_len, reads.data[:2 * n_w],
                reads.lengths[:n_w]))
    res, walls["align"] = _step(mesh, lambda: align(reads))
    if r == 0:
        want, out["align_single_s"] = _alone(
            mesh, lambda: aligner.align(reads))
        out["records"] = {"sharded": res.total, "per_rank": res.per_rank,
                          "single": want.n}
        out["align_differs_in"] = (
            _equal(res.records, want, cs.FIELDS) if res.records.n == want.n
            else ["record count"])

    every = _subset_pairs(res.records, res.records.ratio_ok(THRESHOLD))
    cali = ContigAligner(gseq, cfg, index=aligner.index, device=dev).align(
        wl["contigs"])
    g0 = GraphTensors.create(genome.part_seq(0))
    build_contig_layer(g0, wl["contigs"], cali)
    g_sh = copy.deepcopy(g0)
    st, walls["kmer"] = _step(mesh, lambda: build_kmer_layer_sharded(
        g_sh, every, reads, cfg.k_mer, cfg.insert_variation, mesh,
        chunk_records=cs.KMER_CHUNK))
    if r == 0:
        g_dev = copy.deepcopy(g0)
        st_dev, out["kmer_single_s"] = _alone(
            mesh, lambda: kj.build_kmer_layer_device(
                g_dev, every, reads, cfg.k_mer, cfg.insert_variation,
                chunk_records=cs.KMER_CHUNK, device=dev))
        bad = _equal(g_sh, g_dev, cs.KM_FIELDS)
        if bad or dataclasses.asdict(st) != dataclasses.asdict(st_dev):
            raise AssertionError(f"sharded k-mer build != device build: "
                                 f"{bad}, {st} vs {st_dev}")
        out["kmer_stats"] = dataclasses.asdict(st)
        del g_dev
    del g_sh, g0

    G = int(genome.part_len)
    G_pad = -(-G // S) * S
    starts, ends = pad_spans(every.target_start.reshape(-1),
                             every.target_end.reshape(-1), S)
    n = len(starts) // S
    mine = [torch.from_numpy(np.ascontiguousarray(a[r * n:(r + 1) * n]))
            .to(dev) for a in (starts, ends)]
    cov_fn = make_sharded_coverage(mesh, G_pad)
    cov, walls["coverage"] = _step(mesh, lambda: cov_fn(*mine))
    win_fn = sliding_window_sum_sharded(mesh, cs.WINDOW)
    win, walls["window"] = _step(mesh, lambda: win_fn(cov))
    cov_all, win_all = gather_blocks(mesh, cov), gather_blocks(mesh, win)
    if r == 0:
        every_s = [torch.from_numpy(a.reshape(-1)).to(dev)
                   for a in (every.target_start, every.target_end)]
        want, out["coverage_single_s"] = _alone(
            mesh, lambda: span_coverage(*every_s, G_pad))
        if not (torch.equal(cov_all, want) and torch.equal(
                win_all, cs.window_sum_plain(want, cs.WINDOW))):
            raise AssertionError("sharded coverage or window sum != plain")

    # every rank's walls, to rank 0
    names = sorted(walls)
    per_rank = gather_blocks(mesh, torch.tensor(
        [walls[k] for k in names], dtype=torch.float64, device=dev))
    per_rank = per_rank.view(S, len(names)).cpu().numpy()
    out["walls_s"] = {k: per_rank[:, i].tolist() for i, k in enumerate(names)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks (default: the visible GPUs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--depth", type=float, default=25.0)
    args = ap.parse_args(argv)
    nproc = args.nproc or torch.cuda.device_count()
    if args.device == "cuda" and not 1 <= nproc <= torch.cuda.device_count():
        raise SystemExit(f"{nproc} ranks need as many GPUs; "
                         f"{torch.cuda.device_count()} visible")
    size = dict(genome_len=args.genome_len, depth=args.depth)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = run_ranks(rank_run, nproc, args.device, size, tmp)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"world_size": nproc, "device": kind, **size,
                      "total_s": time.perf_counter() - t0, **out}))
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
