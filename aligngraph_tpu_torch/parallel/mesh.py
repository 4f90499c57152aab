"""Process groups and the data-parallel read aligner on torch.distributed:
the port of aligngraph_tpu/parallel/mesh.py.

The JAX package lays a 1-D device mesh over the chips and runs one program
under shard_map; here every device is one process of a torch.distributed
group (one rank), and each rank runs the same code on its share:

  make_mesh            the group, this rank, the world size and the rank's
                       device (JAX make_mesh :41)
  run_ranks            spawns one process per rank, starts the group
                       through a file and returns rank 0's result
  shard_reads_pairwise pads a read batch so pairs split evenly (:90)
  make_sharded_aligner each rank aligns its contiguous slice of the pairs
                       with ReadAligner.align; the records are gathered
                       on every rank with global pair ids (:47)

The backend follows the device, never a probe: NCCL for "cuda" (rank r on
cuda:r), gloo for "cpu".  Collectives run on tensors on the rank's
device, since NCCL takes CUDA tensors and gloo CPU ones.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.io.formalize import Reads

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a rank waits in a collective, and run_ranks for all ranks,
# before either gives up
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of its process group (the counterpart of a 1-D
    jax.sharding.Mesh).  group None is the default group."""
    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device

    def peer(self, rank: int) -> int:
        """The global rank of the group's rank `rank` (for P2P calls)."""
        return rank if self.group is None else \
            dist.get_global_rank(self.group, rank)


def init_group(device: str, rank: int, world_size: int,
               init_file: str) -> None:
    """Start the default process group for this rank through a file that
    every rank names (it must not hold an earlier group's data): NCCL on
    cuda:rank for "cuda", gloo for "cpu"."""
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKENDS[kind], init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_mesh(device: str = "cuda",
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """This rank's Mesh over `group` (default: the default group, which
    must be started).  The group's backend must be the device's: NCCL for
    "cuda", where rank r works on cuda:r, and gloo for "cpu"."""
    kind = torch.device(device).type
    backend = dist.get_backend(group)
    if backend != BACKENDS[kind]:
        raise ValueError(f"a {kind} mesh needs a {BACKENDS[kind]} group, "
                         f"not {backend}")
    rank = dist.get_rank(group)
    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    return Mesh(group, rank, dist.get_world_size(group), dev)


def gather_blocks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's block t (one shape on every rank) concatenated along
    dim 0 in rank order, on every rank: [S * n, ...] on t's device."""
    out = t.new_empty((mesh.world_size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    return out


def _rank_main(rank: int, nproc: int, device: str, init_file: str,
               fn: Callable, args: tuple, out: Any) -> None:
    """One spawned rank: start the group, run fn(mesh, *args), report."""
    try:
        if torch.device(device).type == "cpu":
            # gloo ranks of one host share its cores
            torch.set_num_threads(1)
        init_group(device, rank, nproc, init_file)
        try:
            res = fn(make_mesh(device), *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res if rank == 0 else None))
    except Exception:      # the parent raises it; this process only reports
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, nproc: int, device: str, *args) -> Any:
    """Run fn(mesh, *args) on nproc ranks, one spawned process each, and
    return rank 0's result.  fn must be a module-level function of an
    importable module (a spawned process imports it by name); args and the
    result are pickled.  Raises RuntimeError with the traceback of the
    first rank that failed, or if the ranks take longer than TIMEOUT_S."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nproc, device,
                                   os.path.join(tmp, "group"), fn, args,
                                   out))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        try:
            results, deadline = {}, time.monotonic() + TIMEOUT_S
            while len(results) < nproc:
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} before reporting")
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"ranks still running after "
                                           f"{TIMEOUT_S} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                results[rank] = res
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return results[0]


def shard_reads_pairwise(data: np.ndarray, plens: np.ndarray,
                         n_shards: int):
    """Pad a read batch so pairs split evenly across n_shards ranks.

    data: [2P, L] codes, 2 rows a pair; plens [P].  Returns (data, plens)
    padded to a multiple of n_shards pairs: pad rows are N (4), pad pairs
    have length 0 -> no seeds -> no records.  (JAX's version pads its
    packed read words, which the port does not have.)"""
    P_ = len(plens)
    tgt = -(-P_ // n_shards) * n_shards
    if tgt != P_:
        data = np.concatenate(
            [data, np.full((2 * (tgt - P_), data.shape[1]), 4, data.dtype)])
        plens = np.concatenate([plens, np.zeros(tgt - P_, plens.dtype)])
    return data, plens


class ShardedRecords(NamedTuple):
    """The merged records of a sharded align and its counters: per_rank
    holds each rank's record count, total their all_reduce'd sum."""
    records: PairAlignments
    per_rank: List[int]
    total: int


def _gather_rows(mesh: Mesh, rows: torch.Tensor, counts: List[int]):
    """Every rank's [n_r, W] rows, concatenated in rank order on every
    rank (one padded all_gather)."""
    width = rows.shape[1]
    if max(counts) == 0:
        return rows
    pad = rows.new_zeros((max(counts), width))
    pad[:rows.shape[0]] = rows
    out = gather_blocks(mesh, pad).view(mesh.world_size, max(counts), width)
    return torch.cat([out[r, :n] for r, n in enumerate(counts)])


def make_sharded_aligner(mesh: Mesh, aligner) -> Callable[[Reads],
                                                          ShardedRecords]:
    """The data-parallel read aligner: align(reads) -> ShardedRecords.

    Every rank passes the same reads and its own ReadAligner on
    mesh.device (the genome and seed index replicated).  The pairs are
    padded to a multiple of the world size (shard_reads_pairwise) and rank
    r aligns the r-th contiguous slice with aligner.align.  The records
    come back to every rank with global pair ids, in rank order, so in
    pair order.  align's batch shape rule (P from the batch's pair count)
    sets the DP capacity past which candidates are shed, so, as in the JAX
    package, the split is part of the output: it equals the single-rank
    align when no batch of either sheds candidates."""
    if aligner.genome_p.device != mesh.device:
        raise ValueError(f"the aligner is on {aligner.genome_p.device}, "
                         f"the rank on {mesh.device}")

    def align(reads: Reads) -> ShardedRecords:
        S, r = mesh.world_size, mesh.rank
        data, plens = shard_reads_pairwise(reads.data, reads.lengths, S)
        per = len(plens) // S
        mine = aligner.align(Reads(
            per, reads.max_len, data[2 * r * per:2 * (r + 1) * per],
            plens[r * per:(r + 1) * per]))
        mine.pair_id += r * per
        fields = [(f.name, getattr(mine, f.name),
                   int(np.prod(getattr(mine, f.name).shape[1:])))
                  for f in dataclasses.fields(mine)]
        n = torch.tensor([mine.n], dtype=torch.int64, device=mesh.device)
        counts = gather_blocks(mesh, n).tolist()
        dist.all_reduce(n, group=mesh.group)
        # one int32 row a record: every field's values side by side
        rows = torch.from_numpy(np.concatenate(
            [a.reshape(mine.n, w).astype(np.int32) for _, a, w in fields],
            axis=1)).to(mesh.device)
        rows = _gather_rows(mesh, rows, counts).cpu().numpy()
        out, col = {}, 0
        for name, a, w in fields:
            out[name] = rows[:, col:col + w].reshape(
                (-1,) + a.shape[1:]).astype(a.dtype)
            col += w
        return ShardedRecords(PairAlignments(**out), counts, int(n))

    return align
