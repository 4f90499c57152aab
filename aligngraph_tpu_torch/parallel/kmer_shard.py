"""Position-sharded k-mer graph build over a torch.distributed group: the
port of aligngraph_tpu/parallel/kmer_shard.py.

The km_*/ed_* state is split along the position axis into contiguous
blocks of n_local = ceil(n_pos / S) positions, one a rank (its owner);
the records of each chunk are split into contiguous slices, one a rank
(its producer).  Each chunk is one step of the device build's phases
(graph/kmer_layer_jit.py) with the merge traffic on all_to_all:

  1. each rank emits tuples and anchor-combo rows for its slice of the
     chunk; arrival counts from the chunk's first record, so it orders
     tuples across the whole chunk (int64, as the device build keeps it)
  2. rows go to the owner of their position (all_to_all_single with
     uneven splits, the per-destination counts exchanged first)
  3. each owner groups the rows it received and runs the first-fit
     assign/create rounds on its block; grouping and rounds order by
     (position, signature, arrival), so they decide as one device would
  4. owners answer each row with its slot and that slot's four anchors,
     in the order they received them; the reverse all_to_all (splits
     swapped) returns them to each producer in the order it sent them,
     and the producer undoes its own send permutation
  5. producers build the edge candidates and send them to the owner of
     the source position, which dedups, gates and appends them

No capacity bounds rows, groups or edges (the JAX build's [S, cap]
buckets raise on skewed load), and first-fit is stable (slots
append-only, anchors immutable), so the graph equals the host oracle's
for any world size and chunking; the statistics equal those of the
device build with the same chunk_records (chunk_records=None: one chunk
of all records, as the JAX build runs).  cmpack, the contig layer's
read-only anchor table, is replicated.

JAX adds `shard * Ms * L * 4` to an int32 arrival, which wraps past ~33M
padded record-bases; here arrival and the edge key stay int64, so above
the wrap this build equals the host oracle and JAX's does not.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aligngraph_tpu_torch.config import EP
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
from aligngraph_tpu_torch.graph.kmer_layer import KmerBuildStats
from aligngraph_tpu_torch.graph.model import GraphTensors
from aligngraph_tpu_torch.parallel.mesh import gather_blocks

I32 = torch.int32
I64 = torch.int64


def _route(mesh, payload: torch.Tensor, owner: torch.Tensor):
    """Send each row of payload [R, F] int64 to rank owner[row].  Returns
    (rows received [R', F], from rank 0's first to the last's, each
    producer's in its own order; the plan that _route_back needs)."""
    S = mesh.world_size
    perm = torch.argsort(owner, stable=True)
    send = torch.bincount(owner, minlength=S)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    send_l, recv_l = send.tolist(), recv.tolist()
    out = payload.new_empty((sum(recv_l), payload.shape[1]))
    dist.all_to_all_single(out, payload[perm], recv_l, send_l,
                           group=mesh.group)
    return out, (perm, send_l, recv_l)


def _route_back(mesh, payload: torch.Tensor, plan) -> torch.Tensor:
    """Return one row of payload [R', F] for each row _route received, in
    the order received, to its producer: the producer's rows come back in
    the order of the payload it routed."""
    perm, send_l, recv_l = plan
    back = payload.new_empty((sum(send_l), payload.shape[1]))
    dist.all_to_all_single(back, payload.contiguous(), send_l, recv_l,
                           group=mesh.group)
    out = torch.empty_like(back)
    out[perm] = back
    return out


def _sharded_chunk(mesh, state, cmpack, p1, p2, s1, lens, keep, *,
                   rec0: int, k: int, win: int, n_pos: int,
                   n_local: int) -> torch.Tensor:
    """One chunk: this rank's slice (records from rec0 of the chunk on) as
    producer, its position block as owner, state updated in place.
    Returns this rank's (tuples, rows, groups, dropped_slots,
    dropped_edges) as an int64 tensor."""
    lo = mesh.rank * n_local
    tup, rows, valid1, valid2, R1 = kj._emit_rows(
        cmpack, n_pos, p1, p2, s1, lens, keep, k, rec0)

    # rows to the owners of their positions
    payload = torch.stack([rows[f].to(I64) for f in kj.ROW_FIELDS], 1)
    owner = rows["pos"].long().clamp(0, n_pos - 1) // n_local
    got, plan = _route(mesh, payload, owner)
    mine = {f: got[:, i] if f == "arrival" else got[:, i].to(I32)
            for i, f in enumerate(kj.ROW_FIELDS)}
    mine["pos"] = mine["pos"] - lo
    order, gid, grp = kj._group(mine)
    g_slot, dslots = kj._rounds(state, grp, n_local, win)

    # each received row's slot and that slot's anchors, back to its producer
    row_slot = torch.empty_like(gid)
    row_slot[order] = g_slot[gid]
    posc = mine["pos"].clamp(0, n_local - 1)
    has = row_slot >= 0
    slot_c = row_slot.clamp(min=0)
    answer = torch.stack(
        [row_slot] + [torch.where(has, state[f][posc, slot_c].long(), -1)
                      for f in kj.ANCHORS], 1)
    back = _route_back(mesh, answer, plan)

    # edge candidates to the owners of their source positions
    cand, (b, t) = kj._edge_candidates(
        tup, valid1, valid2, kj._on_grid(back[:R1, 0], valid1),
        kj._on_grid(back[R1:, 0], valid2))
    dst = [kj._on_grid(back[R1:, 1 + i], valid2)[b, t]
           for i in range(len(kj.ANCHORS))]
    epay = torch.stack(list(cand) + dst, 1)
    eowner = cand[0].clamp(0, n_pos - 1) // n_local
    egot, _ = _route(mesh, epay, eowner)
    sp, ss, dp, ds, ea = (egot[:, i] for i in range(5))
    dedges = kj._append_edges(state, sp - lo, ss, dp, ds, ea,
                              [egot[:, 5 + i] for i in range(4)], n_local,
                              win)
    return torch.stack([
        torch.tensor(tup["cur"].numel(), device=dslots.device),
        torch.tensor(rows["pos"].numel(), device=dslots.device),
        torch.tensor(grp["pos"].numel(), device=dslots.device),
        dslots.to(I64), dedges.to(I64)])


def _slices(n: int, chunk: int, S: int, rank: int) -> List[Tuple[int, int,
                                                                  int]]:
    """For each chunk of `chunk` records out of n: (chunk start, this
    rank's first and end record), ranks taking contiguous slices of
    ceil(chunk size / S) records."""
    out = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        per = -(-(e - s) // S)
        a = min(s + rank * per, e)
        out.append((s, a, min(a + per, e)))
    return out


def build_kmer_layer_sharded(g: GraphTensors, pairs, reads, k: int,
                             insert_variation: int, mesh,
                             part_offset: int = 0,
                             stats: Optional[KmerBuildStats] = None,
                             chunk_records: Optional[int] = None
                             ) -> KmerBuildStats:
    """Drop-in for build_kmer_layer with the merge position-sharded over
    mesh (parallel/mesh.Mesh); every rank calls it together with the same
    g, pairs and reads.  Phase 0 runs on mesh.device of every rank: the
    duplicate-placement skip over all records (kj.phase0_skip), then the
    rows of the rank's slice of each chunk (kj.phase0_gather on the host,
    kj.phase0_rows on the device); phases 1-5 too.  At the end the
    owners' blocks are gathered on every rank and every rank's g holds
    the whole k-mer layer; the statistics are summed over the ranks.

    chunk_records=None runs all records as one chunk (the JAX build's one
    step); chunk_records=c splits each chunk of c records across the
    ranks and gives the statistics of build_kmer_layer_device(...,
    chunk_records=c) at any world size."""
    if k > kj.MAX_K:
        raise ValueError(f"k-mer size {k} > {kj.MAX_K}: the 3-bit k-mer "
                         f"packing holds at most {kj.MAX_K} bases")
    st = stats or KmerBuildStats()
    if pairs.n == 0:
        return st
    dev, S = mesh.device, mesh.world_size
    rows = np.arange(pairs.n)
    skip = kj.phase0_skip(pairs, rows, part_offset, g.part_len, device=dev)
    if pairs.pos_map.shape[2] - k <= 0:
        return st
    n_pos = int(g.km_cnt.shape[0])
    assert n_pos < (1 << 30)
    n_local = -(-n_pos // S)
    cmpack = kj._cmpack(g, dev)
    state = kj._state_from_graph(g, dev, mesh.rank * n_local, n_local)
    win = 2 * insert_variation + 5 * EP
    counts = torch.zeros(5, dtype=I64, device=dev)
    for s, a, b in _slices(pairs.n, chunk_records or pairs.n, S, mesh.rank):
        args = kj.phase0_rows(
            *kj.phase0_gather(pairs, rows, reads, a, b, device=dev),
            skip[a:b], k, part_offset, g.part_len)
        counts += _sharded_chunk(mesh, state, cmpack, *args, rec0=a - s,
                                 k=k, win=win, n_pos=n_pos, n_local=n_local)
    dist.all_reduce(counts, group=mesh.group)
    kj._state_to_graph({f: gather_blocks(mesh, state[f][:n_local])
                        for f in kj.STATE_FIELDS}, g)
    tuples, rows, groups, dslots, dedges = counts.tolist()
    st.tuples += tuples
    st.rows += rows
    st.groups += groups
    st.dropped_slots += dslots
    st.dropped_edges += dedges
    return st
