"""Position-axis sharding with halo exchange over a torch.distributed group:
the port of aligngraph_tpu/parallel/halo.py.

The reference cuts each chromosome into parts with no overlap: contigs and
k-mer windows spanning a cut are lost (SURVEY.md §5).  With the position
axis split into contiguous blocks, one a rank (parallel/mesh.py), a
halo exchange hands each block `halo` rows of its neighbours, so k-wide
windows stay intact across the cuts.

JAX's `ppermute` sends on a ring and then zeroes what crossed the ends;
here no message crosses them: edge ranks keep zero halos and, at world
size 1, no P2P call is made at all (NCCL has no send to self, and
batch_isend_irecv refuses an empty list).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def exchange_halos(x: torch.Tensor, mesh, halo: int) -> torch.Tensor:
    """This rank's block x [n_local, ...] with `halo` rows of each
    neighbour on either side: [halo + n_local + halo, ...].  Edge ranks
    get zeros beyond the genome's ends.  Every rank calls it together,
    with blocks of one shape."""
    n = x.shape[0]
    if not 0 <= halo <= n:
        raise ValueError(f"halo {halo} must be in [0, {n}] (the block)")
    from_left = torch.zeros_like(x[:halo])
    from_right = torch.zeros_like(x[:halo])
    r, S = mesh.rank, mesh.world_size
    ops = []
    if halo and r > 0:
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(),
                           mesh.peer(r - 1), mesh.group),
                dist.P2POp(dist.irecv, from_left, mesh.peer(r - 1),
                           mesh.group)]
    if halo and r < S - 1:
        ops += [dist.P2POp(dist.isend, x[n - halo:].contiguous(),
                           mesh.peer(r + 1), mesh.group),
                dist.P2POp(dist.irecv, from_right, mesh.peer(r + 1),
                           mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_left, x, from_right])


def sliding_window_sum_sharded(mesh, window: int) -> Callable[
        [torch.Tensor], torch.Tensor]:
    """A position-sharded sliding-window sum (an archetype of the k-mer
    window ops of the graph build): fn(x) on this rank's block gives
    result[i] = sum of x[i : i + window] over the whole axis, for this
    block's positions; windows past the genome's end sum what is there."""
    halo = window - 1

    def fn(x: torch.Tensor) -> torch.Tensor:
        padded = exchange_halos(x, mesh, halo)
        n = x.shape[0]
        out = torch.zeros_like(x)
        for w in range(window):
            out += padded[halo + w:halo + w + n]
        return out

    return fn
