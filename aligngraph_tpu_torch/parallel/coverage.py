"""Span-coverage accumulation, single-device and position-sharded: the
PyTorch port of aligngraph_tpu/parallel/coverage.py.

The reference accumulates per-base read coverage with a sequential
`for each alignment: cov[lo:hi] += 1` loop (`loadReadAlignment`,
AlignGraph.cpp:3940-3984).  Here: the coverage of a set of half-open spans
is the cumulative sum of an interval-delta vector (+1 at each start, -1 at
each end), one scatter-add and one prefix scan on the spans' device.
Integer adds commute, so the result does not depend on the scatter order.

Over a torch.distributed group (records data-parallel, position axis
sharded, parallel/mesh.py), make_sharded_coverage:
  1. each rank scatter-adds ITS spans' deltas into a full-length [G]
     vector
  2. reduce_scatter sums the vectors across ranks while scattering the
     position axis (JAX: psum_scatter)
  3. rank-local inclusive cumsum
  4. the exclusive prefix of the ranks' totals (all_gather) closes the
     scan across the cuts: spans that cross a cut are exact
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from aligngraph_tpu_torch.parallel.mesh import gather_blocks


def _deltas(starts: torch.Tensor, ends: torch.Tensor, G: int) -> torch.Tensor:
    """Interval-delta vector [G + 1] int32 of half-open spans clipped to
    [0, G]; empty spans add nothing."""
    s = torch.clamp(starts.long(), 0, G)
    e = torch.maximum(torch.clamp(ends.long(), 0, G), s)
    d = torch.zeros(G + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(s, dtype=torch.int32)
    d.index_add_(0, s, one)
    d.index_add_(0, e, -one)
    return d


def span_coverage(starts: torch.Tensor, ends: torch.Tensor,
                  G: int) -> torch.Tensor:
    """coverage[g] = #spans with start <= g < end, for g in [0, G); spans
    are clipped to [0, G] and empty ones add nothing.  -> [G] int32 on the
    spans' device."""
    return torch.cumsum(_deltas(starts, ends, G)[:G], dim=0,
                        dtype=torch.int32)


def span_coverage_np(starts: np.ndarray, ends: np.ndarray,
                     G: int) -> np.ndarray:
    """NumPy oracle (same semantics)."""
    s = np.clip(starts, 0, G)
    e = np.clip(ends, 0, G)
    e = np.maximum(e, s)
    d = np.zeros(G + 1, np.int64)
    np.add.at(d, s, 1)
    np.add.at(d, e, -1)
    return np.cumsum(d[:G]).astype(np.int32)


def make_sharded_coverage(mesh, G: int) -> Callable[[torch.Tensor,
                                                     torch.Tensor],
                                                    torch.Tensor]:
    """Position-sharded coverage over mesh (parallel/mesh.Mesh): returns
    fn(starts, ends), where starts/ends are this rank's spans on
    mesh.device, and fn gives this rank's block of the coverage: positions
    [rank * G / S, (rank + 1) * G / S), int32 on mesh.device.  Every rank
    calls fn together.  G must be a multiple of the world size S."""
    S = mesh.world_size
    if G % S:
        raise ValueError(f"G={G} not a multiple of the world size {S}")

    def fn(starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        d = _deltas(starts, ends, G)[:G]
        d_loc = torch.empty(G // S, dtype=torch.int32, device=d.device)
        dist.reduce_scatter_tensor(d_loc, d, group=mesh.group)
        c_loc = torch.cumsum(d_loc, dim=0, dtype=torch.int32)
        totals = gather_blocks(mesh, c_loc[-1:])
        return c_loc + totals[:mesh.rank].sum(dtype=torch.int32)

    return fn


def pad_spans(starts: np.ndarray, ends: np.ndarray, n_shards: int):
    """Pad span lists to a multiple of n_shards (pad spans are empty)."""
    N = len(starts)
    tgt = -(-max(N, 1) // n_shards) * n_shards
    if tgt != N:
        starts = np.concatenate([starts, np.zeros(tgt - N, starts.dtype)])
        ends = np.concatenate([ends, np.zeros(tgt - N, ends.dtype)])
    return starts, ends
