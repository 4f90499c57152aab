"""Span-coverage accumulation, PyTorch port of
aligngraph_tpu/parallel/coverage.py's single-device `span_coverage`.

The reference accumulates per-base read coverage with a sequential
`for each alignment: cov[lo:hi] += 1` loop (`loadReadAlignment`,
AlignGraph.cpp:3940-3984).  Here: the coverage of a set of half-open spans
is the cumulative sum of an interval-delta vector (+1 at each start, -1 at
each end), one scatter-add and one prefix scan on the spans' device.
Integer adds commute, so the result does not depend on the scatter order.
"""

from __future__ import annotations

import torch


def span_coverage(starts: torch.Tensor, ends: torch.Tensor,
                  G: int) -> torch.Tensor:
    """coverage[g] = #spans with start <= g < end, for g in [0, G); spans
    are clipped to [0, G] and empty ones add nothing.  -> [G] int32 on the
    spans' device."""
    s = torch.clamp(starts.long(), 0, G)
    e = torch.maximum(torch.clamp(ends.long(), 0, G), s)
    d = torch.zeros(G + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(s, dtype=torch.int32)
    d.index_add_(0, s, one)
    d.index_add_(0, e, -one)
    return torch.cumsum(d[:G], dim=0, dtype=torch.int32)
