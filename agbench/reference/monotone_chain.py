"""The contig aligner's chain DP over M-blocks, plain torch.

Frozen copy of aligngraph_tpu_torch/ops/monotone_chain.py at commit 5fa5dc4:
_check and monotone_chain_plain.
It imports nothing of the port, so that later changes to the program
are held to these semantics.
"""
from __future__ import annotations

import numpy as np
import torch


def _check(t0, t1, w, offsets) -> None:
    n = t0.shape[0] if t0.dim() == 1 else -1
    for name, t in (("t0", t0), ("t1", t1), ("w", w), ("offsets", offsets)):
        if t.device != t0.device:
            raise ValueError(f"{name} on {t.device}, t0 on {t0.device}")
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int64 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if tuple(t1.shape) != (n,) or tuple(w.shape) != (n,) \
            or offsets.numel() < 1:
        raise ValueError(f"t0, t1, w must have one length and offsets at "
                         f"least one entry: {tuple(t0.shape)}, "
                         f"{tuple(t1.shape)}, {tuple(w.shape)}, "
                         f"{tuple(offsets.shape)}")


def monotone_chain_plain(t0, t1, w, offsets):
    """-> (best, parent, trim, keep): contig_aligner._chain_dp's per-i
    loop in torch, step i taken by every placement at once, then the
    parent walk.  The placements are laid out as rows of [Q, max m]
    (longest first, so the ones still stepping at step i are the first
    rows); argmax along a row gives the first j of largest gain."""
    _check(t0, t1, w, offsets)
    dev = w.device
    best = w.clone()
    parent = torch.full_like(w, -1)
    trim = torch.zeros_like(w)
    keep = torch.zeros(w.shape, dtype=torch.bool, device=dev)
    m = offsets[1:] - offsets[:-1]
    if w.numel() == 0 or m.numel() == 0:
        return best, parent, trim, keep
    m, order = torch.sort(m, descending=True, stable=True)
    m_host = m.tolist()
    M = m_host[0]
    col = torch.arange(M, device=dev)
    valid = col[None, :] < m[:, None]
    flat = (offsets[:-1][order][:, None] + col[None, :])[valid]
    T0, T1, W = (torch.zeros(valid.shape, dtype=torch.int64, device=dev)
                 for _ in range(3))
    T0[valid], T1[valid], W[valid] = t0[flat], t1[flat], w[flat]
    B = W.clone()
    P = torch.full_like(B, -1)
    R = torch.zeros_like(B)
    # rows still stepping at step i: those with m > i
    active = np.searchsorted(-np.asarray(m_host), -np.arange(M), "left")
    for i in range(1, M):
        a = int(active[i])
        ov = (T1[:a, :i] - T0[:a, i:i + 1]).clamp_min(0)
        kept = W[:a, i:i + 1] - ov
        gain = torch.where(kept > 0, B[:a, :i] + kept, -1)
        j = torch.argmax(gain, dim=1, keepdim=True)   # first max
        g = gain.gather(1, j)[:, 0]
        up = g > B[:a, i]
        B[:a, i] = torch.where(up, g, B[:a, i])
        P[:a, i] = torch.where(up, j[:, 0], P[:a, i])
        R[:a, i] = torch.where(up, ov.gather(1, j)[:, 0], R[:a, i])
    # the parent walk from each row's first argmax of best
    rows = torch.arange(len(m_host), device=dev)
    K = torch.zeros_like(valid)
    low = torch.iinfo(torch.int64).min
    cur = torch.argmax(torch.where(valid, B, low), dim=1)
    for step in range(M):
        if step % 64 == 0 and not bool((cur >= 0).any()):
            break
        live = cur >= 0
        at = cur.clamp_min(0)
        K[rows, at] |= live
        cur = torch.where(live, P[rows, at], -1)
    best[flat], parent[flat], trim[flat], keep[flat] = (
        B[valid], P[valid], R[valid], K[valid])
    return best, parent, trim, keep

