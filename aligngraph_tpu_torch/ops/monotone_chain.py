"""The contig aligner's chain DP over M-blocks, many placements at once.

A placement's M-blocks (target spans [t0, t1), weights w, in query order)
are chained into the maximum-weight strictly increasing chain, a
successor's target overlap with its predecessor trimmed off its front
(align/contig_aligner._enforce_monotone, which runs it one placement at a
time).  The batch is in CSR form: int64 t0, t1, w over all blocks, the
placements back to back, and int64 offsets [Q + 1] (placement p's blocks
are offsets[p]..offsets[p+1]-1).  Out: int64 best, parent, trim and bool
keep per block, keep marking the parent walk from the first argmax of
best in each placement.

  monotone_chain_cuda    the hand-written kernel, csrc/monotone_chain.cu,
                         on the launch plan of chain_plan: longest
                         placements first, the longest on thread-block
                         clusters, the shortest a warp each, int32 where
                         the plan proves it exact
  monotone_chain_plain   the same in plain PyTorch: the per-i vectorised
                         loop of contig_aligner._chain_dp, each step taken
                         by every placement at once, and the parent walk
  monotone_chain         dispatch by the tensors' device: CUDA tensors
                         launch the kernel (or raise), CPU tensors take
                         the plain version

No Pallas kernel computes this: the JAX package runs the loop on the host
(aligngraph_tpu/align/contig_aligner.py:185-196).  The wrapper counts its
calls (one or two launches each: clusters, then CTAs and warps) and the
placements they ran on in LAUNCHES / LANES (chip_smoke.py reads them).
The kernel's sizes (B, the shared-memory capacities, the cluster and its
threshold) are defined once, in csrc/monotone_chain.cu: kernel_limits
asks the built library, source_limits reads the source.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import threading

import numpy as np
import torch

from aligngraph_tpu_torch.ops import _build

LAUNCHES = {"chain": 0}
LANES = {"chain": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["chain"] = 0
        LANES["chain"] = 0


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


# the kernel's sizes, as ag_monotone_chain_limits reports them: the DP's
# steps a block (B, a row a lane), the rows (c, t1) a CTA keeps in shared
# memory in int32 and in int64, the cluster's CTAs, the block count past
# which a placement runs on a cluster, and a CTA's threads
LIMIT_NAMES = ("rows", "smem_rows32", "smem_rows64", "cluster",
               "cluster_from", "threads")
# the constant of csrc/monotone_chain.cu that defines each
_LIMIT_SOURCE = {"rows": "kRows", "smem_rows32": "kSmemRows32",
                 "smem_rows64": "kSmemRows64", "cluster": "kCluster",
                 "cluster_from": "kClusterFrom"}
INT32_LIMIT = 1 << 31


def kernel_limits() -> dict:
    """The built kernel's sizes (builds and loads the library; asked once
    a library)."""
    lib = _build.load_library()
    if id(lib) not in _kernel_limits:
        buf = (ctypes.c_int * len(LIMIT_NAMES))()
        n = lib.ag_monotone_chain_limits(buf, len(buf))
        _kernel_limits[id(lib)] = dict(zip(LIMIT_NAMES[:n], buf[:n]))
    return _kernel_limits[id(lib)]


_kernel_limits = {}


def source_limits() -> dict:
    """The same sizes read from csrc/monotone_chain.cu's text, for a
    machine without nvcc (no "threads": it is computed there)."""
    text = (_build.CSRC_DIR / "monotone_chain.cu").read_text()
    out = {}
    for key, name in _LIMIT_SOURCE.items():
        hit = re.search(rf"^constexpr int {name} = (\d+);$", text, re.M)
        if hit is None:
            raise RuntimeError(f"{name} not found in monotone_chain.cu")
        out[key] = int(hit.group(1))
    return out


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How one call is launched.  order lists the placements by block
    count, longest first (stable); its first n_cluster run on a cluster
    each, the next n_cta on a CTA each, the last n_warp (m <= rows) on a
    warp each.  lo is what each placement's targets are rebased on.  wide:
    the int64 instantiation, because some placement's span of targets (its
    max t0 or t1 less its min) or its sum of w reaches 2^31; exact says
    whether that was settled placement by placement (else the whole
    batch's span and w sum, both < 2^31, proved int32 for all)."""
    order: torch.Tensor
    lo: torch.Tensor
    n_cluster: int
    n_cta: int
    n_warp: int
    max_m: int
    max_m_cluster: int
    max_m_cta: int
    wide: bool
    exact: bool


def placement_bounds(t0, t1, w, offsets):
    """-> (lo, span, wsum) per placement (0 for an empty one): the least
    t0 or t1, the greatest less it, the sum of w."""
    q = offsets.numel() - 1
    dev = offsets.device
    m = offsets[1:] - offsets[:-1]
    seg = torch.repeat_interleave(torch.arange(q, device=dev), m,
                                  output_size=w.numel())
    i64 = torch.iinfo(torch.int64)
    lo = torch.full((q,), i64.max, dtype=torch.int64, device=dev)
    hi = torch.full((q,), i64.min, dtype=torch.int64, device=dev)
    lo.scatter_reduce_(0, seg, torch.minimum(t0, t1), "amin")
    hi.scatter_reduce_(0, seg, torch.maximum(t0, t1), "amax")
    live = m > 0
    lo = torch.where(live, lo, 0)
    span = torch.where(live, hi, 0) - lo
    wsum = torch.zeros(q, dtype=torch.int64, device=dev).scatter_add_(
        0, seg, w)
    return lo, span, wsum


def chain_plan(t0, t1, w, offsets, limits: dict) -> ChainPlan:
    """The launch plan of monotone_chain_cuda on the inputs' device, with
    one copy to the host: the block counts sorted (longest first), the
    least and greatest t0 and t1, the sum and the least of w.  When the
    whole batch's target span and w sum are < 2^31 every placement's are,
    and all rebase on the batch's least target; else placement_bounds
    decides placement by placement (a second copy).  Raises on a w < 1,
    which the kernel's dropping of gains of -1 needs (M-blocks have w >=
    1)."""
    q = offsets.numel() - 1
    m, order = torch.sort(offsets[1:] - offsets[:-1], descending=True,
                          stable=True)
    host = torch.cat([m, torch.stack([*torch.aminmax(t0), *torch.aminmax(t1),
                                      w.sum(), w.min()])]).cpu().numpy()
    m = host[:q]
    lo0, hi0, lo1, hi1, wsum, min_w = host[q:].tolist()
    if min_w < 1:
        raise ValueError(f"monotone_chain_cuda: every w must be >= 1 (an "
                         f"M-block's length), got {min_w}")
    # m descends: the counts past a size are where -m passes -size
    n_cluster = int(np.searchsorted(-m, -limits["cluster_from"], "left"))
    n_long = int(np.searchsorted(-m, -limits["rows"], "left"))
    lo_all = min(lo0, lo1)
    exact = max(hi0, hi1) - lo_all >= INT32_LIMIT or wsum >= INT32_LIMIT
    if exact:
        lo, span, wsum_p = placement_bounds(t0, t1, w, offsets)
        wide = bool(torch.maximum(span.max(), wsum_p.max()) >= INT32_LIMIT)
    else:
        lo = torch.full((q,), lo_all, dtype=torch.int64, device=w.device)
        wide = False
    return ChainPlan(
        order=order, lo=lo, n_cluster=n_cluster, n_cta=n_long - n_cluster,
        n_warp=q - n_long, max_m=int(m[0]),
        max_m_cluster=int(m[0]) if n_cluster else 0,
        max_m_cta=int(m[n_cluster]) if n_cluster < q else 0, wide=wide,
        exact=exact)


def needs_scratch(plan: ChainPlan, limits: dict) -> bool:
    """Whether the plan's longest cluster placement keeps more rows (c, t1)
    on a rank than a CTA's shared memory holds in the plan's type: its
    rows then live in scratch rows in device memory (the kernel makes the
    same test, and refuses a launch that needs them without them)."""
    rows = limits["rows"]
    blocks = -(-plan.max_m_cluster // rows)
    per_rank = -(-blocks // limits["cluster"]) * rows
    return per_rank > limits["smem_rows64" if plan.wide else "smem_rows32"]


def monotone_chain_cuda(t0, t1, w, offsets):
    """The kernel on CUDA tensors -> (best, parent, trim, keep); raises on
    anything else, on a w < 1 and when a launch fails.  chain_plan makes
    the launch plan (one small copy to the host); the kernel runs in at
    most two launches (clusters, then CTAs and warps)."""
    _check(t0, t1, w, offsets)
    dev = t0.device
    if dev.type != "cuda":
        raise ValueError(f"monotone_chain_cuda: expected CUDA tensors, got "
                         f"{dev}")
    q = offsets.numel() - 1
    if q >= INT32_LIMIT or w.numel() >= INT32_LIMIT:
        raise ValueError(f"monotone_chain_cuda: {q} placements, "
                         f"{w.numel()} blocks: past int32")
    if q == 0 or w.numel() == 0:
        keep = torch.empty(w.shape, dtype=torch.bool, device=dev)
        return (*(torch.empty_like(w) for _ in range(3)), keep)
    return _launch(t0, t1, w, offsets,
                   chain_plan(t0, t1, w, offsets, kernel_limits()))


def _launch(t0, t1, w, offsets, plan: ChainPlan):
    """The kernel's launches on checked, non-empty CUDA inputs and their
    plan (chain_plan's) -> (best, parent, trim, keep), counted in LAUNCHES
    and LANES.  chip_smoke.py times the kernel alone through it."""
    dev = t0.device
    q = offsets.numel() - 1
    best, parent, trim = (torch.empty_like(w) for _ in range(3))
    keep = torch.empty(w.shape, dtype=torch.bool, device=dev)
    # a row (c, t1) of the DP type a block
    scratch = (torch.empty(2 * w.numel(), device=dev, dtype=torch.int64
                           if plan.wide else torch.int32)
               if needs_scratch(plan, kernel_limits()) else None)
    err = _build.load_library().ag_monotone_chain(
        t0.data_ptr(), t1.data_ptr(), w.data_ptr(), offsets.data_ptr(),
        plan.order.data_ptr(), plan.lo.data_ptr(), best.data_ptr(),
        parent.data_ptr(), trim.data_ptr(), keep.data_ptr(),
        None if scratch is None else scratch.data_ptr(), plan.n_cluster,
        plan.n_cta, plan.n_warp, plan.max_m_cluster, plan.max_m_cta,
        int(plan.wide), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"monotone_chain launch failed with CUDA error "
                           f"{err}")
    with _count_lock:
        LAUNCHES["chain"] += 1
        LANES["chain"] += q
    return best, parent, trim, keep


def monotone_chain(t0, t1, w, offsets):
    """Dispatch by device: CUDA tensors take the kernel, CPU tensors the
    plain version."""
    if t0.device.type == "cuda":
        return monotone_chain_cuda(t0, t1, w, offsets)
    if t0.device.type != "cpu":
        raise ValueError(f"no chain DP path for device {t0.device}")
    return monotone_chain_plain(t0, t1, w, offsets)
