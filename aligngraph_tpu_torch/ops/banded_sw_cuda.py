"""Wrappers of the hand-written Hopper kernels in csrc/banded_sw.cu.

Counterpart of aligngraph_tpu/ops/banded_sw_pallas.py.  Three kernels:

  sw_score_kernel      <- banded_sw_pallas.py:_kernel_score (sw_score_cuda)
  sw_dp_kernel         <- banded_sw_pallas.py:_kernel       (sw_dp_cuda)
  sw_traceback_kernel  <- banded_sw_pallas.py:_tb_kernel    (sw_traceback_cuda)

Each wrapper takes CUDA tensors only and raises on anything else (device,
dtype, shape, contiguity); the plain versions for CPU tensors are in
ops/banded_sw.py.  A wrapper allocates its outputs with torch.empty,
launches on the current stream, does not synchronise, raises if the launch
reported an error, and adds one to its kernel's count in LAUNCHES and
in LAUNCHES_BY_L (by kernel and read length L).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from aligngraph_tpu_torch.ops import _build
from aligngraph_tpu_torch.ops.banded_sw import (
    SWResult, gapless_diag, synth_posmap, traceback_need, traceback_steps,
)

# launches of each kernel, and the lanes (candidates) they ran on, since
# the last reset (chip_smoke.py reads them): in total by kernel, and by
# (kernel, L) in LAUNCHES_BY_L / LANES_BY_L.  The pipeline launches from
# two host threads (read and contig aligners), so updates take the lock.
LAUNCHES = {"score": 0, "dp": 0, "traceback": 0}
LANES = {"score": 0, "dp": 0, "traceback": 0}
LAUNCHES_BY_L: dict = {}
LANES_BY_L: dict = {}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LANES[k] = 0
        LAUNCHES_BY_L.clear()
        LANES_BY_L.clear()


def launches_by_length() -> dict:
    """The counts since the last reset: "kernel L" -> {"launches",
    "lanes"}."""
    with _count_lock:
        return {f"{n} L{L}": {"launches": LAUNCHES_BY_L[(n, L)],
                              "lanes": LANES_BY_L[(n, L)]}
                for (n, L) in sorted(LAUNCHES_BY_L)}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_dp_inputs(reads, rlens, windows, pad: int):
    """-> (B, L, W) after checking the DP kernels' inputs."""
    if reads.dim() != 2:
        raise ValueError(f"reads: expected [B, L], got {tuple(reads.shape)}")
    B, L = reads.shape
    W = 2 * pad
    if not 0 < W <= 32:
        raise ValueError(f"band width 2*pad = {W} must be in 1..32 (one "
                         f"warp holds the band)")
    dev = reads.device
    _check(reads, "reads", torch.int8, (B, L), dev)
    _check(rlens, "rlens", torch.int32, (B,), dev)
    _check(windows, "windows", torch.int8, (B, L + W), dev)
    return B, L, W


def _launch(name: str, L: int, lanes: int, fn, *args) -> None:
    """fn(*args) (a C entry point), raising on its error; then one launch of
    `name` on `lanes` lanes of length L is counted."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    with _count_lock:
        LAUNCHES[name] += 1
        LANES[name] += lanes
        key = (name, L)
        LAUNCHES_BY_L[key] = LAUNCHES_BY_L.get(key, 0) + 1
        LANES_BY_L[key] = LANES_BY_L.get(key, 0) + lanes


def _dev_stream(device: torch.device):
    """(device index, current stream handle) as the C entry points take
    them."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


# cells per lane the score and dp kernels are built for, by band width
# (csrc/banded_sw.cu: with_layout); other widths run one cell a lane
SCORE_CELLS = DP_CELLS = {16: (1, 2, 4, 8), 32: (1, 2, 4, 8)}


def _check_layout(cells_per_lane: Optional[int], pad: int) -> None:
    """Raises unless `cells_per_lane` is None or a layout built for the
    band width 2*pad."""
    built = DP_CELLS.get(2 * pad, (1,))
    if cells_per_lane is not None and cells_per_lane not in built:
        raise ValueError(f"cells_per_lane {cells_per_lane} is not built for "
                         f"band width {2 * pad}: {built}")


def sw_score_cuda(reads, rlens, windows, pad: int,
                  cells_per_lane: Optional[int] = None) -> torch.Tensor:
    """Score-only banded DP -> best local score [B] int32 (the plain
    version is banded_sw(...).score).  `cells_per_lane` names the kernel's
    layout (SCORE_CELLS; for measuring them): None leaves it to the
    kernel."""
    _check_layout(cells_per_lane, pad)
    B, L, W = _check_dp_inputs(reads, rlens, windows, pad)
    score = torch.empty(B, dtype=torch.int32, device=reads.device)
    if B:
        lib = _build.load_library()
        args = (reads.data_ptr(), rlens.data_ptr(), windows.data_ptr(),
                score.data_ptr(), B, L, W)
        if cells_per_lane is None:
            _launch("score", L, B, lib.ag_sw_score, *args,
                    *_dev_stream(reads.device))
        else:
            _launch("score", L, B, lib.ag_sw_score_cells, *args,
                    cells_per_lane, *_dev_stream(reads.device))
    return score


def sw_dp_cuda(reads, rlens, windows, pad: int,
               cells_per_lane: Optional[int] = None):
    """Banded DP with traceback bytes -> (tb [B, L, W] uint8, score,
    best_i, best_b [B] int32).  The tb layout is the kernel's: each lane's
    rows are contiguous.  `cells_per_lane` names the kernel's layout
    (DP_CELLS; for measuring them): None leaves it to the kernel."""
    _check_layout(cells_per_lane, pad)
    B, L, W = _check_dp_inputs(reads, rlens, windows, pad)
    dev = reads.device
    tb = torch.empty((B, L, W), dtype=torch.uint8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    best_i = torch.empty(B, dtype=torch.int32, device=dev)
    best_b = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.load_library()
        args = (reads.data_ptr(), rlens.data_ptr(), windows.data_ptr(),
                tb.data_ptr(), score.data_ptr(), best_i.data_ptr(),
                best_b.data_ptr(), B, L, W)
        if cells_per_lane is None:
            _launch("dp", L, B, lib.ag_sw_dp, *args, *_dev_stream(dev))
        else:
            _launch("dp", L, B, lib.ag_sw_dp_cells, *args, cells_per_lane,
                    *_dev_stream(dev))
    return tb, score, best_i, best_b


def sw_traceback_cuda(tb, best_i, best_b, g0, pad: int) -> torch.Tensor:
    """Traceback walk over tb [B, L, W] (sw_dp_cuda's layout) -> pos_map
    [B, L] int32 (the plain version is banded_sw.sw_traceback)."""
    if tb.dim() != 3:
        raise ValueError(f"tb: expected [B, L, W], got {tuple(tb.shape)}")
    B, L, W = tb.shape
    if W != 2 * pad:
        raise ValueError(f"tb band width {W} != 2*pad = {2 * pad}")
    dev = tb.device
    _check(tb, "tb", torch.uint8, (B, L, W), dev)
    _check(best_i, "best_i", torch.int32, (B,), dev)
    _check(best_b, "best_b", torch.int32, (B,), dev)
    _check(g0, "g0", torch.int32, (B,), dev)
    pos_map = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B:
        lib = _build.load_library()
        _launch("traceback", L, B, lib.ag_sw_traceback, tb.data_ptr(),
                best_i.data_ptr(), best_b.data_ptr(), g0.data_ptr(),
                pos_map.data_ptr(), B, L, W, pad, traceback_steps(L, W),
                *_dev_stream(dev))
    return pos_map


def banded_sw_cuda(reads, rlens, windows, pad: int) -> SWResult:
    """Drop-in for banded_sw (same inputs and outputs) on the dp kernel;
    tb is returned as the [L, B, W] view of the kernel's [B, L, W]."""
    tb, score, best_i, best_b = sw_dp_cuda(reads, rlens, windows, pad)
    return SWResult(score, best_i, best_b, tb.permute(1, 0, 2))


def banded_sw_posmap_cuda(reads, rlens, windows, g0, pad: int):
    """DP + traceback on every lane -> (score [B], pos_map [B, L]); the
    same results as banded_sw + sw_traceback."""
    tb, score, best_i, best_b = sw_dp_cuda(reads, rlens, windows, pad)
    return score, sw_traceback_cuda(tb, best_i, best_b, g0, pad)


def banded_sw_posmap_fast(reads, rlens, windows, g0, pad: int, smin=None):
    """Two-pass DP with the gapless fast path -> (score [B], pos_map [B, L]).

    The score pass runs on every lane.  Lanes whose banded score an
    ungapped run on the seed diagonal attains (most reads), or that score
    below the acceptance floor `smin`, get their pos_map synthesized; the
    dp and traceback kernels then run on exactly the remaining lanes.
    Lanes are independent, so this gives every lane what a full-lane pass
    gives it: the same output as the TPU's compacted/full split
    (banded_sw_pallas.py:459-486) and as the plain composition
    banded_sw.banded_sw_posmap_plain.  Finding the lanes in need reads
    their count on the host."""
    L = reads.shape[1]
    score = sw_score_cuda(reads, rlens, windows, pad)
    gb, gs, ge = gapless_diag(reads, rlens, windows, pad)
    need = traceback_need(score, gb, smin)
    pm = synth_posmap(score, need, gs, ge, g0, L)
    sel = need.nonzero()[:, 0]
    if sel.numel():
        tb, _, best_i, best_b = sw_dp_cuda(reads[sel], rlens[sel],
                                           windows[sel], pad)
        pm[sel] = sw_traceback_cuda(tb, best_i, best_b, g0[sel], pad)
    return score, pm
