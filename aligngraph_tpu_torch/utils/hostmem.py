"""Host memory tuning for sandboxed/virtualized kernels.

On this class of VM, first-touch page faults cost ~150us/page (~7 MB/s
effective bandwidth for fresh allocations) while warm pages run at
GB/s.  glibc malloc serves allocations >=128KB from fresh mmap regions,
so every large numpy temporary pays the fault cost.  Forcing all
allocations onto the (never-trimmed) heap makes freed pages get reused
warm: steady-state large-array numpy goes from ~7 MB/s to ~7 GB/s.

The reference has no analogous subsystem (it runs on bare metal); this
is infrastructure the TPU-host environment needs.
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_tuned = False


def tune_host_malloc() -> bool:
    """Route large allocations to the heap and never return heap pages
    to the kernel.  Idempotent; returns True if mallopt succeeded."""
    global _tuned
    if _tuned:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_MAX, 0))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(-1))) and ok
        _tuned = ok
        return ok
    except Exception:
        return False


def warm_heap(nbytes: int) -> None:
    """Pre-fault heap pages so subsequent allocations are warm.

    Allocates and touches `nbytes` of heap, then frees it; with
    tune_host_malloc() active the pages stay in the process heap and are
    reused by later numpy allocations at warm-memory speed."""
    import numpy as np

    tune_host_malloc()
    block = np.empty(nbytes, np.uint8)
    block[::4096] = 1          # touch every page
    del block
