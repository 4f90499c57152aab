"""Host memory readings of the pipeline's stages, and the heap trim.

With utils/hostmem.tune_host_malloc every allocation comes from the heap
and freed pages stay in the process, so its RSS is the heap's high-water
mark.  These readings split that figure: the RSS now, the bytes that
malloc holds for live allocations (mallinfo2), and the bytes of named
objects' arrays.  trim() hands the heap's free pages back to the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


@functools.lru_cache(maxsize=None)
def _libc():
    try:
        return ctypes.CDLL("libc.so.6")
    except OSError:
        return None


def rss_bytes() -> int:
    """The process's resident set size now (/proc/self/statm), 0 where
    there is no /proc."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        return 0


def heap_in_use_bytes() -> Optional[int]:
    """Bytes malloc holds for live allocations over all arenas, mmapped
    chunks included (glibc's mallinfo2); None without it."""
    libc = _libc()
    if libc is None or not hasattr(libc, "mallinfo2"):
        return None
    libc.mallinfo2.restype = _MallInfo2
    m = libc.mallinfo2()
    return int(m.uordblks + m.hblkhd)


def trim() -> None:
    """malloc_trim(0): return every free heap page to the kernel."""
    libc = _libc()
    if libc is not None and hasattr(libc, "malloc_trim"):
        libc.malloc_trim(ctypes.c_size_t(0))


def host_bytes(obj, _seen=None) -> int:
    """Bytes of the host arrays that obj holds: numpy arrays (a view
    counts its root array) and CPU tensors' storages, alone or inside
    dataclasses, lists, tuples and dicts; each array once."""
    seen = set() if _seen is None else _seen
    if isinstance(obj, np.ndarray):
        while isinstance(obj.base, np.ndarray):
            obj = obj.base
        key, nbytes = ("array", id(obj)), obj.nbytes
    elif isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            return 0
        s = obj.untyped_storage()
        key, nbytes = ("tensor", s.data_ptr()), s.nbytes()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(host_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    elif isinstance(obj, (list, tuple)):
        return sum(host_bytes(v, seen) for v in obj)
    elif isinstance(obj, dict):
        return sum(host_bytes(v, seen) for v in obj.values())
    else:
        return 0
    if key in seen:
        return 0
    seen.add(key)
    return int(nbytes)
