"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use, `nvcc` compiles every source under csrc/ into one shared
library with a plain C interface, in aligngraph_tpu_torch/_build/ (listed
in .gitignore): one nvcc process a source, all started together, then
one link.  The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
The library is loaded with ctypes; every entry point's argument types are
declared here (c_void_p for pointers and the stream, c_int for ints).

Nothing here runs at import time: the CPU path never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
ARGTYPES = {
    # reads, rlens, windows, score, B, L, W, device, stream
    "ag_sw_score": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # reads, rlens, windows, score, B, L, W, cells per lane, device, stream
    "ag_sw_score_cells": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # reads, rlens, windows, tb, score, best_i, best_b, B, L, W, device,
    # stream
    "ag_sw_dp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same, then cells per lane, device, stream
    "ag_sw_dp_cells": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tb, best_i, best_b, g0, pos_map, B, L, W, pad, max_steps, device,
    # stream
    "ag_sw_traceback": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # t0, t1, w, offsets, order, lo, best, parent, trim, keep, scratch,
    # n_cluster, n_cta, n_warp, max_m_cluster, max_m_cta, wide, device,
    # stream
    "ag_monotone_chain": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _P],
    # out, n
    "ag_monotone_chain_limits": [_P, _I],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libag_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Runs the commands side by side; raises with the first failure's
    output once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile csrc/*.cu with nvcc unless the library for these sources
    exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(srcs, objs)])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
