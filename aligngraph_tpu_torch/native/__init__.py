"""Native (C++) components: build-on-first-use with g++, ctypes bindings.

`extd_contigs1_native(g)` is a drop-in for graph.traverse.extd_contigs1
(the sequential walk is the hottest host-side loop; C++ is ~1000x the
Python oracle).  Falls back to None when no toolchain is available —
callers then use the Python implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# the libraries are built into the package's git-ignored _build/, never
# next to their sources
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIBS: dict = {}


def _build(name: str, src_name: str) -> Optional[str]:
    so = os.path.join(_BUILD_DIR, name)
    src = os.path.join(_HERE, src_name)
    if os.path.exists(so) and os.path.getmtime(so) >= \
            os.path.getmtime(src):
        return so
    # g++ writes a temporary name and the rename is atomic, so a process
    # building the same library at the same time never loads half of it
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def _load(key: str, so_name: str, src_name: str, setup):
    if key not in _LIBS:
        so = _build(so_name, src_name)
        lib = None
        if so:
            try:
                lib = ctypes.CDLL(so)
                setup(lib)
            except Exception:
                lib = None
        _LIBS[key] = lib
    return _LIBS[key]


def get_lib():
    def setup(lib):
        lib.ag_extd_contigs1.restype = ctypes.c_int64
    return _load("traverse", "libagtraverse.so", "traverse.cpp", setup)


def get_fasta_lib():
    def setup(lib):
        lib.ag_parse_fasta.restype = ctypes.c_int64
    return _load("fasta", "libagfasta.so", "fastaio.cpp", setup)


def get_chain_lib():
    return _load("chain", "libagchain.so", "chain.cpp", lambda lib: None)


def monotone_chain_native(t0: np.ndarray, t1: np.ndarray, w: np.ndarray):
    """C++ chain DP of contig_aligner._enforce_monotone over int64 block
    arrays -> (best, parent, trim), or None if the library is
    unavailable."""
    lib = get_chain_lib()
    if lib is None:
        return None
    m = len(w)
    t0, t1, w = (np.ascontiguousarray(a, np.int64) for a in (t0, t1, w))
    out = [np.empty(m, np.int64) for _ in range(3)]
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.ag_monotone_chain(ctypes.c_int64(m),
                          *(a.ctypes.data_as(p64) for a in (t0, t1, w, *out)))
    return tuple(out)


def read_fasta_native(path):
    """C++ FASTA parse -> (ids, seqs bytes) or None if unavailable."""
    lib = get_fasta_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    max_rec = max(1024, data.count(b">") + 1)
    seq_buf = np.zeros(n, np.int8)
    hdr_buf = np.zeros(n, np.int8)
    seq_off = np.zeros(max_rec + 1, np.int64)
    hdr_off = np.zeros(max_rec + 1, np.int64)
    rc = lib.ag_parse_fasta(
        data, ctypes.c_int64(n),
        seq_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hdr_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        hdr_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(max_rec))
    if rc < 0:
        return None
    nrec = int(rc)
    sb = seq_buf.tobytes()
    hb = hdr_buf.tobytes()
    ids = [hb[hdr_off[i]:hdr_off[i + 1]].decode() for i in range(nrec)]
    seqs = [sb[seq_off[i]:seq_off[i + 1]] for i in range(nrec)]
    return ids, seqs


def extd_contigs1_native(g, coverage: int, k: int):
    """C++ walk over GraphTensors -> List[PreContig] (or None if no lib).

    Applies filter_low_coverage first (caller's responsibility is matched
    with the Python path by doing it here)."""
    lib = get_lib()
    if lib is None:
        return None
    from aligngraph_tpu_torch.graph.model import E_ED, K_KM, S_CM
    from aligngraph_tpu_torch.graph.traverse import PreContig, \
        filter_low_coverage

    filter_low_coverage(g, coverage)
    n = g.n_pos

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    # contiguous slices limited to the live position range
    def live(a):
        return np.ascontiguousarray(a[:n])

    base = live(g.base)
    cm_cnt = live(g.cm_cnt)
    cm_next = live(g.cm_next)
    cm_nitem = live(g.cm_nitem)
    cm_base = live(g.cm_base)
    cm_coff = live(g.cm_coff)
    km_cnt = live(g.km_cnt)
    km_trav = live(g.km_trav)
    km_coff = live(g.km_coff)
    km_votes = live(g.km_votes)
    km_s = live(g.km_s)
    km_slen = live(g.km_slen)
    km_mate = live(g.km_mate)
    ed_cnt = live(g.ed_cnt)
    ed_pos = live(g.ed_pos)
    ed_item = live(g.ed_item)

    seq_cap = int(n * 2 + (1 << 20))
    max_contigs = int(max(1 << 16, n // 8))
    while True:
        seq_buf = np.zeros(seq_cap, np.int8)
        seq_start = np.zeros(max_contigs, np.int64)
        seq_end = np.zeros(max_contigs, np.int64)
        extended = np.zeros(max_contigs, np.int32)
        s_off = np.zeros(max_contigs, np.uint32)
        e_off = np.zeros(max_contigs, np.uint32)
        s0_id = np.zeros(max_contigs, np.uint32)
        s0_off = np.zeros(max_contigs, np.uint32)
        e0_id = np.zeros(max_contigs, np.uint32)
        e0_off = np.zeros(max_contigs, np.uint32)
        seq_len = np.zeros(1, np.int64)
        trav_copy = km_trav.copy()
        rc = lib.ag_extd_contigs1(
            ctypes.c_int64(n), ctypes.c_int(S_CM), ctypes.c_int(K_KM),
            ctypes.c_int(E_ED),
            ptr(base, ctypes.c_int8),
            ptr(cm_cnt, ctypes.c_int8), ptr(cm_next, ctypes.c_uint32),
            ptr(cm_nitem, ctypes.c_uint32), ptr(cm_base, ctypes.c_int8),
            ptr(cm_coff, ctypes.c_uint32),
            ptr(km_cnt, ctypes.c_int8), ptr(trav_copy, ctypes.c_uint8),
            ptr(km_coff, ctypes.c_uint32), ptr(km_votes, ctypes.c_int32),
            ptr(km_s, ctypes.c_uint32), ptr(km_slen, ctypes.c_int8),
            ptr(km_mate, ctypes.c_uint32),
            ptr(ed_cnt, ctypes.c_int8), ptr(ed_pos, ctypes.c_uint32),
            ptr(ed_item, ctypes.c_uint8),
            ctypes.c_int32(coverage), ctypes.c_int32(k),
            ptr(seq_buf, ctypes.c_int8), ctypes.c_int64(seq_cap),
            ctypes.c_int64(max_contigs),
            ptr(seq_start, ctypes.c_int64), ptr(seq_end, ctypes.c_int64),
            ptr(extended, ctypes.c_int32),
            ptr(s_off, ctypes.c_uint32), ptr(e_off, ctypes.c_uint32),
            ptr(s0_id, ctypes.c_uint32), ptr(s0_off, ctypes.c_uint32),
            ptr(e0_id, ctypes.c_uint32), ptr(e0_off, ctypes.c_uint32),
            ptr(seq_len, ctypes.c_int64))
        if rc < 0:
            need = -rc
            max_contigs = max(max_contigs * 2, int(need) + 1)
            seq_cap = max(seq_cap * 2, int(seq_len[0]) + 1)
            continue
        break
    # commit mutated traversal flags back
    g.km_trav[:n] = trav_copy

    out: List[PreContig] = []
    NONEI = 0xFFFFFFFF
    for i in range(int(rc)):
        out.append(PreContig(
            seq=bytearray(seq_buf[seq_start[i]:seq_end[i]].tobytes()),
            extended=int(extended[i]),
            start_id=0, start_off=int(s_off[i]),
            end_id=0, end_off=int(e_off[i]),
            start0_id=int(s0_id[i]), start0_off=int(s0_off[i]),
            end0_id=int(e0_id[i]), end0_off=int(e0_off[i])))
    return out
