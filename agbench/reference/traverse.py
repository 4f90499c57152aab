"""The traversal: the coverage filter, the walk, the merge and the
scaffolds (C20-C23).

Frozen from aligngraph_tpu_torch at commit 5fa5dc4: graph/traverse.py
(filter_low_coverage, extd_contigs2, scaffold_contigs) and the C++ walk
of native/traverse.cpp with its binding (native.extd_contigs1_native),
built with g++ into the checkout's .agbench_cache/reference/ on first
use; the pure-Python walk is left out (about 1000 times slower).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
from pathlib import Path
from typing import List

import numpy as np

from agbench.reference.graph import E_ED, K_KM, NONE32, S_CM, GraphTensors

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent.parent / ".agbench_cache" / "reference"
_LIB: list = []


def _lib():
    """The walk's library, built on first use (g++ writes a name of its
    own and the rename is atomic)."""
    if not _LIB:
        src, so = HERE / "traverse.cpp", BUILD / "libreftraverse.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            str(src)], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.ag_extd_contigs1.restype = ctypes.c_int64
        _LIB.append(lib)
    return _LIB[0]


U32 = 0xFFFFFFFF
NONEI = 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= U32
    return x - 2**32 if x >= 2**31 else x


@dataclasses.dataclass
class PreContig:
    """One pre-extended contig (reference `Contig`, AlignGraph.cpp:123-139;
    header format of tmp/_pre_extended_contigs, :2178)."""
    seq: bytearray            # int8 codes
    extended: int
    start_id: int             # uint32 domain (0 or NONEI)
    start_off: int
    end_id: int
    end_off: int
    start0_id: int
    start0_off: int
    end0_id: int
    end0_off: int


def filter_low_coverage(g: GraphTensors, coverage: int) -> None:
    """C20: read-only k-mers below coverage are pruned (marked traversed)."""
    slot = np.arange(g.km_trav.shape[1])[None, :]
    valid = slot < g.km_cnt[:, None]
    mask = valid & (g.km_contig == NONE32) & (g.km_cov < coverage)
    g.km_trav[mask] = 1


def _contain(s1, so1, e1, eo1, s2, so2, e2, eo2) -> bool:
    """reference `contain` (AlignGraph.cpp:1897-1902), unsigned compares."""
    return (s1 == s2 and e1 == e2 and (so1 & U32) <= (so2 & U32)
            and (eo1 & U32) >= (eo2 & U32))


def extd_contigs2(contigs: List[PreContig]) -> None:
    """C22: containment sweeps + unique-successor joins (in place)."""
    n = len(contigs)
    # forward containment sweep
    for cp in range(n):
        if contigs[cp].extended != 1:
            continue
        for cpp in range(cp + 1, n):
            if _contain(contigs[cp].start_id, contigs[cp].start_off,
                        contigs[cp].end_id, contigs[cp].end_off,
                        contigs[cpp].start_id, contigs[cpp].start_off,
                        contigs[cpp].end_id, contigs[cpp].end_off):
                contigs[cpp].extended = 2
            elif contigs[cp].end_id != contigs[cpp].start_id or \
                    (contigs[cp].end_off & U32) < \
                    (contigs[cpp].start_off & U32):
                break
    # backward sweep
    for cp in range(n - 1, -1, -1):
        if contigs[cp].extended != 1:
            continue
        for cpp in range(cp - 1, -1, -1):
            if _contain(contigs[cp].start_id, contigs[cp].start_off,
                        contigs[cp].end_id, contigs[cp].end_off,
                        contigs[cpp].start_id, contigs[cpp].start_off,
                        contigs[cpp].end_id, contigs[cpp].end_off):
                contigs[cpp].extended = 2
            elif contigs[cpp].end_id != contigs[cp].start_id or \
                    (contigs[cpp].end_off & U32) < \
                    (contigs[cp].start_off & U32):
                break
    # join pass (AlignGraph.cpp:2342-2378)
    for cp in range(n):
        while contigs[cp].extended == 1:
            buf = []
            for cpp in range(cp + 1, n):
                if contigs[cpp].extended == 2:
                    continue
                if (contigs[cp].end_off & U32) >= \
                        (contigs[cpp].start_off & U32):
                    buf.append(cpp)
                elif (contigs[cp].end_off & U32) < \
                        (contigs[cpp].start_off & U32):
                    break
            if len(buf) != 1:
                break
            j = buf[0]
            contigs[j].extended = 2
            cut = (contigs[cp].end_off - contigs[j].start_off + 1) & U32
            if cut < len(contigs[j].seq):
                contigs[cp].seq.extend(contigs[j].seq[cut:])
            contigs[cp].end_id = contigs[j].end_id
            contigs[cp].end_off = contigs[j].end_off
            contigs[cp].end0_id = contigs[j].end0_id
            contigs[cp].end0_off = contigs[j].end0_off


def _overlap(x1, y1, x2, y2) -> bool:
    """reference `overlap` (AlignGraph.cpp:2388-2394): unsigned compares,
    int32-cast differences."""
    x1, y1, x2, y2 = x1 & U32, y1 & U32, x2 & U32, y2 & U32
    return bool(
        (x1 <= x2 <= y1 <= y2 and _i32(y1) - _i32(x2) > 0)
        or (x2 <= x1 <= y2 <= y1 and _i32(y2) - _i32(x1) > 0)
        or (x1 <= x2 <= y2 <= y1 and _i32(y2) - _i32(x2) > 0)
        or (x2 <= x1 <= y1 <= y2 and _i32(y1) - _i32(x1) > 0))


def scaffold_contigs(g: GraphTensors, contigs: List[PreContig]
                     ) -> List[np.ndarray]:
    """C23: PE-anchor scaffolding with >=50%-covered reference gap fill."""
    scaffolds: List[bytearray] = []
    n = len(contigs)
    # NOTE: the reference reuses the loop variable for joins (cp = cp0,
    # AlignGraph.cpp:2440), so after a join the outer loop resumes from the
    # last joined contig + 1 — unconsumed contigs in the jumped-over range
    # never start scaffolds.  Preserved exactly.
    cp = -1
    while cp + 1 < n:
        cp += 1
        c = contigs[cp]
        if c.start_id == NONEI or c.extended != 1:
            continue
        cur = bytearray(c.seq)
        c.start_id = NONEI   # consume
        cont = True
        while contigs[cp].start0_id == contigs[cp].end0_id and cont:
            cont = False
            for cp0 in range(cp + 1, n):
                c0 = contigs[cp0]
                if (cp0 != cp and contigs[cp].end0_id == c0.start_id
                        and c0.start_id == c0.end_id
                        and _overlap(contigs[cp].start0_off,
                                     contigs[cp].end0_off,
                                     c0.start_off, c0.end_off)
                        and c0.extended == 1):
                    e_off = contigs[cp].end_off & U32
                    s_off = c0.start_off & U32
                    if s_off > e_off:
                        gap = s_off - e_off - 1
                        covered = 0
                        for i in range(gap):
                            p = e_off + i + 1
                            if p < g.n_pos and (g.km_cnt[p] > 0
                                                or g.cm_cnt[p] > 0):
                                covered += 1
                        if gap != 0 and covered / gap >= 0.5 or gap == 0:
                            for i in range(gap):
                                p = e_off + i + 1
                                cur.append(int(g.base[p]) if p < g.n_pos
                                           else 4)
                        else:
                            continue
                    cur.extend(c0.seq)
                    c0.start_id = NONEI
                    cp = cp0
                    cont = True
                    break
        scaffolds.append(cur)
    return [np.frombuffer(bytes(s), dtype=np.int8) for s in scaffolds]


def extd_contigs1(g: GraphTensors, coverage: int, k: int
                  ) -> List[PreContig]:
    """C21 by the C++ walk: the coverage filter, then the genome-order
    scan starting walks at untraversed k-mers."""
    lib = _lib()
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
    for i in range(int(rc)):
        out.append(PreContig(
            seq=bytearray(seq_buf[seq_start[i]:seq_end[i]].tobytes()),
            extended=int(extended[i]),
            start_id=0, start_off=int(s_off[i]),
            end_id=0, end_off=int(e_off[i]),
            start0_id=int(s0_id[i]), start0_off=int(s0_off[i]),
            end0_id=int(e0_id[i]), end0_off=int(e0_off[i])))
    return out


def extend_and_scaffold(g: GraphTensors, coverage: int, k: int
                        ) -> List[np.ndarray]:
    """C21+C22+C23 composed: the scaffold sequences."""
    pre = extd_contigs1(g, coverage, k)
    extd_contigs2(pre)
    return scaffold_contigs(g, pre)
