"""Position-indexed A-Bruijn graph tensors.

The reference's graph (AlignGraph.cpp:44-172) is `genome[chr][offset]` with
per-position vectors of ContiMers (contig layer) and KMers (read layer).
Our representation keeps the same position anchoring but as parallel slotted
arrays over one position axis per chromosome part:

  axis length = part_len + overflow_cap; novel insertion bases appended by
  the contig layer (reference: genome[chr].push_back, AlignGraph.cpp:
  980-1040) live in the overflow segment [part_len, part_len+overflow_used).

Slot caps: ContiMer S=4 (the reference skips placements once a position
holds >=2 ContiMers, AlignGraph.cpp:914, so 4 covers the terminal-push
excess), KMer K=6 (distinct `compatible` classes per position are few by
construction since mate-anchor windows are +-(2*insertVariation+25)).
Overflow beyond a cap is counted, reported, and dropped deterministically.

All anchor offsets are stored in uint32 semantics (-1 == 0xFFFFFFFF) to
preserve the reference's unsigned wraparound quirks (e.g. endOffset0 +=
k-1 on a -1 anchor, AlignGraph.cpp:2171).
"""

from __future__ import annotations

import dataclasses

import numpy as np

S_CM = 4     # ContiMer slots per position
K_KM = 6     # KMer slots per position
E_ED = 4     # edge slots per k-mer

NONE32 = np.uint32(0xFFFFFFFF)


def u32(x):
    return np.uint32(x) if np.isscalar(x) else x.astype(np.uint32)


@dataclasses.dataclass
class GraphTensors:
    """Per-part graph state (host numpy)."""
    part_len: int
    overflow_cap: int
    overflow_used: int
    base: np.ndarray        # [P] int8 genome base codes (incl. overflow)

    # contig layer (ContiMer, AlignGraph.cpp:51-62)
    cm_cnt: np.ndarray      # [P] int8
    cm_contig: np.ndarray   # [P, S] uint32 contig id (chunk seq id)
    cm_coff: np.ndarray     # [P, S] uint32 contig offset
    cm_next: np.ndarray     # [P, S] uint32 next position (NONE32 = -1)
    cm_nitem: np.ndarray    # [P, S] uint32 next ContiMer item
    cm_base: np.ndarray     # [P, S] int8 nucleotide code

    # read layer (KMer, AlignGraph.cpp:78-98)
    km_cnt: np.ndarray      # [P] int8
    km_trav: np.ndarray     # [P, K] uint8
    km_contig: np.ndarray   # [P, K] uint32 own contig anchor id
    km_coff: np.ndarray     # [P, K] uint32 own contig anchor offset
    km_contig0: np.ndarray  # [P, K] uint32 mate contig anchor id
    km_coff0: np.ndarray    # [P, K] uint32 mate contig anchor offset
    km_mate: np.ndarray     # [P, K] uint32 mate genome anchor position
    km_cov: np.ndarray      # [P, K] int32 coverage
    km_votes: np.ndarray    # [P, K, 5] int32 A/C/G/T/N votes
    km_s: np.ndarray        # [P, K] uint32 packed k-mer string (2b/base)
    km_slen: np.ndarray     # [P, K] int8 k-mer string length (0 = empty)

    # edges
    ed_cnt: np.ndarray      # [P, K] int8
    ed_pos: np.ndarray      # [P, K, E] uint32 target position
    ed_item: np.ndarray     # [P, K, E] uint8 target k-mer slot

    # overflow statistics (determinism diagnostics)
    dropped_cm: int = 0
    dropped_km: int = 0
    dropped_ed: int = 0

    @property
    def n_pos(self) -> int:
        return self.part_len + self.overflow_used

    @classmethod
    def create(cls, part_seq: np.ndarray, overflow_cap: int = 0
               ) -> "GraphTensors":
        n = len(part_seq)
        if overflow_cap == 0:
            overflow_cap = max(1024, n // 10)
        P = n + overflow_cap
        base = np.full(P, 4, np.int8)
        base[:n] = part_seq
        z = np.zeros
        return cls(
            part_len=n, overflow_cap=overflow_cap, overflow_used=0,
            base=base,
            cm_cnt=z(P, np.int8),
            cm_contig=np.full((P, S_CM), NONE32, np.uint32),
            cm_coff=np.full((P, S_CM), NONE32, np.uint32),
            cm_next=np.full((P, S_CM), NONE32, np.uint32),
            cm_nitem=np.full((P, S_CM), NONE32, np.uint32),
            cm_base=np.full((P, S_CM), 4, np.int8),
            km_cnt=z(P, np.int8),
            km_trav=z((P, K_KM), np.uint8),
            km_contig=np.full((P, K_KM), NONE32, np.uint32),
            km_coff=np.full((P, K_KM), NONE32, np.uint32),
            km_contig0=np.full((P, K_KM), NONE32, np.uint32),
            km_coff0=np.full((P, K_KM), NONE32, np.uint32),
            km_mate=np.full((P, K_KM), NONE32, np.uint32),
            km_cov=z((P, K_KM), np.int32),
            km_votes=z((P, K_KM, 5), np.int32),
            km_s=z((P, K_KM), np.uint32),
            km_slen=z((P, K_KM), np.int8),
            ed_cnt=z((P, K_KM), np.int8),
            ed_pos=np.full((P, K_KM, E_ED), NONE32, np.uint32),
            ed_item=z((P, K_KM, E_ED), np.uint8),
        )

    def alloc_overflow(self, n: int) -> int:
        """Reserve n overflow positions; returns the first index."""
        if self.overflow_used + n > self.overflow_cap:
            grow = max(n, self.overflow_cap)
            P_old = self.part_len + self.overflow_cap
            for name in ("base", "cm_cnt", "cm_contig", "cm_coff", "cm_next",
                         "cm_nitem", "cm_base", "km_cnt", "km_trav",
                         "km_contig", "km_coff", "km_contig0", "km_coff0",
                         "km_mate", "km_cov", "km_votes", "km_s", "km_slen",
                         "ed_cnt", "ed_pos", "ed_item"):
                arr = getattr(self, name)
                shape = (P_old + grow,) + arr.shape[1:]
                if name == "base" or name == "cm_base":
                    fill = np.int8(4)
                elif arr.dtype == np.uint32:
                    fill = NONE32
                else:
                    fill = arr.dtype.type(0)
                new = np.full(shape, fill, arr.dtype)
                new[:P_old] = arr
                setattr(self, name, new)
            self.overflow_cap += grow
        start = self.part_len + self.overflow_used
        self.overflow_used += n
        return start
