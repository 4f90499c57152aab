"""Alignment record types — array-of-structs interfaces between the aligner
and the graph builder.

The reference's equivalent is SAM/PSL text plus `Seq.positionSets`
(AlignGraph.cpp:113-121): per sequence, a list of placements, each a
per-base map base_index -> (chromosomeID, chromosomeOffset).  Our records
keep exactly that: a `pos_map` per placement (int32 global genome position
per base, -1 = unaligned) plus the parse quantities the reference's filters
use (parseBOWTIE outputs, AlignGraph.cpp:181-285).

Coordinates are SAM-convention: when fr=1 the placement refers to the
reverse-complemented sequence, and pos_map index i is the i-th base of the
reverse complement.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PairAlignments:
    """Accepted PE pair alignments (bowtie2 -k style: up to K per pair).

    All arrays share leading dim M (number of reported pair-alignments).
    Per-mate arrays have a trailing axis of 2 (mate 1, mate 2).
    """
    pair_id: np.ndarray       # [M] int32
    fr: np.ndarray            # [M, 2] int8 (1 = reverse strand)
    score: np.ndarray         # [M, 2] int32 SW score
    # parseBOWTIE-equivalent quantities (AlignGraph.cpp:272-284):
    source_start: np.ndarray  # [M, 2] int32 first aligned base (soft-clip)
    source_end: np.ndarray    # [M, 2] int32 one past last aligned base
    source_gap: np.ndarray    # [M, 2] int32 insertions I (read-only bases)
    source_size: np.ndarray   # [M, 2] int32 read length
    target_start: np.ndarray  # [M, 2] int32 global genome pos of first match
    target_end: np.ndarray    # [M, 2] int32 ref quirk: ts + size + D - I
    target_gap: np.ndarray    # [M, 2] int32 deletions D
    pos_map: np.ndarray       # [M, 2, L] int32 genome pos per base, -1 unal.

    @property
    def n(self) -> int:
        return int(self.pair_id.shape[0])

    @classmethod
    def empty(cls, read_len: int) -> "PairAlignments":
        """Zero-record table with well-formed shapes (pos_map [0, 2, L])."""
        z = np.zeros((0, 2), np.int32)
        return cls(pair_id=np.zeros(0, np.int32),
                   fr=np.zeros((0, 2), np.int8), score=z.copy(),
                   source_start=z.copy(), source_end=z.copy(),
                   source_gap=z.copy(), source_size=z.copy(),
                   target_start=z.copy(), target_end=z.copy(),
                   target_gap=z.copy(),
                   pos_map=np.zeros((0, 2, read_len), np.int32))

    def ratio_ok(self, threshold: float) -> np.ndarray:
        """The reference's read filter (C13, AlignGraph.cpp:1261):
        both mates: (se-ss-I)/size >= t and (te-ts-D)/(te-ts) >= t."""
        ss, se = self.source_start, self.source_end
        sg, sz = self.source_gap, self.source_size
        ts, te, tg = self.target_start, self.target_end, self.target_gap
        span = np.maximum(te - ts, 1)
        ok = ((se - ss - sg) / np.maximum(sz, 1) >= threshold) & \
             ((te - ts - tg) / span >= threshold)
        return ok.all(axis=1)


@dataclasses.dataclass
class ContigAlignments:
    """Accepted contig placements (BLAT/PSL replacement).

    One row per placement of a contig chunk on the genome; pos_map covers
    the full chunk (index = chunk base in aligned orientation).
    """
    chunk_id: np.ndarray      # [M] int32 (index into Contigs chunk table)
    fr: np.ndarray            # [M] int8
    score: np.ndarray         # [M] int32
    source_start: np.ndarray  # [M] int32
    source_end: np.ndarray    # [M] int32
    source_gap: np.ndarray    # [M] int32
    source_size: np.ndarray   # [M] int32
    target_start: np.ndarray  # [M] int32 (global genome axis)
    target_end: np.ndarray    # [M] int32
    target_gap: np.ndarray    # [M] int32
    pos_map: list             # [M] list of int32 arrays (chunk length each)

    @property
    def n(self) -> int:
        return int(self.chunk_id.shape[0])
