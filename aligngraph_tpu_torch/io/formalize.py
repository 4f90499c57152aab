"""Input formalization — in-memory equivalents of the reference's tmp/ files.

The reference normalizes all inputs into renumbered FASTA files under tmp/
(the filesystem is its data bus).  Our bus is arrays:

 - Reads  (ref `formalizeInput(in1,in2,...)` AlignGraph.cpp:3420-3518):
   pair-synchronized read-in, per-pair truncation to min(len1, len2),
   sequential renumbering.  Here: one padded int8 array [2N, Lmax] with
   mate 2i / 2i+1 interleaving (the reference's `tmp/_reads.fa` order).

 - Contigs (ref `formalizeInput(in,file)` AlignGraph.cpp:3228-3345):
   contigs with length <= 200 are diverted verbatim to chaff
   (`tmp/_chaff.fa`); longer contigs are renumbered and chunked into
   LARGE_CHUNK (1 Mb) pieces with `>chunkID.realID` identity; a trailing
   piece of <= 60 bp is merged into the previous chunk
   (the `cpp < size-1-60` guard at AlignGraph.cpp:3283).

 - Genome (ref `formalizeGenome` AlignGraph.cpp:3347-3418): each chromosome
   split into `part` pieces of floor(len/part) bases (last piece takes the
   remainder); every piece becomes an independent "chromosome" (the
   reference's numChromosomes = sum of parts).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from aligngraph_tpu_torch.config import LARGE_CHUNK
from aligngraph_tpu_torch.io.fasta import encode, read_fasta
from aligngraph_tpu_torch.utils import spans

CHAFF_CUTOFF = 200  # keep contigs strictly longer than this (AlignGraph.cpp:3265)
CHUNK_TAIL_MERGE = 60  # trailing chunk <= 60bp merges back (AlignGraph.cpp:3283)


class FormalizeError(ValueError):
    pass


@dataclasses.dataclass
class Reads:
    """Formalized PE reads.

    data[2i] is mate 1 of pair i, data[2i+1] is mate 2, both truncated to the
    pair's min length and padded with code 4 (N) to max_len.
    """
    n_pairs: int
    max_len: int
    data: np.ndarray      # [2*n_pairs, max_len] int8
    lengths: np.ndarray   # [n_pairs] int32 truncated per-pair length

    @property
    def max_read_length(self) -> int:
        # ref `maxReadLength` AlignGraph.cpp:3197-3226
        return int(self.lengths.max()) if self.n_pairs else 0


@dataclasses.dataclass
class Contigs:
    """Formalized contigs + chunk table.

    kept contigs are renumbered 0..n-1 ("realID"); chunks carry
    (chunk -> real contig, offset) identity like the reference's
    `>chunkID.realID` headers.
    """
    ids: List[str]                 # original FASTA ids of kept contigs
    seqs: List[np.ndarray]         # encoded, one per kept (real) contig
    chaff_ids: List[str]
    chaff_seqs: List[bytes]        # verbatim (emitted untouched at the end)
    chunk_real: np.ndarray         # [n_chunks] real contig index
    chunk_start: np.ndarray        # [n_chunks] offset within real contig
    chunk_len: np.ndarray          # [n_chunks]

    @property
    def n_real(self) -> int:
        return len(self.seqs)

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_real)

    def chunk_seq(self, c: int) -> np.ndarray:
        r = self.chunk_real[c]
        s = self.chunk_start[c]
        return self.seqs[r][s:s + self.chunk_len[c]]


@dataclasses.dataclass
class Genome:
    """Formalized genome: concatenated position axis + part table.

    `parts` are the reference's per-part pseudo-chromosomes: part i covers
    chrom part_chrom[i], offsets [part_start[i], part_start[i]+part_len[i]).
    The concatenated axis indexes parts back-to-back (part i occupies
    global positions [part_gstart[i], part_gstart[i]+part_len[i])), which
    equals chromosome-concatenation order since parts are in order.
    """
    ids: List[str]               # original chromosome ids
    chrom_len: np.ndarray        # [n_chrom]
    seq: np.ndarray              # concatenated encoded genome (all chroms)
    chrom_gstart: np.ndarray     # [n_chrom+1] global start of each chromosome
    part_chrom: np.ndarray       # [n_parts]
    part_start: np.ndarray       # [n_parts] start within chromosome
    part_len: np.ndarray         # [n_parts]
    part_gstart: np.ndarray      # [n_parts] start in concatenated axis

    @property
    def n_parts(self) -> int:
        return len(self.part_chrom)

    @property
    def total_len(self) -> int:
        return int(self.seq.shape[0])

    def part_seq(self, p: int) -> np.ndarray:
        g = self.part_gstart[p]
        return self.seq[g:g + self.part_len[p]]


# ---------------------------------------------------------------------------

def _iter_fasta_seqs(path):
    """Stream sequences of a FASTA file one record at a time (bytes)."""
    if hasattr(path, "read"):
        path.seek(0)
        f = path
        close = False
    else:
        f = open(path, "rb")
        close = True
    try:
        started = False
        chunks: List[bytes] = []
        for line in f:
            if isinstance(line, str):
                line = line.encode()
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b">"):
                if started:
                    yield b"".join(chunks)
                started = True
                chunks = []
            elif started:
                chunks.append(line)
        if started:
            yield b"".join(chunks)
    finally:
        if close:
            f.close()


@spans.spanned("formalize.reads")
def formalize_reads(path1, path2, memmap_path=None) -> Reads:
    """ref AlignGraph.cpp:3420-3518 — pair-synchronized, min-length
    truncated.

    memmap_path: when given, the read matrix is backed by a disk memmap
    filled in a streaming pass — resident memory stays bounded regardless
    of read count (the C14 BATCH-streaming equivalent,
    AlignGraph.cpp:37, 361-404; the aligner already consumes the matrix
    in fixed batch_pairs slices, so the OS page cache is the batch
    window).
    """
    # pass 1 (streaming): pair-synchronized lengths
    lens: List[int] = []
    it1 = _iter_fasta_seqs(path1)
    it2 = _iter_fasta_seqs(path2)
    _SENTINEL = object()
    while True:
        s1 = next(it1, _SENTINEL)
        s2 = next(it2, _SENTINEL)
        if s1 is _SENTINEL and s2 is _SENTINEL:
            break
        if s1 is _SENTINEL or s2 is _SENTINEL:
            raise FormalizeError("INCONSISTENT PE FILES!")
        if len(s1) == 0 or len(s2) == 0:
            # reference only emits pairs where both reads are non-empty
            # (AlignGraph.cpp:3452 `read1.size()!=0 && read2.size()!=0`)
            lens.append(-1)
            continue
        lens.append(min(len(s1), len(s2)))
    lengths = np.array([l for l in lens if l >= 0], dtype=np.int32)
    n = len(lengths)
    if n == 0:
        return Reads(0, 0, np.zeros((0, 0), np.int8), np.zeros(0, np.int32))
    max_len = int(lengths.max())
    if memmap_path is not None:
        data = np.lib.format.open_memmap(
            str(memmap_path), mode="w+", dtype=np.int8,
            shape=(2 * n, max_len))
    else:
        data = np.empty((2 * n, max_len), dtype=np.int8)
    # pass 2 (streaming): encode into rows
    i = 0
    for k, (s1, s2) in enumerate(zip(_iter_fasta_seqs(path1),
                                     _iter_fasta_seqs(path2))):
        m = lens[k]
        if m < 0:
            continue
        row1 = np.full(max_len, 4, np.int8)
        row1[:m] = encode(s1[:m])
        data[2 * i] = row1
        row2 = np.full(max_len, 4, np.int8)
        row2[:m] = encode(s2[:m])
        data[2 * i + 1] = row2
        i += 1
    if memmap_path is not None:
        data.flush()
    return Reads(n, max_len, data, lengths)


def _chunk_boundaries(length: int) -> List[Tuple[int, int]]:
    """(start, len) chunks of LARGE_CHUNK with <=60bp tail merged into the
    last chunk (AlignGraph.cpp:3280-3293)."""
    cuts = [0]
    pos = LARGE_CHUNK
    while pos < length and length - pos > CHUNK_TAIL_MERGE:
        cuts.append(pos)
        pos += LARGE_CHUNK
    cuts.append(length)
    return [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(len(cuts) - 1)]


@spans.spanned("formalize.contigs")
def formalize_contigs(path) -> Contigs:
    """ref AlignGraph.cpp:3228-3319 — chaff cut at 200bp + 1Mb chunking."""
    ids, seqs = read_fasta(path)
    kept_ids: List[str] = []
    kept: List[np.ndarray] = []
    chaff_ids: List[str] = []
    chaff: List[bytes] = []
    chunk_real: List[int] = []
    chunk_start: List[int] = []
    chunk_len: List[int] = []
    for cid, seq in zip(ids, seqs):
        if len(seq) > CHAFF_CUTOFF:
            real = len(kept)
            kept_ids.append(cid)
            kept.append(encode(seq))
            for start, ln in _chunk_boundaries(len(seq)):
                chunk_real.append(real)
                chunk_start.append(start)
                chunk_len.append(ln)
        else:
            chaff_ids.append(cid)
            chaff.append(seq)
    return Contigs(
        ids=kept_ids, seqs=kept, chaff_ids=chaff_ids, chaff_seqs=chaff,
        chunk_real=np.array(chunk_real, dtype=np.int32),
        chunk_start=np.array(chunk_start, dtype=np.int64),
        chunk_len=np.array(chunk_len, dtype=np.int64),
    )


@spans.spanned("formalize.genome")
def formalize_genome(path, part: int = 1) -> Genome:
    """ref AlignGraph.cpp:3347-3418 — per-chromosome `part`-way splitting.

    Split points are at multiples of floor(len/part); only the first
    part-1 multiples split (`q < p` guard :3395), and a split exactly at
    the final base is suppressed (`cp != size-1` guard :3400).
    """
    ids, raw = read_fasta(path)
    if not ids:
        raise FormalizeError("CANNOT OPEN FILE!")
    chrom_len = np.array([len(s) for s in raw], dtype=np.int64)
    seq = np.concatenate([encode(s) for s in raw]) if raw else \
        np.zeros(0, np.int8)
    chrom_gstart = np.concatenate([[0], np.cumsum(chrom_len)])
    part_chrom: List[int] = []
    part_start: List[int] = []
    part_len: List[int] = []
    for ci, ln in enumerate(chrom_len):
        ln = int(ln)
        step = ln // part if part > 0 else ln
        cuts = [0]
        if step > 0:
            q = 1
            pos = step
            while q < part and pos < ln:  # `cp != size-1` suppresses end cut
                cuts.append(pos)
                q += 1
                pos += step
        cuts.append(ln)
        for i in range(len(cuts) - 1):
            part_chrom.append(ci)
            part_start.append(cuts[i])
            part_len.append(cuts[i + 1] - cuts[i])
    part_chrom_a = np.array(part_chrom, dtype=np.int32)
    part_start_a = np.array(part_start, dtype=np.int64)
    part_len_a = np.array(part_len, dtype=np.int64)
    part_gstart = chrom_gstart[part_chrom_a] + part_start_a
    return Genome(
        ids=ids, chrom_len=chrom_len, seq=seq,
        chrom_gstart=chrom_gstart, part_chrom=part_chrom_a,
        part_start=part_start_a, part_len=part_len_a,
        part_gstart=part_gstart,
    )
