"""Input handling shared by the port's compat CLIs: a multi-record FASTA
as one genome axis, and a query FASTA as unchunked contigs."""

from __future__ import annotations

import numpy as np

from aligngraph_tpu_torch.io.fasta import encode, read_fasta
from aligngraph_tpu_torch.io.formalize import Contigs


def genome_axis(path: str, sep: int):
    """Records of `path` concatenated with `sep` Ns after each ->
    (ids, genome int8, record starts int64, record lengths int64)."""
    gids, gseqs = read_fasta(path)
    rec_starts = []
    pieces = []
    cursor = 0
    for s in gseqs:
        rec_starts.append(cursor)
        e = encode(s)
        pieces.append(e)
        pieces.append(np.full(sep, 4, np.int8))
        cursor += len(e) + sep
    genome = np.concatenate(pieces) if pieces else np.zeros(0, np.int8)
    return (gids, genome, np.asarray(rec_starts, np.int64),
            np.asarray([len(s) for s in gseqs], np.int64))


def query_contigs(path: str) -> Contigs:
    """Every record of `path` as one contig chunk (no size filter)."""
    qids, qseqs = read_fasta(path)
    return Contigs(
        ids=qids, seqs=[encode(s) for s in qseqs],
        chaff_ids=[], chaff_seqs=[],
        chunk_real=np.arange(len(qseqs), dtype=np.int32),
        chunk_start=np.zeros(len(qseqs), np.int64),
        chunk_len=np.array([len(s) for s in qseqs], np.int64),
    )
