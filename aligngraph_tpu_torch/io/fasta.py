"""FASTA I/O and sequence codes.

The engine's sequence alphabet is int8: A=0 C=1 G=2 T=3, anything else
(N, ambiguity codes, lowercase unknowns) = 4.  Lowercase acgt map to 0-3.

Reference behavior notes:
 - the reference streams FASTA line-by-line and stops at the first empty
   line (AlignGraph.cpp:3250-3252 `if(buf[0]==0) break`) — we read whole
   records and tolerate blank lines, which is a strict superset.
 - output wraps at 60 columns (AlignGraph.cpp:3273 etc.).
 - reverse complement maps A<->T, C<->G, leaves N (AlignGraph.cpp:750-760
   `complement`, :854-865 `reverseComplement`).
"""

from __future__ import annotations

import io
from typing import Iterable, List, Sequence, Tuple

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
ALPHABET = b"ACGTN"

_ENC = np.full(256, N, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _ENC[ch] = i
for i, ch in enumerate(b"acgt"):
    _ENC[ch] = i

_DEC = np.frombuffer(ALPHABET, dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMP = np.array([T, G, C, A, N], dtype=np.int8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """bytes/str -> int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, np.ndarray):
        if seq.dtype == np.int8:
            return seq
        seq = seq.tobytes()
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> bytes:
    """int8 codes -> bytes (ACGTN)."""
    return _DEC[np.asarray(codes, dtype=np.int64)].tobytes()


def complement_code(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.int64)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return complement_code(codes)[::-1]


def read_fasta(path_or_file) -> Tuple[List[str], List[bytes]]:
    """Read a FASTA file -> (ids, raw sequence bytes).

    IDs are the full header after '>' (reference keeps the whole line,
    AlignGraph.cpp:3256).
    """
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        # native C++ parser for file paths (identical semantics; the
        # Python loop below is the tested fallback/oracle)
        try:
            from aligngraph_tpu_torch import native
            out = native.read_fasta_native(str(path_or_file))
            if out is not None:
                return out
        except Exception:
            pass
        f = open(path_or_file, "rb")
        close = True
    ids: List[str] = []
    seqs: List[bytes] = []
    chunks: List[bytes] = []
    try:
        for line in f:
            if isinstance(line, str):
                line = line.encode()
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b">"):
                if ids:
                    seqs.append(b"".join(chunks))
                chunks = []
                ids.append(line[1:].decode())
            else:
                chunks.append(line)
        if ids:
            seqs.append(b"".join(chunks))
    finally:
        if close:
            f.close()
    return ids, seqs


def write_fasta(path_or_file, ids: Iterable[str],
                seqs: Iterable[bytes | np.ndarray], width: int = 60) -> None:
    """Write FASTA with 60-column wrapping (reference output format)."""
    if hasattr(path_or_file, "write"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "wb")
        close = True
    try:
        for sid, seq in zip(ids, seqs):
            if isinstance(seq, np.ndarray):
                seq = decode(seq)
            if isinstance(seq, str):
                seq = seq.encode()
            f.write(b">" + sid.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + b"\n")
    finally:
        if close:
            f.close()


def fasta_bytes(ids: Sequence[str], seqs: Sequence[bytes | np.ndarray],
                width: int = 60) -> bytes:
    buf = io.BytesIO()
    write_fasta(buf, ids, seqs, width)
    return buf.getvalue()
