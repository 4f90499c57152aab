"""What the drivers share: the program's configuration from a cell's
deployment, the sample's FASTA files, the sampled answers of the check,
and their comparison with the reference."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from agbench import workload
from agbench.reference import contig_aligner as ref_contigs
from agbench.reference import read_aligner as ref_reads
from agbench.reference import seeding as ref_seeding

ALPHABET = np.frombuffer(b"ACGTN", np.uint8)
# the fields of a read record and of a contig placement, as the program's
# PairAlignments and ContigAlignments name them
READ_FIELDS = ("pair_id", "fr", "score", "source_start", "source_end",
               "source_gap", "source_size", "target_start", "target_end",
               "target_gap", "pos_map")
PLACEMENT_FIELDS = ("chunk_id", "fr", "score", "source_start",
                    "source_end", "source_gap", "source_size",
                    "target_start", "target_end", "target_gap", "pos_map")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Seconds of set-up parts, added to run.setup_split by name."""

    def __init__(self, split: dict):
        self.split, self.t = split, time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.split[name] = self.split.get(name, 0.0) + now - self.t
        self.t = now


def program_config(config: dict, **files):
    """The port's Config for the deployment's aligner and pipeline
    settings, with the given file paths."""
    from aligngraph_tpu_torch.config import Config

    a, p = config["aligner"], config.get("pipeline", {})
    return Config(distance_low=a["distance_low"],
                  distance_high=a["distance_high"],
                  seed_len=a["seed_len"], seed_stride=a["seed_stride"],
                  max_seed_hits=a["max_seed_hits"], band_pad=a["band_pad"],
                  max_candidates=a["max_candidates"],
                  fast_map=a["fast_map"], part=p.get("part", 1),
                  misassembly_removal=p.get("misassembly_removal", False),
                  k_mer=p.get("k_mer", 5),
                  insert_variation=p.get("insert_variation", 50),
                  coverage=p.get("coverage", 20),
                  unique_extension=p.get("unique_extension", False),
                  **files)


def load_program(device) -> None:
    """The port's CUDA kernels and host libraries, built on first use in
    the checkout and loaded."""
    from aligngraph_tpu_torch import native
    from aligngraph_tpu_torch.ops import _build

    if torch.device(device).type == "cuda":
        _build.load_library()
    native.get_lib()


def write_fasta(path: str, ids, seqs, width: int = 60) -> None:
    """int8 code sequences as FASTA, `width` bases a line."""
    with open(path, "wb") as f:
        for name, s in zip(ids, seqs):
            b = ALPHABET[np.asarray(s, np.int64)].tobytes()
            f.write(b">" + name.encode() + b"\n")
            f.write(b"".join(b[i:i + width] + b"\n"
                             for i in range(0, len(b), width)))


def sample(run, clock: Clock) -> dict:
    s = workload.make_sample(run.config, run.seed, run.device)
    sync(run.device)
    clock.lap("data")
    return s


def read_batches(run, n_pairs: int) -> list:
    """The program's batches whose records the check compares: (start,
    cnt, P) of cell["check"]["read_batches"] of them, drawn from the
    seed, the last (short) batch among them when there is one."""
    bp = run.config["aligner"]["batch_pairs"]
    nb = -(-n_pairs // bp)
    k = min(int(run.cell["check"]["read_batches"]), nb)
    rng = np.random.default_rng([int(run.seed) % 2**63, 1])
    pick = sorted(rng.choice(nb - 1, k - 1, replace=False).tolist()
                  + [nb - 1])
    out = []
    for b in pick:
        start = b * bp
        cnt = min(bp, n_pairs - start)
        out.append((start, cnt, ref_reads.batch_shape(cnt, bp)))
    return out


def draft_sample(run, n_drafts: int) -> np.ndarray:
    """The drafts whose placements the check compares, drawn from the
    seed, in order."""
    k = min(int(run.cell["check"]["drafts"]), n_drafts)
    rng = np.random.default_rng([int(run.seed) % 2**63, 2])
    return np.sort(rng.choice(n_drafts, k, replace=False))


def take_records(recs, batches: list) -> list:
    """The records of each sampled batch (PairAlignments) -> [{field:
    array}] a batch."""
    out = []
    for start, cnt, _ in batches:
        sel = (recs.pair_id >= start) & (recs.pair_id < start + cnt)
        out.append({f: getattr(recs, f)[sel] for f in READ_FIELDS})
    return out


def take_placements(pa, drafts: np.ndarray) -> dict:
    """The placements of the sampled drafts (ContigAlignments; chunk c is
    draft c), their chunk ids renumbered 0..k-1 as the reference numbers
    them."""
    rows = np.flatnonzero(np.isin(pa.chunk_id, drafts))
    out = {f: getattr(pa, f)[rows] for f in PLACEMENT_FIELDS
           if f != "pos_map"}
    out["chunk_id"] = np.searchsorted(drafts, out["chunk_id"]).astype(
        np.int32)
    out["pos_map"] = [np.asarray(pa.pos_map[i]) for i in rows]
    return out


def placements_dict(ca) -> dict:
    return {f: getattr(ca, f) for f in PLACEMENT_FIELDS}


def diff_rows(got: dict, want: dict, fields) -> int:
    """Rows that differ between two answers given field by field in one
    order: each row of the shorter that differs in any field, plus the
    rows the longer has beyond it."""
    ng, nw = len(got[fields[0]]), len(want[fields[0]])
    n = min(ng, nw)
    bad = np.zeros(n, bool)
    for f in fields:
        a, b = got[f], want[f]
        if isinstance(a, list):
            bad |= np.array([not np.array_equal(x, y)
                             for x, y in zip(a[:n], b[:n])], bool)
        else:
            a, b = np.asarray(a)[:n], np.asarray(b)[:n]
            if a.shape[1:] != b.shape[1:]:
                return max(ng, nw)
            bad |= (a != b).reshape(n, -1).any(axis=1) if n else bad
    return int(bad.sum()) + abs(ng - nw)


class Reference:
    """The plain reference on a genome: its own seed index and padded
    genome on the run's device."""

    def __init__(self, genome: np.ndarray, config: dict, device):
        self.p = config["aligner"]
        self.genome_p = ref_reads.genome_padded(genome, device)
        self.index = ref_seeding.build_index(genome, self.p["seed_len"],
                                             device=device)

    def records(self, data, lens, batch, *, gapless=False) -> dict:
        start, cnt, P = batch
        return ref_reads.align_batch(self.genome_p, self.index, data, lens,
                                     start, cnt, P, self.p,
                                     gapless=gapless)

    def placements(self, drafts: list, *, gapless=False) -> dict:
        return placements_dict(ref_contigs.align_drafts(
            self.genome_p, self.index, drafts, fast_map=self.p["fast_map"],
            gapless=gapless))


def trim_heap() -> None:
    """The garbage collected and the heap's free pages handed back to the
    system (glibc's malloc_trim), so that the next step starts from the
    same host state."""
    import ctypes
    import gc

    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def temp_dir(prefix: str) -> str:
    """A fresh directory under the run's TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix=prefix)


def remove_tree(path: str) -> None:
    import shutil

    if path and os.path.isdir(path):
        shutil.rmtree(path)
