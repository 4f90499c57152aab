"""Checkpoint / resume — C15 (`setCheckpoint`/`getCheckpoint`,
AlignGraph.cpp:4648-4680, resume branch :4748-4760).

Same granularity as the reference: checkpoint "0" after the alignment
stage, then part+1 after each chromosome part.  State is stored under the
work dir: `_command.txt` (config round-trip, the reference's resume
mechanism), `_checkpoint.txt` (appended stage markers), plus npz archives
of the stage artifacts (alignments, per-part scaffolds) — stronger than
the reference, which relies on its tmp/ files surviving.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from aligngraph_tpu_torch.align.types import ContigAlignments, PairAlignments
from aligngraph_tpu_torch.config import Config


class Checkpoint:
    def __init__(self, work_dir: str):
        self.dir = work_dir
        os.makedirs(work_dir, exist_ok=True)

    @property
    def _ckpt(self):
        return os.path.join(self.dir, "_checkpoint.txt")

    @property
    def _cmd(self):
        return os.path.join(self.dir, "_command.txt")

    def save_command(self, cfg: Config) -> None:
        cfg.save_command(self._cmd)

    def load_command(self) -> Config:
        return Config.load_command(self._cmd)

    def set(self, stage: int) -> None:
        with open(self._ckpt, "a") as f:
            f.write(f"{stage}\n")

    def get(self) -> int:
        """Last checkpoint (reference reads the last line; -1 = none)."""
        try:
            with open(self._ckpt) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            return int(lines[-1]) if lines else -1
        except FileNotFoundError:
            return -1

    # ---- artifact persistence (ours; beyond the reference) ----
    def save_alignments(self, rali: PairAlignments,
                        cali: ContigAlignments) -> None:
        with open(os.path.join(self.dir, "_alignments.pkl"), "wb") as f:
            pickle.dump((rali, cali), f)

    def load_alignments(self) -> Optional[Tuple]:
        p = os.path.join(self.dir, "_alignments.pkl")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return pickle.load(f)

    def save_part(self, p: int, scaffolds: List[np.ndarray],
                  initials) -> None:
        with open(os.path.join(self.dir, f"_part{p}.pkl"), "wb") as f:
            pickle.dump((scaffolds, initials), f)

    def load_part(self, p: int):
        path = os.path.join(self.dir, f"_part{p}.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)
