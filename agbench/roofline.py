"""The card's peaks, the least time a piece of work needs on them, and the
banded SW's work counted from its inputs.

card_figures and bound are frozen from chip_smoke.py at commit 5fa5dc4:
int32 peak = SMs x 64 INT32 lanes (NVIDIA's H100 white paper) x the
card's maximum SM clock, read from the card; memory at 3.35 TB/s (the
H100 SXM data sheet).  chip_smoke.py's kernel_bounds counted the DP's
cells over every row a launch writes; SwWork counts what the inputs need
instead, so that splitting the lanes over other launches, or a kernel
that skips rows, leaves the count alone.
"""

from __future__ import annotations

import subprocess

import torch

INT32_LANES_PER_SM = 64
MEM_BYTES_PER_S = 3.35e12
# integer operations per band cell of the recurrence: substitution score,
# M, E, Hno, the in-row F, H and the running best
OPS_PER_CELL = 10


def nvidia_smi(query: str) -> str:
    """The first card's answer to nvidia-smi --query-gpu=query, or "" when
    nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0].strip() if out.strip() else ""


def card_figures(device) -> dict:
    """The card's name, power limit, SM count and maximum SM clock, and the
    peaks derived from them."""
    props = torch.cuda.get_device_properties(device)
    clk = nvidia_smi("clocks.max.sm")
    mhz = float(clk) if clk else props.clock_rate / 1e3
    return {"kind": torch.cuda.get_device_name(device),
            "power_limit_w": nvidia_smi("power.limit") or None,
            "sms": props.multi_processor_count, "max_sm_clock_mhz": mhz,
            "int32_ops_per_s": props.multi_processor_count
            * INT32_LANES_PER_SM * mhz * 1e6,
            "bytes_per_s": MEM_BYTES_PER_S}


def bound(card: dict, ops: float, nbytes: float) -> dict:
    """The least time the card could take for `ops` integer operations and
    `nbytes` bytes moved: the larger of the two times."""
    ops_s = ops / card["int32_ops_per_s"]
    bytes_s = nbytes / card["bytes_per_s"]
    return {"bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}


class SwWork:
    """The banded SW entry's work, added up on the device (no host sync)
    over the calls it is given: per lane of length n > 0 (reads or tiles)
    in a band of W = 2 pad, n W cells of OPS_PER_CELL operations; bytes
    read once: the lane's n bases, its n + W window bases and its length
    and g0 (and its score floor when one is given); bytes written once:
    its score and its n pos_map words."""

    def __init__(self):
        self.cells = None
        self.nbytes = None
        self.calls = 0

    def add(self, rlens: torch.Tensor, L: int, pad: int, smin) -> None:
        n = rlens.clamp(0, L).to(torch.int64)
        live = (n > 0).to(torch.int64)
        W = 2 * pad
        cells = (n * W).sum()
        per_lane = 8 + (4 if smin is not None else 0) + 4
        nbytes = (n + (n + W) * live + per_lane * live + 4 * n).sum()
        self.cells = cells if self.cells is None else self.cells + cells
        self.nbytes = nbytes if self.nbytes is None else \
            self.nbytes + nbytes
        self.calls += 1

    def totals(self) -> tuple:
        """(operations, bytes) over every call added."""
        if self.cells is None:
            return 0.0, 0.0
        return (float(self.cells) * OPS_PER_CELL, float(self.nbytes))
