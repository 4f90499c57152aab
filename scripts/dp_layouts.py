"""Times every layout (cells per lane) of sw_dp_kernel on one GPU over a
sweep of lane counts, beside the layout the kernel picks by itself.

    python3 scripts/dp_layouts.py [--reps 20]

Shapes: L 100, pad 16 (chip_smoke.py's dp_lanes) and L 512, pad 16 (the
workload's tile_lanes), seeded; each lane count n takes the first n lanes.
Times are chip_smoke.cuda_ms (CUDA events around `reps` launches queued
behind a sleep of the stream: the device's time).  Prints one JSON line
per shape and lane count, {"shape", "lanes", "ms": {cells: ms}, "picked":
ms}, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from aligngraph_tpu_torch.ops import banded_sw_cuda as k  # noqa: E402
from aligngraph_tpu_torch.workload import tile_lanes  # noqa: E402

SWEEP = {"L100 pad16": (576, 1_024, 1_536, 2_048, 2_560, 3_072, 4_096),
         "L512 pad16": (320, 640, 1_024, 1_280, 1_536, 2_048)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: dp_layouts.py needs one GPU")
    rng = np.random.default_rng(0)
    shapes = {"L100 pad16": cs.dp_lanes(rng, max(SWEEP["L100 pad16"]), 100,
                                        16),
              "L512 pad16": tile_lanes(rng, max(SWEEP["L512 pad16"]), 512,
                                       16)}
    for label, arrays in shapes.items():
        reads, rlens, windows, _ = (torch.from_numpy(a).cuda()
                                    for a in arrays)
        for n in SWEEP[label]:
            r, ln, w = reads[:n], rlens[:n], windows[:n]
            ms = {c: cs.cuda_ms(lambda: k.sw_dp_cuda(r, ln, w, 16,
                                                     cells_per_lane=c),
                                args.reps)
                  for c in k.DP_CELLS[32]}
            picked = cs.cuda_ms(lambda: k.sw_dp_cuda(r, ln, w, 16),
                                args.reps)
            print(json.dumps({"shape": label, "lanes": n, "ms": ms,
                              "picked": picked}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
