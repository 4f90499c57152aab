"""Times the banded-SW kernels of two checkouts of aligngraph_tpu_torch on
one GPU, in turns: other, this, this, other.

    python3 scripts/kernel_ab.py --other DIR [--reps 20]

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory).  Each turn is a
process of its own that builds that checkout's kernels (nvcc, into its
aligngraph_tpu_torch/_build/) and times each kernel at the main path's
shapes on the same seeded inputs (chip_smoke.py's dp_lanes and the
workload's tile_lanes): sw_score_kernel at L 100, pad 16, 98,304 lanes and
L 512, pad 16, 2,048 lanes; sw_dp_kernel and sw_traceback_kernel on the
first n lanes of L 100, pad 16, 4,096 lanes and L 512, pad 16, 2,048
lanes, for each n of chip_smoke.DP_SWEEP (576 and 4,096; 320 and 2,048),
with the layout each checkout's kernel picks.  Times are
chip_smoke.cuda_ms: CUDA events around `reps` launches queued behind a
sleep of the stream, so they are the device's time.  Prints one JSON line
per turn, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

WORKER = r"""
import importlib.util, json, sys
import numpy as np, torch
root, here, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("cs", here + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from aligngraph_tpu_torch.ops import banded_sw_cuda as k
from aligngraph_tpu_torch.workload import tile_lanes
assert k.__file__.startswith(root), k.__file__
out = {"root": root}
rng = np.random.default_rng(0)
shapes = [("L100 pad16", lambda: cs.dp_lanes(rng, 98_304, 100, 16), 16,
           ("score",)),
          ("L100 pad16", lambda: cs.dp_lanes(rng, 4_096, 100, 16), 16,
           ("dp", "traceback")),
          ("L512 pad16", lambda: tile_lanes(rng, 2_048, 512, 16), 16,
           ("score", "dp", "traceback"))]
for label, make, pad, names in shapes:
    reads, rlens, windows, g0 = (torch.from_numpy(a).cuda() for a in make())
    B = reads.shape[0]
    if "score" in names:
        out[f"score {label} {B} lanes"] = cs.cuda_ms(
            lambda: k.sw_score_cuda(reads, rlens, windows, pad), reps)
    if "dp" not in names:
        continue
    tb, _, best_i, best_b = k.sw_dp_cuda(reads, rlens, windows, pad)
    # the first n lanes; the parent's sw_dp_cuda takes no layout
    for n in cs.DP_SWEEP[label]:
        out[f"dp {label} {n} lanes"] = cs.cuda_ms(
            lambda: k.sw_dp_cuda(reads[:n], rlens[:n], windows[:n], pad),
            reps)
        out[f"traceback {label} {n} lanes"] = cs.cuda_ms(
            lambda: k.sw_traceback_cuda(tb[:n], best_i[:n], best_b[:n],
                                        g0[:n], pad), reps)
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    other = args.other.resolve()
    if not (other / "aligngraph_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"{other} holds no aligngraph_tpu_torch checkout")
    for root in (other, HERE, HERE, other):
        subprocess.run([sys.executable, "-c", WORKER, str(root), str(HERE),
                        str(args.reps)], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
