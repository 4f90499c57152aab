"""The check's control: the plain reference put in the program's place
with the gapless shortcut (reference/banded_sw.posmap(gapless=True)),
compared with the plain reference as a run's check compares the program.

    python3 agbench/control.py --workload <cell> --seeds 7,8,9

For each seed it makes the cell's sample, draws the answers a run's check
compares, and prints one JSON line with each compared number, which the
control must fail (a number above its limit).  It does not run the
program and is not part of a benchmark run.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import json  # noqa: E402

import torch  # noqa: E402

from agbench import common, harness  # noqa: E402


def readings(name: str, seed: int, *, bench=None, config=None, cell=None,
             device="cuda") -> dict:
    """The control's numbers on one seed -> {check name: (value, limit)}."""
    bench = bench or harness.benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    cell = cell or harness.load_json("cells", name)
    config = config or harness.load_json("configs", wl["config"])
    dev = torch.device(device)
    run = harness.Run(name, cell, config, seed, 0.0, False, dev)
    driver = harness.load_module("drivers", cell["driver"])
    s = common.sample(run, common.Clock(run.setup_split))
    kept = dict(sample=s, got=[])
    if "read_batches" in cell["check"]:
        kept["batches"] = common.read_batches(run, len(s["lens"]))
    if "drafts" in cell["check"]:
        kept["drafts"] = common.draft_sample(run, len(s["drafts"]))
    checks, _ = driver.check(run, kept, control=True)
    return {c["name"]: (c["value"], c["limit"]) for c in checks}


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="agbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("agbench: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "control": got,
                          "fails": any(v > lim for v, lim in got.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
