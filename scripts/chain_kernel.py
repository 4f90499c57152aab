"""Times monotone_chain_kernel (aligngraph_tpu_torch/csrc/monotone_chain.cu)
of this checkout and of other checkouts on one GPU, on the same inputs, in
turns: each other, this, this, each other in reverse order.

    python3 scripts/chain_kernel.py [--other DIR ...] [--launch FILE ...]
                                    [--reps N] [--out FILE]
    python3 scripts/chain_kernel.py --capture DIR

--capture runs chip_smoke.py's phases chroms and masb (on "cuda", with
their checks) and writes the inputs of each phase's chain call with the
most (i, j) pairs to DIR/<phase>.npz (int64 t0, t1, w, offsets): the real
launches of the main path.  --launch times such files beside the seeded
shapes (chip_smoke.chain_blocks): single placements of 50,000, 18,235 and
8,192 blocks, and 400 placements of 2-64 blocks.

Each turn is a process of its own that builds that checkout's library
(nvcc, into its aligngraph_tpu_torch/_build/) and times, per shape, its
monotone_chain_cuda as the main path calls it ("call_ms": the launch plan
and its copy to the host inside) and, where the checkout has it, its
kernel alone on a plan made first ("kernel_ms", ops/monotone_chain._launch),
each with chip_smoke.cuda_ms (CUDA events around `reps` calls queued
behind a sleep of the stream).  This checkout's first turn holds every
shape against monotone_chain_plain (tolerance 0), and every turn's
outputs must equal it byte for byte (a hash per shape).  A variant of the
kernel is another checkout: for example a copy of this one with a
constant of csrc/monotone_chain.cu edited, in a git-ignored directory.
Prints one JSON line per turn and the card's name and power limit; --out
also writes them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEEDED = (50_000, 18_235, 8_192)


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_chain", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def shapes(cs, launches) -> dict:
    """label -> CUDA int64 (t0, t1, w, offsets): each --launch file, then
    the seeded shapes, each from its own seed."""
    import numpy as np
    import torch

    out = {}
    for path in launches:
        with np.load(path) as f:
            out[Path(path).stem] = tuple(
                torch.from_numpy(f[k]).cuda()
                for k in ("t0", "t1", "w", "offsets"))
    for m in SEEDED:
        out[f"m {m}"] = cs.chain_blocks(np.random.default_rng(m), [m])
    rng = np.random.default_rng(64)
    out["400 x m 2-64"] = cs.chain_blocks(rng, rng.integers(2, 65, 400))
    return out


def worker(root: Path, launches, reps: int, check: bool) -> None:
    """One turn: root's monotone_chain_cuda on every shape."""
    import hashlib

    import torch

    sys.path.insert(0, str(root))
    from aligngraph_tpu_torch.ops import monotone_chain as mc
    if not mc.__file__.startswith(str(root)):
        raise RuntimeError(f"{mc.__file__} is not under {root}")
    cs = load_smoke()
    card = cs.card_figures(torch.cuda.get_device_name(0))
    rec = {"root": str(root), "call_ms": {}, "kernel_ms": {}, "sha1": {},
           "bound_ms": {}, "max_abs_err": {}, "plan": {}}
    for label, x in shapes(cs, launches).items():
        got = mc.monotone_chain_cuda(*x)
        torch.cuda.synchronize()
        rec["sha1"][label] = hashlib.sha1(b"".join(
            g.cpu().numpy().tobytes() for g in got)).hexdigest()
        if check:
            want = mc.monotone_chain_plain(*x)
            rec["max_abs_err"][label] = max(
                cs.max_err(g, e) for g, e in zip(got, want))
        m = x[3][1:] - x[3][:-1]
        n = reps if int(m.max()) <= 20_000 else 3
        rec["call_ms"][label] = cs.cuda_ms(lambda: mc.monotone_chain_cuda(*x),
                                           n)
        if hasattr(mc, "_launch"):
            plan = mc.chain_plan(*x, mc.kernel_limits())
            rec["plan"][label] = [plan.n_cluster, plan.n_cta, plan.n_warp,
                                  int(plan.wide)]
            rec["kernel_ms"][label] = cs.cuda_ms(
                lambda: mc._launch(*x, plan), n)
        rec["bound_ms"][label] = cs.chain_bound(card, x[3])["bound_ms"]
    if hasattr(mc, "kernel_limits"):
        rec["limits"] = mc.kernel_limits()
    print(json.dumps(rec), flush=True)


def run_turn(root: Path, args, check: bool) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(root), "--reps", str(args.reps),
           *[a for p in args.launch for a in ("--launch", str(p))]]
    out = subprocess.run(cmd + (["--check"] if check else []),
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(rec), flush=True)
    return rec


def capture(out_dir: Path) -> None:
    """Phases chroms and masb of chip_smoke.py, each under
    largest_chain_launch: its largest chain call's inputs to out_dir."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    from aligngraph_tpu_torch.ops import _build

    cs = load_smoke()
    _build.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, run in (("chroms", cs.chromosomes),
                      ("masb", cs.misassembly_phase)):
        with tempfile.TemporaryDirectory() as tmp, \
                cs.largest_chain_launch() as kept:
            run(cs.kernel_results(), Path(tmp) / name, smi)
        t0, t1, w, off = (a.cpu().numpy() for a in kept["args"])
        np.savez_compressed(out_dir / f"{name}.npz", t0=t0, t1=t1, w=w,
                            offsets=off)
        m = off[1:] - off[:-1]
        print(json.dumps({"phase": name, "placements": len(m),
                          "blocks": int(off[-1]), "max_m": int(m.max()),
                          "pairs": kept["pairs"]}), flush=True)
        del kept
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--launch", type=Path, action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--capture", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chain_kernel.py needs one GPU")
    if args.worker:
        worker(args.worker, args.launch, args.reps, args.check)
        return 0
    if args.capture:
        capture(args.capture)
        return 0
    others = [p.resolve() for p in args.other]
    for p in others:
        if not (p / "aligngraph_tpu_torch" / "csrc").is_dir():
            raise SystemExit(f"{p} holds no aligngraph_tpu_torch checkout")
    turns = [*others, HERE, HERE, *reversed(others)]
    lines = [run_turn(root, args, check=i == len(others))
             for i, root in enumerate(turns)]
    ref = lines[len(others)]
    bad = {k: v for k, v in ref["max_abs_err"].items() if v != 0}
    bad.update({f"{rec['root']} {k}": v for rec in lines
                for k, v in rec["sha1"].items() if v != ref["sha1"][k]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines)
                            + smi + "\n")
    if bad:
        raise AssertionError(f"outputs differ from the plain version or "
                             f"between checkouts: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
