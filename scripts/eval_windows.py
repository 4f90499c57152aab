"""Eval of one set of contigs against windows of its target, and of each
window's contigs against the whole target: does Eval's identity move with
the target's length, for the very same contigs?

    python3 scripts/eval_windows.py target.fa contigs.fa out_dir
        [--window-mb W ...] [--windows N] [--device cuda|cpu]

The target is one sequence.  Each contig is placed by an exact match of
the 32 bases at its middle, on either strand (contigs not found just once
are left out).  For each W the target is cut into consecutive windows of
W Mb, and the first N windows, each with the contigs whose whole span
(plus 1 kb) lies inside it, are written to out_dir/w{W}_{k}/{target,
contigs}.fa.  The port's Eval (aligngraph_tpu_torch.evaluate) then runs
on each window, on the same contigs against the whole target, and on all
the contigs against the whole target; one JSON line each.  The
JAX package's own CLI can evaluate the same files:
    python -m aligngraph_tpu.evaluate out_dir/w1_0/target.fa \\
        out_dir/w1_0/contigs.fa stats.txt
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aligngraph_tpu_torch.evaluate.evaluate import evaluate  # noqa: E402
from aligngraph_tpu_torch.io.fasta import read_fasta, write_fasta  # noqa: E402

PROBE = 32
MARGIN = 1_000


def place(target: bytes, seqs) -> list:
    """-> [(contig index, approximate target start)] of the contigs whose
    middle PROBE bases, or their reverse complement, occur once in the
    target."""
    out = []
    for i, s in enumerate(seqs):
        mid = len(s) // 2
        probe = s[mid:mid + PROBE]
        hits = [(at, at - mid) for at in _find_all(target, probe)]
        hits += [(at, at - (len(s) - mid - PROBE)) for at in _find_all(
            target, probe.translate(_RC)[::-1])]
        if len(hits) == 1:
            out.append((i, hits[0][1]))
    return out


_RC = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def _find_all(target: bytes, probe: bytes) -> list:
    at, out = target.find(probe), []
    while at >= 0 and len(out) < 2:
        out.append(at)
        at = target.find(probe, at + 1)
    return out


def run_eval(tfa: Path, cfa: Path, device: str, **row) -> dict:
    t0 = time.time()
    m = evaluate(tfa, cfa, out_path=str(cfa.with_suffix(".stats.txt")),
                 device=device)
    row.update(m, eval_s=round(time.time() - t0, 1))
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("target")
    ap.add_argument("contigs")
    ap.add_argument("out_dir")
    ap.add_argument("--window-mb", type=float, nargs="+", default=[1.0, 4.0])
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tids, tseqs = read_fasta(a.target)
    if len(tids) != 1:
        raise SystemExit("the target must be one sequence")
    target = tseqs[0]
    cids, cseqs = read_fasta(a.contigs)
    placed = place(target, cseqs)
    print(f"# {len(placed)} of {len(cids)} contigs placed on a target of "
          f"{len(target)} bases", file=sys.stderr, flush=True)
    for w_mb in a.window_mb:
        w = int(w_mb * 1e6)
        for k in range(a.windows):
            lo, hi = k * w, min((k + 1) * w, len(target))
            inside = [i for i, st in placed
                      if st - MARGIN >= lo
                      and st + len(cseqs[i]) + MARGIN <= hi]
            if not inside:
                continue
            d = out / f"w{w_mb:g}_{k}"
            d.mkdir(exist_ok=True)
            write_fasta(d / "target.fa", ["window"], [target[lo:hi]])
            write_fasta(d / "contigs.fa", [cids[i] for i in inside],
                        [cseqs[i] for i in inside])
            row = dict(window_mb=w_mb, k=k, start=lo, end=hi,
                       contigs=len(inside),
                       bases=sum(len(cseqs[i]) for i in inside))
            run_eval(d / "target.fa", d / "contigs.fa", a.device,
                     against="window", **row)
            run_eval(Path(a.target), d / "contigs.fa", a.device,
                     against="whole target", **row)
    d = out / "all"
    d.mkdir(exist_ok=True)
    write_fasta(d / "contigs.fa", cids, cseqs)
    run_eval(Path(a.target), d / "contigs.fa", a.device,
             against="whole target", window_mb=None, contigs=len(cids),
             bases=sum(len(s) for s in cseqs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
