"""What misassembly removal does to each generated chimera, and why.

    python3 scripts/misassembly_chimeras.py [--mb 1.0] [--seed 7]
        [--frac 0.3] [--min-apart 200000] [--device cpu] [--out FILE]

Makes workload.make_misassembly_workload(mb * 1e6 bases, 40x, seed,
chimera_frac=frac, min_apart), writes its drafts as contigs.fa in a
temporary directory and runs pipeline/misassembly.remove_misassembly on
them as on a `remaining` file; each chimera's outcome is
workload.chimera_outcomes' reading of its stats (split, whole: a kept
placement covers >= 0.8 of it, kept: one piece otherwise).  For the
printout it runs the coverage and placement steps again
(_coverage_from_reads, _placements).  Prints one JSON line per chimera:
its strand (whether its second draft is reverse-complemented), the
lengths of its drafts and junk, their homes in the target, every
placement (source span, strand,
genome start, whether the span runs across the junk from draft to
draft, kept or dropped by the conflict rules) and its outcome;
then one line of counts by strand (workload.outcomes_by_strand) and the
seconds of remove_misassembly's steps.  --out writes the lines to FILE
and prints only the last.  At 1 Mb on the CPU: ~2 min.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frac", type=float, default=0.3)
    ap.add_argument("--min-apart", type=int, default=200_000)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    from aligngraph_tpu_torch import Config, Reads, formalize_contigs
    from aligngraph_tpu_torch.io.fasta import read_fasta
    from aligngraph_tpu_torch.pipeline import misassembly as m
    from aligngraph_tpu_torch.workload import (chimera_outcomes,
                                               make_misassembly_workload,
                                               outcomes_by_strand,
                                               write_misassembly_fasta)

    wl = make_misassembly_workload(int(a.mb * 1e6), 40.0, a.seed,
                                   chimera_frac=a.frac,
                                   min_apart=a.min_apart)
    cfg = Config(distance_low=300, distance_high=700)
    reads = Reads(len(wl["lens"]), wl["data"].shape[1], wl["data"],
                  wl["lens"])
    chimeras = [f"c{i}" for i in wl["chimera_index"]]
    stats: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_misassembly_fasta(tmp, wl)
        path = str(Path(tmp) / "contigs.fa")
        contigs = formalize_contigs(path)
        m.remove_misassembly(path, cfg, wl["ref"], reads, which="remaining",
                             chaff=(contigs.chaff_ids, contigs.chaff_seqs),
                             out_path=str(Path(tmp) / "corrected.fa"),
                             device=a.device, stats=stats)
        outs = chimera_outcomes(chimeras, {"remaining": stats},
                                {"remaining": read_fasta(path)[0]})
    cov = m._coverage_from_reads(reads, contigs, cfg, a.device, {})
    positions = m._placements(contigs, wl["ref"], cfg, cov, a.device, {})

    lines = []
    for k, idx in enumerate(wl["chimera_index"]):
        li, lj = (int(x) for x in wl["chimera_lens"][k])
        junk = int(wl["chimera_junk"][k])
        lines.append(json.dumps(dict(
            chimera=k, draft=chimeras[k],
            strand="rc" if wl["chimera_rc"][k] else "forward",
            lens=[li, junk, lj],
            homes=[int(h) for h in wl["chimera_homes"][k]],
            placements=[dict(source=[p.source_start, p.source_end],
                             fr=p.fr, genome_start=p.target_start,
                             across=(p.source_start < li
                                     and p.source_end > li + junk),
                             kept=p.target_id != m.NONE)
                        for p in positions[idx]],
            outcome=outs[k])))
    lines.append(json.dumps(dict(
        chimeras=len(chimeras),
        by_strand=outcomes_by_strand(outs, wl["chimera_rc"]),
        device=a.device,
        seconds={k: round(v, 2) for k, v in stats.items()
                 if k.endswith("_s")})))
    if a.out:
        Path(a.out).write_text("\n".join(lines) + "\n")
        print(lines[-1])
    else:
        print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
