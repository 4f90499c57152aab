"""The contig aligner's seconds by layer, for this checkout and for other
checkouts, in turns: each other, this, this, each other in reverse order.

    python3 scripts/contig_split.py [--other DIR ...] [--mb 32]
        [--masb-mb 30.427671] [--depth 40] [--seed 3702]
        [--min-apart 1000000] [--device cuda] [--out DIR] [--keep DIR]

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory).  Each turn is
a process of its own that imports that checkout's aligngraph_tpu_torch
and runs, on --device:

  1. profile_contig's workload at --mb million bases (seed 5): the
     aligner on the reference, a warm align of the first
     profile_contig.WARM_CONTIGS contigs, then one
     profile_contig.layer_align (each layer on the host clock, the device
     synchronised around the layers that run on it; the checkout's own
     layers) and one plain align;
  2. chip_smoke.py's phase masb (make_misassembly_workload at --masb-mb
     million bases, --depth, --seed, --min-apart; genome and drafts
     through FASTA and the formalizers, the reads in memory;
     run_pipeline with misassembly_removal, --part 1 and the device
     k-mer build), then Eval of the drafts, of extended.fa +
     remaining.fa and of the corrected output on one target index;
     every contig align's seconds as the checkout reports them: the
     alignment stage's contig thread, stage (5)'s contig align of each
     file, each Eval's align and _finalize, and the aligner's own layer
     seconds where the checkout keeps them (ContigAligner.layer_s);
  3. the long Eval's align again (extended.fa + remaining.fa against the
     target), on Eval's own query set, by profile_contig.layer_align
     (chip_smoke.eval_align_layers' recipe).

Each turn prints one JSON line; every turn must give the same
placements, Eval metrics and output bytes.  Then the card's name and
power limit.  Writes DIR/contig_split.json when --out is given; --keep
copies the last turn's target.fa and uncorrected_all.fa (extended.fa
then remaining.fa) into its DIR, for chip_smoke.eval_align_layers.

CPU, small: --device cpu --mb 0.2 --masb-mb 0.2 --depth 5 --min-apart
50000 (~30 s a turn).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

WORKER = r"""
import hashlib, json, shutil, sys, tempfile, time
from pathlib import Path
root, device = sys.argv[1], sys.argv[2]
mb, masb_mb, depth, seed, min_apart = (float(sys.argv[3]),
                                       float(sys.argv[4]),
                                       float(sys.argv[5]),
                                       int(sys.argv[6]), int(sys.argv[7]))
keep = sys.argv[8]
sys.path.insert(0, root)
import numpy as np
import torch
from aligngraph_tpu_torch import (Config, Reads, formalize_contigs,
                                  formalize_genome)
from aligngraph_tpu_torch import profile_contig as pc
from aligngraph_tpu_torch.align import contig_aligner as cal
from aligngraph_tpu_torch.evaluate.evaluate import (eval_queries, evaluate,
                                                    genome_index)
from aligngraph_tpu_torch.io.fasta import encode, read_fasta
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.workload import (make_misassembly_workload,
                                           write_misassembly_fasta)
assert cal.__file__.startswith(root), cal.__file__
dev = torch.device(device)
out = {"root": root, "device": device}


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


def layers(ca, contigs):
    res, wall, totals, fin = pc.layer_align(ca, contigs, ca.device)
    _, plain = pc.timed_align(ca, contigs, ca.device)
    return dict(placements=res.n, wall_s=wall, plain_wall_s=plain,
                layers=totals, finalize_split=fin["split"])


# 1. profile_contig's workload
t0 = time.perf_counter()
reference, seqs = pc.make_workload(mb)
contigs = pc.make_contigs(seqs)
ca = cal.ContigAligner(reference, Config(), device=device)
pc.timed_align(ca, pc.make_contigs(seqs[:pc.WARM_CONTIGS]), ca.device)
out["profile_contig"] = dict(mb=mb, setup_s=time.perf_counter() - t0,
                             **layers(ca, contigs))
del ca, reference, seqs, contigs

# 2. phase masb
with tempfile.TemporaryDirectory() as tmp:
    work = Path(tmp)
    t0 = time.perf_counter()
    wl = make_misassembly_workload(round(masb_mb * 1e6), depth, seed,
                                   min_apart=min_apart)
    write_misassembly_fasta(work, wl)
    reads = Reads(len(wl["lens"]), wl["data"].shape[1], wl["data"],
                  wl["lens"])
    del wl
    cfg = Config(read1="-", read2="-", contig=str(work / "contigs.fa"),
                 genome=str(work / "genome.fa"), distance_low=300,
                 distance_high=700, part=1, misassembly_removal=True,
                 graph_build="device" if dev.type == "cuda" else "host",
                 extended_contig=str(work / "extended.fa"),
                 remaining_contig=str(work / "remaining.fa"),
                 work_dir=str(work / "tmp"))
    contigs = formalize_contigs(cfg.contig)
    genome = formalize_genome(cfg.genome, cfg.part)
    setup = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    res = run_pipeline(cfg, reads=reads, contigs=contigs, genome=genome,
                       device=device)
    sync()
    st = res.stats
    del reads, contigs, genome
    aligns = {"alignment_contig_thread": dict(
        wall_s=st["alignment_threads"]["contigs"],
        layer_s=st.get("contig_align_layers"))}
    for w, f in st["misassembly"].items():
        aligns[f"stage5_{w}"] = dict(
            wall_s=f["contigs_s"], finalize_s=f.get("finalize_s"),
            placements=f.get("placements"), layer_s=f.get("contigs_layer_s"))
    files = {}
    for name, pre in (("uncorrected", ""), ("corrected", "corrected_")):
        with open(work / f"{name}_all.fa", "wb") as fh:
            for w in ("extended", "remaining"):
                fh.write((work / f"{pre}{w}.fa").read_bytes())
    for name in ("extended", "remaining", "corrected_extended",
                 "corrected_remaining"):
        files[name] = hashlib.sha256(
            (work / f"{name}.fa").read_bytes()).hexdigest()
    index = genome_index(work / "target.fa", device=device)
    evals = {}
    for name, path in (("drafts", work / "contigs.fa"),
                       ("uncorrected", work / "uncorrected_all.fa"),
                       ("corrected", work / "corrected_all.fa")):
        es = {}
        sync()
        t0 = time.perf_counter()
        m = evaluate(work / "target.fa", path, device=device, index=index,
                     stats=es)
        sync()
        evals[name] = {k: m[k] for k in ("n_contigs", "n_true_contigs",
                                         "n50", "mpmb")}
        aligns[f"eval_{name}"] = dict(
            wall_s=es["align_s"], eval_s=time.perf_counter() - t0,
            finalize_s=es["finalize_s"], layer_s=es.get("layer_s"))
    del index
    if keep:
        Path(keep).mkdir(parents=True, exist_ok=True)
        for name in ("target.fa", "uncorrected_all.fa"):
            shutil.copy(work / name, Path(keep) / name)
    out["masb"] = dict(setup_s=setup, run_pipeline_s=res.wall_seconds,
                       stage_seconds=st["stage_seconds"], aligns=aligns,
                       evals=evals, files=files)
    # 3. the long Eval's align by layer
    gcat = np.concatenate([encode(s) for s in
                           read_fasta(work / "target.fa")[1]])
    q = eval_queries(read_fasta(work / "uncorrected_all.fa")[1])
    t0 = time.perf_counter()
    ca = cal.ContigAligner(gcat, Config(), accept=(0.0, 0.0, 0),
                           device=device)
    index_s = time.perf_counter() - t0
    out["long_eval"] = dict(chunks=q.n_chunks, index_s=index_s,
                            **layers(ca, q))
print(json.dumps(out), flush=True)
"""


def run_turn(root: Path, args) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", WORKER, str(root), args.device, str(args.mb),
         str(args.masb_mb), str(args.depth), str(args.seed),
         str(args.min_apart), str(args.keep or "")],
        capture_output=True, text=True, cwd=root)
    if out.returncode:
        sys.stderr.write(out.stderr[-8000:])
        raise SystemExit(f"turn in {root} failed ({out.returncode})")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--mb", type=float, default=32.0)
    ap.add_argument("--masb-mb", type=float, default=30.427671)
    ap.add_argument("--depth", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=3702)
    ap.add_argument("--min-apart", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--keep", type=Path)
    args = ap.parse_args(argv)
    others = [p.resolve() for p in args.other]
    turns = [*others, HERE, HERE, *reversed(others)] if others else [HERE]
    lines = [run_turn(root, args) for root in turns]
    same = {json.dumps([x["profile_contig"]["placements"],
                        x["long_eval"]["placements"], x["masb"]["evals"],
                        x["masb"]["files"]]) for x in lines}
    if len(same) != 1:
        raise SystemExit(f"turns differ in their results: {sorted(same)}")
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "contig_split.json").write_text(json.dumps(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
