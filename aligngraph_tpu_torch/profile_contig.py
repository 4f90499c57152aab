"""Where the time of one ContigAligner.align goes, layer by layer: the
counterpart of scripts/profile_contig_align.py.

    python3 -m aligngraph_tpu_torch.profile_contig [--mb 1.0]
        [--device cuda] [--reps 3] [--out DIR]

The workload is the JAX script's: rng = np.random.default_rng(5), a
target of int(mb * 1e6) random bases, reference = mutate_fast(rng,
target), draft contigs = cut_contigs(rng, target) (one chunk each), and
Config().  The aligner is built on the reference (the index build is
timed on its own), aligns the first WARM_CONTIGS contigs once (on CUDA
that loads the kernels), then:

  1. layers: `reps` aligns, each layer timed on the host clock, the
     device synchronised around the layers that run on it:
       seed          ContigAligner._seed (the instance's, wrapped): every
                     chunk's and orientation's seeds looked up on the
                     device in a few batched calls; the hits stay there
       cluster       contig_aligner.cluster_hits (the module's, wrapped;
                     align looks it up at call time): the hits sorted
                     and cut into diagonal clusters on the device, the
                     kept clusters' summaries copied to the host
       chain         contig_aligner.chain_clusters (host): the greedy
                     chains over the kept clusters, the placements
       tile_diags    contig_aligner.build_tile_jobs: every placement's
                     tile diagonals and the tile jobs on the device
       dp            _run_tile_jobs, replaced on the instance by
                     run_tile_jobs_timed, a copy of its loop with a clock
                     between its three parts (held to the module's
                     pos_map bytes by tests/test_torch_profile_contig.py):
         windows_device   the batch's tiles, lengths, g0, destinations
                          and genome windows gathered on the device
                          (TileJobs.batch)
         dp_device        banded_sw_posmap_auto
         scatter          the position maps into the placements' buffer
                          on the device (Placements.scatter_tiles)
       finalize      ContigAligner._finalize (the instance's, wrapped):
                     the placements finalized on the device; its split
                     by step (contig_aligner.FINALIZE_STEPS) and counts
                     are the layer run's "finalize_split" and
                     "finalize_counts", and on CUDA the peak device
                     bytes allocated during it above what was allocated
                     before it "finalize_peak_bytes"
     The JAX script's chain is cluster + chain here, its other the job
     build: align's wall less seed, cluster, chain, dp and finalize
     (tile_diags and the segments' upload).
  2. walls: `reps` aligns with no wrapper; the kernels' launches and
     lanes by kernel and L (banded_sw_cuda.launches_by_length), and the
     chain DP's launches and placements ("chain"), over the first.
  3. on CUDA, one align under torch.profiler
     (profile_align.device_profile): device busy time, idle share and
     peak device memory; the ops by device time to
     DIR/profile_contig_device.txt.

The JSON's "seeding" holds the seed, hit and batch counts of one align,
the largest batch's device bytes as reckoned (ops/seeding
CONTIG_SEED_BYTES, CONTIG_HIT_BYTES) and, on CUDA, the peak device bytes
allocated during the seeding call above what was allocated before it and
the call's CUDA-event ms (measure_seeding).

Prints the JAX script's two lines (genome=... contigs=... placements=...
backend=..., then index_build=... align_wall=... seed=... chain=... dp=...
finalize=... other=..., from the first layer run; backend is the torch
device), a line per run, and last one JSON object of every number (also
DIR/profile_contig.json with --out).  There is no fallback: with
--device cuda and no CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from aligngraph_tpu_torch.align import contig_aligner as cal
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.formalize import Contigs
from aligngraph_tpu_torch.ops import banded_sw_cuda, monotone_chain
from aligngraph_tpu_torch.profile_align import device_profile
from aligngraph_tpu_torch.workload import cut_contigs, mutate_fast

# contigs of the warm-up align
WARM_CONTIGS = 16
# the layers of one align, in the order they are printed
LAYERS = ("seed", "cluster", "chain", "tile_diags", "dp", "windows_device",
          "dp_device", "scatter", "finalize")


def make_contigs(seqs) -> Contigs:
    """The JAX script's Contigs: contig i named c{i}, one chunk each."""
    return Contigs(
        ids=[f"c{i}" for i in range(len(seqs))],
        seqs=[np.asarray(c, np.int8) for c in seqs],
        chaff_ids=[], chaff_seqs=[],
        chunk_real=np.arange(len(seqs), dtype=np.int32),
        chunk_start=np.zeros(len(seqs), np.int64),
        chunk_len=np.array([len(c) for c in seqs], np.int64))


def make_workload(mb: float):
    """-> (reference int8, draft contig sequences), the JAX script's."""
    rng = np.random.default_rng(5)
    target = rng.integers(0, 4, int(mb * 1e6)).astype(np.int8)
    reference = mutate_fast(rng, target)
    return reference, cut_contigs(rng, target)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_tile_jobs_timed(ca, jobs, placements, totals: dict) -> None:
    """ContigAligner._run_tile_jobs(jobs, placements) on ca, line for line,
    with the seconds of each of its three parts added to totals
    (windows_device, dp_device, scatter)."""
    dev = ca.device
    for s in range(0, jobs.n, ca.dp_batch):
        _sync(dev)
        t0 = time.perf_counter()
        tiles, tlens, windows, g0s, dst = jobs.batch(s, ca.dp_batch)
        _sync(dev)
        t1 = time.perf_counter()
        _, pm = cal.banded_sw_posmap_auto(tiles, tlens, windows, g0s,
                                          pad=cal.TILE_PAD)
        _sync(dev)
        t2 = time.perf_counter()
        placements.scatter_tiles(pm, dst, tlens)
        _sync(dev)
        t3 = time.perf_counter()
        for name, a, b in (("windows_device", t0, t1), ("dp_device", t1, t2),
                           ("scatter", t2, t3)):
            totals[name] += b - a


def timed_align(ca, contigs, device):
    _sync(device)
    t0 = time.perf_counter()
    res = ca.align(contigs)
    _sync(device)
    return res, time.perf_counter() - t0


# contig_aligner's functions that layer_align wraps: (layer, whether the
# device is synchronised around it)
MODULE_LAYERS = {"cluster_hits": ("cluster", True),
                 "chain_clusters": ("chain", False),
                 "build_tile_jobs": ("tile_diags", True)}


def layer_align(ca, contigs, device) -> tuple:
    """One align with every layer timed -> (ContigAlignments, wall,
    {layer: seconds}, finalize) with finalize = the align's
    ca.finalize_split ("split") and ca.finalize_counts ("counts") and, on
    CUDA, "peak_bytes": the peak allocated during _finalize less what was
    allocated before it.  The wrappers are gone again on return."""
    totals = {name: 0.0 for name in LAYERS}
    fin: dict = {}

    def clocked(fn, name, sync):
        def timed(*args, **kwargs):
            if sync:
                _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                _sync(device)
            totals[name] += time.perf_counter() - t0
            return out
        return timed

    def jobs(j, p):
        run_tile_jobs_timed(ca, j, p, totals)

    finalize = clocked(ca._finalize, "finalize", True)

    def finalize_peak(p, c):
        if device.type != "cuda":
            return finalize(p, c)
        _sync(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = finalize(p, c)
        fin["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
        return out

    module = {name: getattr(cal, name) for name in MODULE_LAYERS}
    for name, (layer, sync) in MODULE_LAYERS.items():
        setattr(cal, name, clocked(module[name], layer, sync))
    ca._seed = clocked(ca._seed, "seed", True)
    ca._run_tile_jobs = clocked(jobs, "dp", True)
    ca._finalize = finalize_peak
    try:
        res, wall = timed_align(ca, contigs, device)
    finally:
        for name, fn in module.items():
            setattr(cal, name, fn)
        for name in ("_seed", "_run_tile_jobs", "_finalize"):
            del ca.__dict__[name]
    fin.update(split=dict(ca.finalize_split),
               counts=dict(ca.finalize_counts))
    return res, wall, totals, fin


def measure_seeding(ca, segs, device) -> tuple:
    """One ca.seed_hits(segs) -> (its host hits, ca.seeding), the stats
    with, on CUDA, device_peak_bytes (the peak allocated during the call
    less what was allocated before it) and device_ms (CUDA events around
    the call)."""
    if device.type != "cuda":
        hits = ca.seed_hits(segs)
        return hits, dict(ca.seeding)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    ev[0].record()
    hits = ca.seed_hits(segs)
    ev[1].record()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return hits, dict(ca.seeding, device_peak_bytes=peak - base,
                      device_ms=ev[0].elapsed_time(ev[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="directory for profile_contig.json and the op "
                         "table")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profile_contig --device cuda needs a CUDA "
                           "device and none is available")
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    reference, seqs = make_workload(args.mb)
    contigs = make_contigs(seqs)
    setup_s = time.perf_counter() - t0
    cfg = Config()
    t0 = time.perf_counter()
    ca = cal.ContigAligner(reference, cfg, device=device)
    index_s = time.perf_counter() - t0
    timed_align(ca, make_contigs(seqs[:WARM_CONTIGS]), device)

    report = dict(mb=args.mb, device=str(device), contigs=len(seqs),
                  genome_len=len(reference), setup_s=setup_s,
                  index_build_s=index_s, layers=[], layer_walls_s=[],
                  finalize_split=[], finalize_peak_bytes=[], walls_s=[])
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    for rep in range(args.reps):
        res, wall, totals, fin = layer_align(ca, contigs, device)
        report["layers"].append(totals)
        report["layer_walls_s"].append(wall)
        report["finalize_split"].append(fin["split"])
        if "peak_bytes" in fin:
            report["finalize_peak_bytes"].append(fin["peak_bytes"])
        if rep == 0:
            report["placements"] = res.n
            report["finalize_counts"] = fin["counts"]
            st = totals
            # the JAX script's two lines: its dp is _run_tile_jobs, its
            # chain cluster + chain, its other the tile-job build
            chain = st["cluster"] + st["chain"]
            other = wall - st["seed"] - chain - st["dp"] - st["finalize"]
            print(f"genome={args.mb}Mb contigs={len(seqs)} "
                  f"placements={res.n} backend={device}")
            print(f"index_build={index_s:.1f}s align_wall={wall:.1f}s "
                  f"seed={st['seed']:.1f}s chain={chain:.1f}s "
                  f"dp={st['dp']:.1f}s finalize={st['finalize']:.1f}s "
                  f"other={other:.1f}s", flush=True)
        print("layers", round(wall, 4),
              {k: round(v, 4) for k, v in totals.items()}, flush=True)
        print("finalize split", {k: round(v, 4)
                                 for k, v in fin["split"].items()},
              "counts", fin["counts"], "peak bytes",
              fin.get("peak_bytes"), flush=True)
    for rep in range(args.reps):
        banded_sw_cuda.reset_launches()
        monotone_chain.reset_launches()
        res, wall = timed_align(ca, contigs, device)
        if rep == 0:
            report["launches_by_length"] = dict(
                banded_sw_cuda.launches_by_length(),
                chain={"launches": monotone_chain.LAUNCHES["chain"],
                       "lanes": monotone_chain.LANES["chain"]})
        if res.n != report["placements"]:
            raise AssertionError(f"align gave {res.n} placements, the "
                                 f"layer run {report['placements']}")
        report["walls_s"].append(wall)
    print("walls", [round(w, 4) for w in report["walls_s"]], "launches",
          report.get("launches_by_length"), flush=True)
    _, report["seeding"] = measure_seeding(
        ca, cal.query_segments(contigs), device)
    print("seeding", report["seeding"], flush=True)
    if device.type == "cuda":
        report["profile"] = device_profile(ca, contigs, device, args.out,
                                           "profile_contig_device.txt")
        print("profile", report["profile"], flush=True)
    line = json.dumps(report)
    if args.out:
        with open(os.path.join(args.out, "profile_contig.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
