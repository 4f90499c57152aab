"""Where the time of one ReadAligner.align goes, layer by layer.

    python3 -m aligngraph_tpu_torch.profile_align [--device cuda]
        [--pairs 100000] [--genome-len 4600000] [--batch-pairs 32768]
        [--reps 3] [--out DIR]

Runs the read-aligner benchmark workload (workload.make_workload,
Config(distance_low=100, distance_high=900)) after two warm-up aligns:

  1. layers: `reps` aligns with each layer's function wrapped in a host
     clock.  Host layers (the wait for a batch's block of records, and
     the copy of its records out) are timed as they run; device layers
     (the reverse complement, the whole _align_core and, inside it, seed
     lookup, candidate selection, the DP fast path, segment extraction,
     then the C13 filter and packing, the decode of each layout and,
     inside it, the pos_map reconstruction, and the block of record
     rows) synchronise the device before and after, so each holds its
     own device work.  A layer that did not run reads 0 (the per-slot
     decode on this workload's dense batches, the full layout's decode
     when no batch overflows).
  2. walls: `reps` aligns with no wrapper.
  3. on CUDA, one align under torch.profiler: device busy time (the union
     of device op intervals), idle share = 1 - busy / wall, peak device
     memory, and the ops by device time (DIR/profile_device.txt).

Prints one line per run and, last, one JSON object of every number (also
written to DIR/profile_align.json when --out is given), with the last
align's batches by layout and bytes copied to the host
(ReadAligner.transfer) and its host seconds by step (ReadAligner.split).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from aligngraph_tpu_torch import Config, Reads
from aligngraph_tpu_torch.align import read_aligner as ra
from aligngraph_tpu_torch.workload import make_workload

# (name in read_aligner, label, synchronise the device around it)
LAYERS = (
    ("revcomp_padded", "revcomp_device", True),
    ("_align_core", "align_core_device", True),
    ("lookup_seeds_bucketed", "seed_lookup", True),
    ("select_candidates", "select_candidates", True),
    ("banded_sw_posmap_auto", "dp_fast_path", True),
    ("_extract_segments", "extract_segments", True),
    ("compact", "c13_pack_device", True),
    ("_expand_dense", "decode_dense_device", True),
    ("_expand_packed", "decode_per_slot_device", True),
    ("_expand_full", "decode_full_device", True),
    ("reconstruct_pos_map", "reconstruct_pos_map_device", True),
    ("_row_table", "row_table_device", True),
    ("_wait", "copy_wait_host", False),
    ("_copy_out", "copy_out_host", False),
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_layers(device: torch.device, totals: dict):
    """Wrap the LAYERS functions of read_aligner; their seconds add up in
    `totals`.  align looks them up as module globals at call time, so the
    wrappers see every call; the originals are restored on exit."""
    orig = {name: getattr(ra, name) for name, _, _ in LAYERS}

    def wrap(fn, label, sync):
        def timed(*args, **kwargs):
            if sync:
                _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                _sync(device)
            totals[label] = totals.get(label, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for name, label, sync in LAYERS:
        setattr(ra, name, wrap(orig[name], label, sync))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(ra, name, fn)


def timed_align(aligner, reads, device):
    _sync(device)
    t0 = time.perf_counter()
    res = aligner.align(reads)
    _sync(device)
    return res, time.perf_counter() - t0


def device_profile(aligner, reads, device, out_dir,
                   table_name="profile_device.txt"):
    """One aligner.align(reads) under torch.profiler -> dict of the
    profiled wall, device busy seconds, idle share and peak device memory
    (the ops by device time go to out_dir/table_name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed_align(aligner, reads, device)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    if out_dir:
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, table_name), "w") as f:
            f.write(table)
    return dict(profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
                idle_share=1 - busy_us / 1e6 / wall,
                device_events=len(spans),
                peak_device_gib=torch.cuda.max_memory_allocated(device)
                / 2**30)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--batch-pairs", type=int, default=32_768)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="directory for profile_align.json and the op table")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    ref, data, lens = make_workload(genome_len=args.genome_len,
                                    n_pairs=args.pairs)
    reads = Reads(args.pairs, data.shape[1], data, lens)
    cfg = Config(distance_low=100, distance_high=900)
    aligner = ra.ReadAligner.build(ref, cfg, batch_pairs=args.batch_pairs,
                                   device=device)
    for _ in range(2):
        timed_align(aligner, reads, device)

    report = dict(device=str(device), pairs=args.pairs, layers=[],
                  layer_walls_s=[], walls_s=[])
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    for _ in range(args.reps):
        totals = {label: 0.0 for _, label, _ in LAYERS}
        with timed_layers(device, totals):
            _, wall = timed_align(aligner, reads, device)
        report["layers"].append(totals)
        report["layer_walls_s"].append(wall)
        print("layers", round(wall, 4),
              {k: round(v, 4) for k, v in totals.items()}, flush=True)
    for _ in range(args.reps):
        report["walls_s"].append(timed_align(aligner, reads, device)[1])
    report["transfer"] = dict(aligner.transfer)
    report["split"] = dict(aligner.split)
    print("walls", [round(w, 4) for w in report["walls_s"]], "transfer",
          report["transfer"], "split", report["split"], flush=True)
    if device.type == "cuda":
        report["profile"] = device_profile(aligner, reads, device, args.out)
        print("profile", report["profile"], flush=True)
    line = json.dumps(report)
    if args.out:
        with open(os.path.join(args.out, "profile_align.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main()
