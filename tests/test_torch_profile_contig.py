"""aligngraph_tpu_torch.profile_contig on the CPU: the workload and counts
of scripts/profile_contig_align.py (run as a subprocess, JAX on the CPU),
every layer reported, its timed copy of _run_tile_jobs' loop equal to the
module's, the finalize split by step and its counts, and no fallback
without a CUDA device."""

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu_torch import profile_contig as pc
from aligngraph_tpu_torch.align import contig_aligner as cal
from aligngraph_tpu_torch.config import Config

REPO = Path(__file__).resolve().parent.parent
MB = 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def counts(line: str) -> dict:
    """The key=value fields of the scripts' first line."""
    return dict(re.findall(r"(\w+)=(\S+)", line))


def test_counts_equal_jax_script(tmp_path, capsys):
    proc = subprocess.run(
        [sys.executable, "scripts/profile_contig_align.py", str(MB), "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("genome=")]
    rep = pc.main(["--mb", str(MB), "--device", "cpu", "--reps", "1",
                   "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    got = counts(out[0])
    assert {k: got[k] for k in ("genome", "contigs", "placements")} == \
        {k: counts(want[0])[k] for k in ("genome", "contigs", "placements")}
    assert got["backend"] == "cpu"
    assert rep["contigs"] == int(got["contigs"]) > 10
    assert rep["placements"] == int(got["placements"])
    # the second line has the script's keys, in its order
    assert re.findall(r"(\w+)=", out[1]) == [
        "index_build", "align_wall", "seed", "chain", "dp", "finalize",
        "other"]
    # every layer is reported, and each runs on this workload
    layers = rep["layers"][0]
    assert set(layers) == set(pc.LAYERS)
    assert all(v > 0 for v in layers.values()), layers
    parts = sum(layers[k] for k in ("windows_device", "dp_device",
                                     "scatter"))
    assert parts <= layers["dp"]
    # the finalize split and counts (no peak bytes without CUDA)
    assert len(rep["finalize_split"]) == 1
    assert set(rep["finalize_split"][0]) == set(cal.FINALIZE_STEPS)
    assert rep["finalize_peak_bytes"] == []
    assert sum(rep["finalize_split"][0].values()) <= layers["finalize"]
    fc = rep["finalize_counts"]
    assert fc["placements"] >= fc["rows"] == rep["placements"]
    assert fc["blocks"] >= fc["dp_blocks"] >= fc["max_m"] >= 0
    assert fc["sum_m2"] >= fc["max_m"] ** 2
    assert fc["passes"] == 1 and fc["bases"] >= fc["blocks"]
    assert rep["launches_by_length"]["chain"] == {"launches": 0,
                                                  "lanes": 0}
    assert len(rep["walls_s"]) == 1 and rep["index_build_s"] > 0
    # the batched seeding's counts: every chunk and orientation at once
    sd = rep["seeding"]
    assert sd["seeds"] > sd["batches"] == 1 and sd["hits"] > 0
    assert sd["batch_bytes"] > 0 and "device_peak_bytes" not in sd
    assert (tmp_path / "profile_contig.json").exists()
    # the wrappers are gone again
    assert all(getattr(cal, n).__name__ == n for n in pc.MODULE_LAYERS)


def test_timed_tile_jobs_equal_module():
    """run_tile_jobs_timed gives each placement the pos_map bytes that
    ContigAligner._run_tile_jobs gives it, on the same jobs (the device's
    TileJobs, in several DP batches); and the layer-timed align the same
    alignments as a plain one."""
    reference, seqs = pc.make_workload(MB)
    contigs = pc.make_contigs(seqs)
    ca = cal.ContigAligner(reference, Config(), device="cpu")
    kept = {}

    def keep(jobs, placements):
        kept.update(jobs=jobs, placements=placements)

    ca._run_tile_jobs = keep
    ca.align(contigs)
    del ca._run_tile_jobs
    jobs, pl = kept["jobs"], kept["placements"]
    assert jobs.n > ca.dp_batch // 8
    ca.dp_batch = 32
    assert jobs.n > 2 * ca.dp_batch
    want = copy.deepcopy(pl)
    ca._run_tile_jobs(jobs, want)
    got = copy.deepcopy(pl)
    totals = dict.fromkeys(pc.LAYERS, 0.0)
    pc.run_tile_jobs_timed(ca, jobs, got, totals)
    assert got.buf.numpy().tobytes() == want.buf.numpy().tobytes()
    assert all((got.buf[a:b] >= 0).any()
               for a, b in zip(got.off[:-1], got.off[1:]))
    assert totals["dp_device"] > 0 and totals["windows_device"] > 0
    # through align: the timed layers change nothing
    plain = ca.align(contigs)
    timed, _, _, fin = pc.layer_align(ca, contigs, torch.device("cpu"))
    assert fin["counts"] == ca.finalize_counts
    for f in ("chunk_id", "fr", "score", "source_start", "source_end",
              "target_start", "target_end", "target_gap"):
        np.testing.assert_array_equal(getattr(timed, f), getattr(plain, f))
    assert [m.tobytes() for m in timed.pos_map] == \
        [m.tobytes() for m in plain.pos_map]


def test_without_gpu_raises(monkeypatch):
    """--device cuda (the default) with no CUDA device raises before any
    work: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pc.main(["--mb", "0.01"])
