"""The port's ReadAligner.align on the CPU against the JAX ReadAligner.align,
field by field (tolerance 0), and the port's independence from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu.align.read_aligner import ReadAligner as JaxAligner
from aligngraph_tpu.config import Config
from aligngraph_tpu.io.formalize import Reads
from aligngraph_tpu.ops.seeding import build_index as jax_build_index
from aligngraph_tpu_torch import ReadAligner
from aligngraph_tpu_torch.ops.seeding import SeedIndex
from aligngraph_tpu_torch.workload import make_workload
from tests.simdata import make_simdata
from tests.test_read_aligner import make_reads

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("pair_id", "fr", "score", "source_start", "source_end",
          "source_gap", "source_size", "target_start", "target_end",
          "target_gap", "pos_map")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_alignments_equal(got, want, min_records=0):
    assert got.n == want.n
    assert got.n >= min_records
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


# name: (simdata kwargs, align against target?, Config kwargs,
#        batch_pairs, c13, least number of records)
CASES = {
    # tests/test_read_aligner.py:36 (three batches, tail of 44 pairs)
    "sim3_c13": (dict(seed=3, genome_len=20_000, n_pairs=300, read_len=100,
                      insert=500, snp_rate=0.01), False,
                 dict(distance_low=200, distance_high=800), 128, True, 250),
    "sim3_raw": (dict(seed=3, genome_len=20_000, n_pairs=300, read_len=100,
                      insert=500, snp_rate=0.01), False,
                 dict(distance_low=200, distance_high=800), 128, False, 250),
    # :73, exact reads against the target
    "rc_exact": (dict(seed=9, genome_len=10_000, n_pairs=40, read_len=80,
                      insert=400, snp_rate=0.0, err_rate=0.0), True,
                 dict(distance_low=150, distance_high=650), 64, True, 35),
    # :107 and :198 (batches of 64 pairs in a P = 128 shape)
    "sim11_raw": (dict(seed=11, genome_len=15_000, n_pairs=200, read_len=90,
                       insert=450, snp_rate=0.01), False,
                  dict(distance_low=150, distance_high=750), 64, False, 100),
    "sim13_c13": (dict(seed=13, genome_len=15_000, n_pairs=150, read_len=90,
                       insert=450, snp_rate=0.02), False,
                  dict(distance_low=150, distance_high=750), 64, True, 50),
    # :153, the general (per-slot) transfer format on the JAX side
    "sim11_wide": (dict(seed=11, genome_len=15_000, n_pairs=120,
                        read_len=90, insert=450, snp_rate=0.01), False,
                   dict(distance_low=0, distance_high=40_000), 64, False,
                   50),
    # a tail batch in a smaller power-of-two shape (1536 then 1024 pairs)
    "tail_pow2": (dict(seed=17, genome_len=30_000, n_pairs=1700,
                       read_len=60, insert=300, snp_rate=0.01), False,
                  dict(distance_low=100, distance_high=500), 1536, True,
                  1500),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_equals_jax(case):
    sim_kw, on_target, cfg_kw, batch, c13, least = CASES[case]
    sim = make_simdata(**sim_kw)
    genome = sim.target if on_target else sim.reference
    reads = make_reads(sim)
    cfg = Config(**cfg_kw)
    want = JaxAligner.build(genome, cfg, batch_pairs=batch,
                            c13=c13).align(reads)
    got = ReadAligner.build(genome, cfg, batch_pairs=batch, c13=c13,
                            device="cpu").align(reads)
    assert_alignments_equal(got, want, least)


def test_no_reads_equals_jax():
    cfg = Config(distance_low=0, distance_high=1000)
    genome = np.zeros(1000, np.int8) + 1
    empty = Reads(0, 0, np.zeros((0, 0), np.int8), np.zeros(0, np.int32))
    want = JaxAligner.build(genome, cfg, batch_pairs=16).align(empty)
    got = ReadAligner.build(genome, cfg, batch_pairs=16,
                            device="cpu").align(empty)
    assert_alignments_equal(got, want)
    assert got.n == 0 and got.pos_map.shape == want.pos_map.shape


def test_from_index_carries_jax_index():
    """The JAX package's seed index, carried across with
    SeedIndex.from_numpy, aligns exactly as the port's own build."""
    sim = make_simdata(seed=5, genome_len=12_000, n_pairs=80, read_len=100,
                       insert=400, snp_rate=0.01)
    reads = make_reads(sim)
    cfg = Config(distance_low=200, distance_high=700)
    jidx = jax_build_index(sim.reference, cfg.seed_len)
    got = ReadAligner.from_index(sim.reference,
                                 SeedIndex.from_numpy(jidx, "cpu"), cfg,
                                 batch_pairs=64, device="cpu").align(reads)
    want = JaxAligner.build(sim.reference, cfg, batch_pairs=64).align(reads)
    assert_alignments_equal(got, want, 60)


def test_from_index_rejects_mismatched_index():
    genome = make_workload(genome_len=5_000, n_pairs=1)[0]
    idx = SeedIndex.from_numpy(jax_build_index(genome, 15), "cpu")
    with pytest.raises(ValueError, match="seed_len"):
        ReadAligner.from_index(genome, idx, Config(), device="cpu")
    with pytest.raises(ValueError, match="genome_len"):
        ReadAligner.from_index(genome[:-1], idx, Config(seed_len=15),
                               device="cpu")


def test_read_length_limit_equals_jax():
    cfg = Config(distance_low=0, distance_high=1000)
    genome = make_workload(genome_len=5_000, n_pairs=1)[0]
    L = 32768 - 2 * cfg.band_pad
    long = Reads(1, L, np.zeros((2, L), np.int8), np.array([L], np.int32))
    for al in (JaxAligner.build(genome, cfg),
               ReadAligner.build(genome, cfg, device="cpu")):
        with pytest.raises(ValueError, match="read length"):
            al.align(long)


@pytest.mark.parametrize("kw", [dict(), dict(return_target=True, seed=3)])
def test_workload_equals_bench(kw):
    import bench

    size = dict(genome_len=20_000, n_pairs=500)
    got = make_workload(**size, **kw)
    want = bench.make_workload(**size, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_workload_pipeline_equals_bench_pipeline():
    import bench_pipeline as bp

    from aligngraph_tpu_torch.workload import make_pipeline_workload

    glen, depth = 60_000, 5
    target, ref, data, lens, contigs = make_pipeline_workload(
        genome_len=glen, depth=depth)
    rng = np.random.default_rng(7)             # bench_pipeline.main's order
    w_target = rng.integers(0, 4, glen).astype(np.int8)
    w_ref = bp.mutate_fast(rng, w_target)
    w_data, w_lens = bp.simulate_pe_reads(
        rng, w_target, int(depth * glen / 200), read_len=100)
    w_contigs = bp.cut_contigs(rng, w_target)
    assert len(w_ref) != glen and len(contigs) == len(w_contigs) > 10
    for g, w in zip((target, ref, data, lens) + tuple(contigs),
                    (w_target, w_ref, w_data, w_lens) + tuple(w_contigs)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_workload_simdata_equals_tests_simdata():
    from aligngraph_tpu_torch.workload import make_simdata as port_simdata

    kw = dict(seed=42, genome_len=30_000, n_pairs=3000, read_len=100,
              insert=500, n_contigs=10, snp_rate=0.01, err_rate=0.003)
    want = make_simdata(**kw)
    target, reference, reads1, reads2, contigs = port_simdata(**kw)
    pairs = ([(target, want.target), (reference, want.reference)]
             + list(zip(reads1, want.reads1))
             + list(zip(reads2, want.reads2))
             + list(zip(contigs, want.contigs)))
    assert (len(reads1), len(contigs)) == (3000, len(want.contigs))
    assert len(reference) != len(target)       # indels were drawn
    for g, w in pairs:
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_port_sources_import_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or any
    module of the JAX package (aligngraph_tpu) or the JAX system's
    bench.py and bench_pipeline.py, in any form: the port keeps its own
    copies of the host modules it shares with it."""
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    pkg = re.compile(r"^\s*(import|from)\s+aligngraph_tpu(\s|\.|$)", re.M)
    # nor the JAX system's benchmark scripts at the repo's root
    scripts = re.compile(r"^\s*(import|from)\s+(bench|bench_pipeline)"
                         r"(\s|\.|$)", re.M)
    files = sorted((REPO / "aligngraph_tpu_torch").rglob("*.py"))
    assert {"contig_aligner.py", "driver.py", "misassembly.py",
            "refinement.py", "evaluate.py", "coverage.py",
            "__main__.py", "blat_cli.py", "kmer_layer_jit.py", "config.py",
            "types.py", "fasta.py", "formalize.py", "model.py",
            "contig_layer.py", "kmer_layer.py", "traverse.py",
            "checkpoint.py", "textout.py", "hostmem.py",
            "log.py", "mesh.py", "halo.py", "kmer_shard.py",
            "dryrun.py", "bench.py", "bench_pipeline.py",
            "ecoli_scale.py", "profile_align.py",
            "profile_contig.py"} <= {f.name for f in files}
    for f in files + [REPO / "chip_smoke.py"]:
        text = f.read_text()
        assert not pat.search(text), f
        assert not pkg.search(text), f
        assert not scripts.search(text), f
        # the multi-name form too: `import os, aligngraph_tpu.config`
        assert not re.search(r"^\s*import\s.*,\s*aligngraph_tpu(\s|\.|,|$)",
                             text, re.M), f


def test_profile_align_reports_every_layer(tmp_path):
    from aligngraph_tpu_torch import profile_align

    rep = profile_align.main(["--device", "cpu", "--pairs", "96",
                              "--genome-len", "20000", "--batch-pairs", "64",
                              "--reps", "1", "--out", str(tmp_path)])
    labels = {label for _, label, _ in profile_align.LAYERS}
    layers = rep["layers"][0]
    assert set(layers) == labels
    # two dense batches, none overflows: the per-slot decode and the
    # full layout's read 0, every other layer ran
    assert rep["transfer"]["dense"] == 2 and rep["transfer"]["host_bytes"]
    idle = {"decode_per_slot_device", "decode_full_device"}
    assert all(layers[k] == 0 for k in idle)
    assert all(v > 0 for k, v in layers.items() if k not in idle)
    assert set(rep["split"]) == {"wait_s", "copy_out_s", "concat_s"}
    assert len(rep["walls_s"]) == 1 and rep["walls_s"][0] > 0
    assert (tmp_path / "profile_align.json").exists()
    # the wrappers are gone again
    assert profile_align.ra._expand_full.__name__ == "_expand_full"


BLOCKED_JAX = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["aligngraph_tpu"] = None   # and any import of the JAX package
import importlib, pkgutil
import numpy as np
import aligngraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aligngraph_tpu_torch.__path__,
                                               "aligngraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= 40, names
from aligngraph_tpu_torch import Config, Reads
from aligngraph_tpu_torch.workload import make_workload
ref, data, lens = make_workload(genome_len=20_000, n_pairs=64)
al = aligngraph_tpu_torch.ReadAligner.build(
    ref, Config(distance_low=100, distance_high=900), batch_pairs=64,
    device="cpu")
res = al.align(Reads(64, data.shape[1], data, lens))
assert res.n >= 60, res.n

# the whole pipeline, with misassembly removal and Eval, on a small sim
import os, tempfile
from aligngraph_tpu_torch import decode, write_fasta
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from aligngraph_tpu_torch.workload import make_pipeline_workload
target, ref, data, lens, contigs = make_pipeline_workload(
    genome_len=30_000, depth=25)
with tempfile.TemporaryDirectory() as d:
    write_fasta(f"{d}/g.fa", ["chr"], [decode(ref)])
    write_fasta(f"{d}/t.fa", ["chr"], [decode(target)])
    write_fasta(f"{d}/c.fa", [f"c{i}" for i in range(len(contigs))],
                [decode(c) for c in contigs])
    for mate in (0, 1):
        write_fasta(f"{d}/r{mate + 1}.fa", [str(i) for i in range(len(lens))],
                    [decode(r) for r in data[mate::2]])
    cfg = Config(read1=f"{d}/r1.fa", read2=f"{d}/r2.fa", contig=f"{d}/c.fa",
                 genome=f"{d}/g.fa", distance_low=300, distance_high=700,
                 extended_contig=f"{d}/e.fa", remaining_contig=f"{d}/rem.fa",
                 work_dir=f"{d}/tmp", misassembly_removal=True,
                 graph_build="device")
    out = run_pipeline(cfg, device="cpu")
    assert out.extended_ids and os.path.exists(f"{d}/corrected_e.fa")
    metrics = evaluate(f"{d}/t.fa", f"{d}/e.fa", device="cpu")
    assert metrics["n_true_contigs"] >= 1, metrics
assert not any(m == "jax" or m.startswith("jax.") or m == "aligngraph_tpu"
               or m.startswith("aligngraph_tpu.") for m in sys.modules
               if sys.modules[m] is not None)
print("records", res.n, "extended", len(out.extended_ids))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", BLOCKED_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("records")
