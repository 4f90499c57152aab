"""The port's pipeline on the CPU against the JAX package's, byte for byte:
the extended, remaining and corrected FASTA and the tmp/ stage files, on
tests/test_pipeline.py's sim.  Here: the default run with misassembly
removal through the CLI and with the device k-mer build, --resume, the
degenerate parts case, and the CLI's surface."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu.config import Config
from aligngraph_tpu.io.fasta import decode, write_fasta
from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch import __main__ as cli
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from tests.simdata import make_simdata

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_sim(d: Path):
    """tests/test_pipeline.py's sim (seed 42, 30 kb, 3,000 pairs, 10
    contigs) as genome.fa, contigs.fa, r1.fa, r2.fa in d."""
    sim = make_simdata(seed=42, genome_len=30_000, n_pairs=3000,
                       read_len=100, insert=500, n_contigs=10,
                       snp_rate=0.01, err_rate=0.003)
    write_fasta(d / "genome.fa", ["refchr"], [decode(sim.reference)])
    write_fasta(d / "contigs.fa",
                [f"ctg{i}" for i in range(len(sim.contigs))],
                [decode(c) for c in sim.contigs])
    n = len(sim.reads1)
    write_fasta(d / "r1.fa", [f"p{i}" for i in range(n)],
                [decode(r) for r in sim.reads1])
    write_fasta(d / "r2.fa", [f"p{i}" for i in range(n)],
                [decode(r) for r in sim.reads2])
    return sim


def make_cfg(inputs: Path, out: Path, **kw):
    base = dict(read1=str(inputs / "r1.fa"), read2=str(inputs / "r2.fa"),
                contig=str(inputs / "contigs.fa"),
                genome=str(inputs / "genome.fa"),
                distance_low=300, distance_high=700,
                extended_contig=str(out / "extended.fa"),
                remaining_contig=str(out / "remaining.fa"),
                work_dir=str(out / "tmp"))
    base.update(kw)
    return Config(**base)


def cli_args(cfg: Config):
    """The reference-style argv of cfg's inputs and outputs."""
    return ["--read1", cfg.read1, "--read2", cfg.read2,
            "--contig", cfg.contig, "--genome", cfg.genome,
            "--distanceLow", str(cfg.distance_low),
            "--distanceHigh", str(cfg.distance_high),
            "--extendedContig", cfg.extended_contig,
            "--remainingContig", cfg.remaining_contig]


def outputs(out: Path) -> dict:
    """name -> bytes of every FASTA the pipeline wrote in out (extended,
    remaining, corrected_*) and in out/tmp (the stage files)."""
    files = {}
    for d, prefix in ((out, ""), (out / "tmp", "tmp/")):
        for f in sorted(os.listdir(d)):
            if f.endswith(".fa"):
                files[prefix + f] = (d / f).read_bytes()
    return files


def assert_outputs_equal(got: dict, want: dict, names_at_least=()):
    assert sorted(got) == sorted(want)
    for name in names_at_least:
        assert name in want, name
    for name in want:
        assert got[name] == want[name], name


STAGE_FILES = ("extended.fa", "remaining.fa", "corrected_extended.fa",
               "corrected_remaining.fa", "tmp/_initial_contigs.0.fa",
               "tmp/_pre_extended_contigs.0.fa", "tmp/_extended_contigs.0.fa")


@pytest.fixture(scope="module")
def sim_inputs(tmp_path_factory):
    inputs = tmp_path_factory.mktemp("inputs")
    write_sim(inputs)
    return inputs


@pytest.fixture(scope="module")
def misassembly_runs(sim_inputs, tmp_path_factory):
    """The JAX pipeline with --misassemblyRemoval, and the port's through
    its CLI (main(..., device="cpu"), work dir ./tmp)."""
    inputs = sim_inputs
    jdir = tmp_path_factory.mktemp("jax")
    jres = jax_run_pipeline(make_cfg(inputs, jdir, misassembly_removal=True))
    want = outputs(jdir)
    tdir = tmp_path_factory.mktemp("torch")
    cwd = os.getcwd()
    os.chdir(tdir)
    try:
        rc = cli.main(cli_args(make_cfg(inputs, tdir))
                      + ["--misassemblyRemoval"], device="cpu")
    finally:
        os.chdir(cwd)
    assert rc == 0
    return jres, want, tdir, outputs(tdir)


def test_cli_misassembly_run_equals_jax(misassembly_runs):
    jres, want, _, got = misassembly_runs
    assert len(jres.extended_ids) >= 1
    assert_outputs_equal(got, want, STAGE_FILES)


def test_resume_equals_jax(misassembly_runs):
    """--resume in the CLI's work dir restores the command and the
    checkpointed alignments and parts, then reruns refinement and
    misassembly removal: the same bytes again."""
    _, want, tdir, _ = misassembly_runs
    for f in ("extended.fa", "corrected_extended.fa"):
        (tdir / f).unlink()
    cwd = os.getcwd()
    os.chdir(tdir)
    try:
        assert cli.main(["--resume"], device="cpu") == 0
    finally:
        os.chdir(cwd)
    assert_outputs_equal(outputs(tdir), want, STAGE_FILES)


def test_degenerate_parts_equal_jax(tmp_path):
    """--iterativeMap where every genome part is shorter than the seed
    length (tests/test_pipeline.py:101): empty extended output."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20).astype(np.int8)
    contig = rng.integers(0, 4, 300).astype(np.int8)
    reads = [rng.integers(0, 4, 100).astype(np.int8) for _ in range(4)]
    write_fasta(tmp_path / "genome.fa", ["chr"], [decode(genome)])
    write_fasta(tmp_path / "contigs.fa", ["c0"], [decode(contig)])
    write_fasta(tmp_path / "r1.fa", ["p0", "p1"],
                [decode(r) for r in reads[:2]])
    write_fasta(tmp_path / "r2.fa", ["p0", "p1"],
                [decode(r) for r in reads[2:]])
    results = []
    for name, run in (("jax", jax_run_pipeline),
                      ("torch", lambda c: run_pipeline(c, device="cpu"))):
        out = tmp_path / name
        out.mkdir()
        res = run(make_cfg(tmp_path, out, part=2, iterative_map=True))
        assert res.extended_ids == [] and res.stats["n_parts"] == 2
        results.append(outputs(out))
    assert_outputs_equal(results[1], results[0],
                         ("extended.fa", "remaining.fa",
                          "tmp/_initial_contigs.1.fa"))


def test_device_graph_build_equals_jax(misassembly_runs, sim_inputs,
                                      tmp_path):
    """graph_build="device" (the port's k-mer layer build, here on the
    CPU) with misassembly removal: the same bytes as the JAX pipeline's
    host build, and the same k-mer build statistics."""
    jres, want, _, _ = misassembly_runs
    res = run_pipeline(make_cfg(sim_inputs, tmp_path, graph_build="device",
                                misassembly_removal=True), device="cpu")
    assert res.stats["kmer_build"] == jres.stats["kmer_build"]
    assert res.stats["kmer_build"]["tuples"] > 100_000
    assert_outputs_equal(outputs(tmp_path), want, STAGE_FILES)


def test_device_graph_build_raises(sim_inputs, tmp_path):
    """The device build packs a k-mer into 3 bits a base: k > 10 is
    refused before any chunk runs."""
    cfg = make_cfg(sim_inputs, tmp_path, graph_build="device", k_mer=11)
    with pytest.raises(ValueError, match="k-mer size 11"):
        run_pipeline(cfg, device="cpu")


def test_cli_without_gpu_raises(tmp_path, monkeypatch):
    """The CLI's default device is CUDA; with none it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(cli_args(make_cfg(tmp_path, tmp_path)))
    assert not (tmp_path / "tmp").exists()


def test_cli_usage_and_unknown_flag(capsys):
    assert cli.main(["--help"], device="cpu") == 0
    assert "aligngraph_tpu_torch" in capsys.readouterr().out
    assert cli.main(["--bogus", "1"], device="cpu") == 2
    assert "unknown flag" in capsys.readouterr().err
    proc = subprocess.run([sys.executable, "-m", "aligngraph_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "usage:" in proc.stdout
