"""A genome of several chromosomes through the port on the CPU against the
JAX package, byte for byte: tests/test_pipeline.py's sim (seed 42, 30 kb,
1,500 pairs, 10 contigs) with its genome cut into three chromosomes of
4,000, 12,000 and ~14,000 bases (workload.split_chromosomes), so that
--part 1 makes one part a chromosome.  Here: --part 1, the same with the
device k-mer build, the CLI through --resume, and Eval against the
three-record target; and workload.make_multichrom_workload, the
generator of the 16-chromosome configuration, at a tiny size.
tests/test_torch_multichrom_parts.py runs --part 2 --iterativeMap."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu.evaluate.evaluate import evaluate as jax_evaluate
from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch import __main__ as cli
from aligngraph_tpu_torch import workload
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.io.fasta import decode, read_fasta, write_fasta
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from tests.simdata import make_simdata
from tests.test_torch_pipeline import (assert_outputs_equal, cli_args,
                                       make_cfg, outputs)

N_PAIRS = 1500
CHROMS = ("chrA", "chrB", "chrC")
# every part's stage files, and the outputs
PART1_FILES = ("extended.fa", "remaining.fa") + tuple(
    f"tmp/_{kind}.{p}.fa" for p in range(3)
    for kind in ("initial_contigs", "pre_extended_contigs",
                 "extended_contigs"))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_multichrom_sim(d: Path, n_pairs: int = N_PAIRS):
    """The sim as genome.fa (the reference in three records), target.fa
    (the target cut at the same places), contigs.fa, r1.fa, r2.fa in d."""
    sim = make_simdata(seed=42, genome_len=30_000, n_pairs=n_pairs,
                       read_len=100, insert=500, n_contigs=10,
                       snp_rate=0.01, err_rate=0.003)
    for name, seq in (("genome.fa", sim.reference),
                      ("target.fa", sim.target)):
        write_fasta(d / name, list(CHROMS),
                    [decode(c) for c in workload.split_chromosomes(seq)])
    write_fasta(d / "contigs.fa",
                [f"ctg{i}" for i in range(len(sim.contigs))],
                [decode(c) for c in sim.contigs])
    for mate, reads in (("r1", sim.reads1), ("r2", sim.reads2)):
        write_fasta(d / f"{mate}.fa", [f"p{i}" for i in range(n_pairs)],
                    [decode(r) for r in reads])
    return sim


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    write_multichrom_sim(d)
    return d


@pytest.fixture(scope="module")
def jax_part1(inputs, tmp_path_factory):
    """The JAX pipeline at --part 1: (its result, its output dir, the
    bytes of its outputs)."""
    out = tmp_path_factory.mktemp("jax")
    res = jax_run_pipeline(make_cfg(inputs, out))
    assert res.stats["n_parts"] == 3 and len(res.extended_ids) >= 2
    return res, out, outputs(out)


def test_part1_equals_jax(inputs, jax_part1, tmp_path):
    jres, _, want = jax_part1
    res = run_pipeline(make_cfg(inputs, tmp_path), device="cpu")
    assert res.stats["n_parts"] == 3
    assert res.extended_ids == jres.extended_ids
    assert res.stats["kmer_build"] == jres.stats["kmer_build"]
    assert_outputs_equal(outputs(tmp_path), want, PART1_FILES)
    # each part's graph figures; the reads were aligned once, on two
    # threads, and the contigs part by part
    parts = res.stats["parts"]
    assert sorted(parts) == [0, 1, 2]
    assert sum(p["kmer_records"] for p in parts.values()) > 0.8 * N_PAIRS
    assert all(p["contig_placements"] >= 1 for p in parts.values())
    assert set(res.stats["alignment_threads"]) == {
        "index", "reads", "contigs", "reads_wait_s", "reads_copy_out_s",
        "reads_concat_s"}


def test_part1_device_graph_build_equals_jax(inputs, jax_part1, tmp_path):
    """The device k-mer build at three part offsets, one of them a
    chromosome under 5 kb."""
    jres, _, want = jax_part1
    res = run_pipeline(make_cfg(inputs, tmp_path, graph_build="device"),
                       device="cpu")
    assert res.stats["kmer_build"] == jres.stats["kmer_build"]
    assert res.extended_ids == jres.extended_ids
    assert_outputs_equal(outputs(tmp_path), want, PART1_FILES)


def test_cli_through_resume_equals_jax(inputs, jax_part1, tmp_path):
    """The CLI (work dir ./tmp), then --resume from the alignment stage's
    checkpoint, which builds every part's graph again: the JAX package's
    bytes both times."""
    _, _, want = jax_part1
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(cli_args(make_cfg(inputs, tmp_path)),
                        device="cpu") == 0
        assert_outputs_equal(outputs(tmp_path), want, PART1_FILES)
        (tmp_path / "tmp" / "_checkpoint.txt").write_text("0\n")
        for f in ("extended.fa", "remaining.fa",
                  "tmp/_extended_contigs.2.fa"):
            (tmp_path / f).unlink()
        assert cli.main(["--resume"], device="cpu") == 0
    finally:
        os.chdir(cwd)
    assert_outputs_equal(outputs(tmp_path), want, PART1_FILES)


def test_eval_equals_jax(inputs, jax_part1, tmp_path):
    """Eval of the extended contigs against the three-record target: the
    same metrics and the same stats file."""
    _, jdir, _ = jax_part1
    want = jax_evaluate(inputs / "target.fa", jdir / "extended.fa",
                        str(tmp_path / "jax.txt"))
    got = evaluate(inputs / "target.fa", jdir / "extended.fa",
                   str(tmp_path / "torch.txt"), device="cpu")
    assert got == want
    assert got["n_true_contigs"] >= 1 and got["n_contigs"] >= 2
    assert (tmp_path / "torch.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def test_multichrom_workload(tmp_path):
    """Each chromosome gets its own reads and contigs: every mate is found
    in its own chromosome's target (one of five disjoint 20-mers of it,
    mate 2 reverse complemented) within an insert of its mate, every
    contig is a slice of its chromosome's target, and the pairs are in
    proportion to the lengths, within one pair; the FASTA files hold one
    record a chromosome and every read."""
    lens, depth = (3_000, 5_200, 8_100), 5.0
    wl = workload.make_multichrom_workload(lens, depth, seed=3)
    n = np.bincount(wl["pair_chrom"], minlength=len(lens))
    assert abs(n - depth * np.array(lens) / 200).max() < 1
    assert n.sum() == int(depth * sum(lens) / 200)
    assert np.array_equal(wl["pair_chrom"], np.repeat(np.arange(3), n))
    data, comp = wl["data"], workload.COMP
    for i, c in enumerate(wl["pair_chrom"]):
        t = wl["targets"][c].tobytes()
        at = []
        for mate in (data[2 * i], comp[data[2 * i + 1]][::-1]):
            found = [t.find(mate[w:w + 20].tobytes()) for w in
                     range(0, 100, 20)]
            hit = [(f - w) for w, f in zip(range(0, 100, 20), found)
                   if f >= 0]
            assert hit, (i, c)
            at.append(hit[0])
        assert 0 <= at[1] - at[0] <= 500 + 5 * 30, (i, c, at)
    assert len(wl["contigs"]) == len(wl["contig_chrom"]) >= 3
    assert set(wl["contig_chrom"].tolist()) == {0, 1, 2}
    for seq, c in zip(wl["contigs"], wl["contig_chrom"]):
        assert wl["targets"][c].tobytes().find(seq.tobytes()) >= 0
    for c in range(3):
        assert len(wl["targets"][c]) == lens[c]
        assert abs(len(wl["refs"][c]) - lens[c]) < 0.01 * lens[c]
    workload.write_multichrom_fasta(tmp_path, ["a", "b", "c"], wl)
    ids, seqs = read_fasta(tmp_path / "genome.fa")
    assert ids == ["a", "b", "c"] and [len(s) for s in seqs] == \
        [len(r) for r in wl["refs"]]
    ids, _ = read_fasta(tmp_path / "contigs.fa")
    assert ids[0] == "a.c0" and len(ids) == len(wl["contigs"])
    assert sum(1 for ln in open(tmp_path / "r2.fa")
               if ln.startswith(">")) == n.sum()
    # the 16-chromosome configuration's pair count
    r64 = [ln for _, ln in workload.YEAST_R64]
    assert len(r64) == 16 and sum(r64) == 12_071_326
    assert int(20 * sum(r64) / 200) == 1_207_132
