"""The port's Eval, misassembly removal, span coverage and compat CLIs on
the CPU against the JAX package's: equal metrics, byte-equal corrected
FASTA and byte-equal SAM / PSL / delta text."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligngraph_tpu.compat import blat_cli as jax_blat
from aligngraph_tpu.compat import bowtie2_cli as jax_bowtie2
from aligngraph_tpu.compat import nucmer_cli as jax_nucmer
from aligngraph_tpu.config import Config
from aligngraph_tpu.evaluate.evaluate import evaluate as jax_evaluate
from aligngraph_tpu.io.fasta import decode, write_fasta
from aligngraph_tpu.parallel.coverage import span_coverage as jax_span_cov
from aligngraph_tpu.pipeline.misassembly import \
    remove_misassembly as jax_remove_misassembly
from aligngraph_tpu_torch.compat import blat_cli, bowtie2_cli, nucmer_cli
from aligngraph_tpu_torch.evaluate import __main__ as eval_cli
from aligngraph_tpu_torch.evaluate.evaluate import evaluate
from aligngraph_tpu_torch.parallel.coverage import span_coverage
from aligngraph_tpu_torch.pipeline import misassembly
from tests.simdata import make_simdata, revcomp_np, simulate_reads
from tests.test_misassembly import make_reads_obj


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- Eval: the cases of tests/test_evaluate.py ---------------------------

def _eval_perfect(rng):
    genome = rng.integers(0, 4, 50_000).astype(np.int8)
    return genome, [genome[1000:6000], genome[10_000:18_000],
                    revcomp_np(genome[30_000:34_000])]


def _eval_chimera(rng):
    genome = rng.integers(0, 4, 60_000).astype(np.int8)
    return genome, [np.concatenate([genome[5000:9000],
                                    genome[40_000:44_000]])]


def _eval_cutoff(rng):
    genome = rng.integers(0, 4, 10_000).astype(np.int8)
    return genome, [genome[100:1099], genome[2000:5000]]


EVAL_CASES = {"perfect": (0, _eval_perfect), "misassembled": (1,
              _eval_chimera), "cutoff": (2, _eval_cutoff)}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_equals_jax(case, tmp_path):
    seed, make = EVAL_CASES[case]
    genome, contigs = make(np.random.default_rng(seed))
    write_fasta(tmp_path / "g.fa", ["chr1"], [decode(genome)])
    write_fasta(tmp_path / "c.fa", [f"c{i}" for i in range(len(contigs))],
                [decode(c) for c in contigs])
    want = jax_evaluate(tmp_path / "g.fa", tmp_path / "c.fa",
                        out_path=str(tmp_path / "jax.txt"))
    got = evaluate(tmp_path / "g.fa", tmp_path / "c.fa",
                   out_path=str(tmp_path / "torch.txt"), device="cpu")
    assert got == want and got["n_contigs"] >= 1
    assert ((tmp_path / "torch.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())


def test_eval_cli(tmp_path, capsys):
    genome, contigs = _eval_perfect(np.random.default_rng(0))
    write_fasta(tmp_path / "g.fa", ["chr1"], [decode(genome)])
    write_fasta(tmp_path / "c.fa", ["a", "b", "c"],
                [decode(c) for c in contigs])
    assert eval_cli.main([str(tmp_path / "g.fa"), str(tmp_path / "c.fa"),
                          str(tmp_path / "s.txt")], device="cpu") == 0
    assert "n_true_contigs: 3" in capsys.readouterr().out
    assert eval_cli.main(["only-one"], device="cpu") == 2


# --- misassembly removal: the cases of tests/test_misassembly.py --------

def _chimera(tmp_path):
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 40_000).astype(np.int8)
    junk = rng.integers(0, 4, 400).astype(np.int8)
    chimera = np.concatenate([genome[2000:6000], junk, genome[20_000:24_000]])
    write_fasta(tmp_path / "out.fa", ["chim"], [decode(chimera)])
    r1, r2, _ = simulate_reads(rng, genome, 3000, read_len=80, insert=400,
                               err_rate=0.0)
    return genome, make_reads_obj(r1, r2), 3, "extended", None


def _clean(tmp_path):
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 20_000).astype(np.int8)
    write_fasta(tmp_path / "out.fa", ["ok"], [decode(genome[3000:8000])])
    r1, r2, _ = simulate_reads(rng, genome, 1000, read_len=80, insert=400,
                               err_rate=0.0)
    return genome, make_reads_obj(r1, r2), 3, "extended", None


def _remaining(tmp_path):
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 10_000).astype(np.int8)
    write_fasta(tmp_path / "out.fa", ["r0"], [decode(genome[1000:4000])])
    reads = make_reads_obj(*simulate_reads(rng, genome, 500, read_len=80,
                                           insert=400)[:2])
    return genome, reads, 2, "remaining", (["tiny"], [b"ACGT" * 20])


def _three(tmp_path):
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 40_000).astype(np.int8)
    chimera = np.concatenate([genome[2000:6000],
                              rng.integers(0, 4, 400).astype(np.int8),
                              genome[20_000:24_000]])
    pieces = [chimera, genome[9000:12_000], genome[25_000:29_000]]
    write_fasta(tmp_path / "out.fa", [f"c{i}" for i in range(len(pieces))],
                [decode(p) for p in pieces])
    r1, r2, _ = simulate_reads(rng, genome, 3000, read_len=80, insert=400,
                               err_rate=0.0)
    return genome, make_reads_obj(r1, r2), 3, "extended", None


# name: (inputs, coverage groups forced to one contig each?)
MISASSEMBLY_CASES = {"chimeric_split": (_chimera, False),
                     "clean_untouched": (_clean, False),
                     "remaining_gets_chaff": (_remaining, False),
                     "coverage_chunked_groups": (_three, True)}


@pytest.mark.parametrize("case", sorted(MISASSEMBLY_CASES))
def test_remove_misassembly_equals_jax(case, tmp_path, monkeypatch):
    make, chunked = MISASSEMBLY_CASES[case]
    genome, reads, coverage, which, chaff = make(tmp_path)
    cfg = Config(distance_low=100, distance_high=700, coverage=coverage)
    want = jax_remove_misassembly(str(tmp_path / "out.fa"), cfg, genome,
                                  reads, which=which, chaff=chaff,
                                  out_path=str(tmp_path / "jax.fa"))
    if chunked:
        monkeypatch.setattr(misassembly, "_COV_CHUNK", 3000)
    got = misassembly.remove_misassembly(
        str(tmp_path / "out.fa"), cfg, genome, reads, which=which,
        chaff=chaff, out_path=str(tmp_path / "torch.fa"), device="cpu")
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(got, "rb") as f:
        assert f.read() == want_bytes
    if case in ("chimeric_split", "coverage_chunked_groups"):
        assert b" : part1" in want_bytes


def test_span_coverage_equals_jax():
    rng = np.random.default_rng(4)
    G = 5000
    starts = rng.integers(-50, G + 50, 3000).astype(np.int32)
    ends = (starts + rng.integers(-20, 400, 3000)).astype(np.int32)
    got = span_coverage(torch.from_numpy(starts), torch.from_numpy(ends), G)
    want = jax_span_cov(jnp.asarray(starts), jnp.asarray(ends), G=G)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- compat CLIs: the same text as the JAX package's --------------------

@pytest.fixture(scope="module")
def compat_inputs(tmp_path_factory):
    """A two-record genome, PE reads and contigs (some reverse-complement,
    one below 200 bp) as FASTA files."""
    d = tmp_path_factory.mktemp("compat")
    sim = make_simdata(seed=8, genome_len=20_000, n_pairs=200, read_len=90,
                       insert=400, n_contigs=6, snp_rate=0.01)
    ref = sim.reference
    write_fasta(d / "db.fa", ["chrA", "chrB"],
                [decode(ref[:12_000]), decode(ref[12_000:])])
    n = len(sim.reads1)
    write_fasta(d / "r1.fa", [f"p{i}" for i in range(n)],
                [decode(r) for r in sim.reads1])
    write_fasta(d / "r2.fa", [f"p{i}" for i in range(n)],
                [decode(r) for r in sim.reads2])
    qs = [c if i % 2 else revcomp_np(c) for i, c in enumerate(sim.contigs)]
    qs.append(sim.target[500:650])
    write_fasta(d / "q.fa", [f"q{i}" for i in range(len(qs))],
                [decode(q) for q in qs])
    return d


def _run_both(jax_main, torch_main, argv_of):
    """Run each CLI with its own output name; -> (jax bytes, torch
    bytes)."""
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        argv, out = argv_of(name)
        kw = {} if name == "jax" else {"device": "cpu"}
        assert main(argv, **kw) == 0
        outs.append(out.read_bytes())
    return outs


def test_bowtie2_cli_equals_jax(compat_inputs):
    d = compat_inputs
    want, got = _run_both(jax_bowtie2.main, bowtie2_cli.main, lambda n: (
        ["-f", "--no-mixed", "-k", "5", "--local", "-I", "150", "-X", "650",
         "--no-discordant", "-x", str(d / "db"), "-1", str(d / "r1.fa"),
         "-2", str(d / "r2.fa"), "--reorder", "-S", str(d / f"{n}.sam")],
        d / f"{n}.sam"))
    assert got == want and want.count(b"\n") > 200


@pytest.mark.parametrize("fast_map", [False, True])
def test_blat_cli_equals_jax(compat_inputs, fast_map):
    d = compat_inputs
    flag = ["-fastMap"] if fast_map else []
    want, got = _run_both(jax_blat.main, blat_cli.main, lambda n: (
        [str(d / "db.fa"), str(d / "q.fa"), "-noHead",
         str(d / f"{n}_{fast_map}.psl")] + flag,
        d / f"{n}_{fast_map}.psl"))
    assert got == want and want.count(b"\n") >= 5


def test_nucmer_cli_equals_jax(compat_inputs):
    d = compat_inputs
    want, got = _run_both(jax_nucmer.main, nucmer_cli.main, lambda n: (
        [str(d / "db.fa"), str(d / "q.fa"), "-p", str(d / n)],
        d / f"{n}.delta"))
    assert got == want and want.count(b"\n") > 5
