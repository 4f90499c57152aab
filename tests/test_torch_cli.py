"""The CLI's k-mer build rule and its read path through formalize_reads,
on the CPU against the JAX package, byte for byte, on
tests/test_pipeline.py's sim (seed 42, 30 kb, 3,000 pairs, 10 contigs):

- pipeline/driver.graph_build_for: the device build on a CUDA device for
  k <= 10, else the host build;
- the CLI with that rule, the CPU counted as the card (the device build
  runs on the CPU too): its files equal the JAX pipeline's, and --resume
  (which reloads a command that does not carry the build) keeps the rule,
  for k 5 (device) and k 11 (host, decided before the run, which then
  stops where the JAX package's host build stops);
- run_pipeline with stream_reads=True (the reads in a memmap under the
  work dir, as for FASTA past stream_reads_threshold): the JAX package's
  files with the same setting, and the port's in-memory run's;
- workload.write_reads_fasta writes what write_fasta writes."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch import __main__ as cli
from aligngraph_tpu_torch import workload
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import formalize_reads
from aligngraph_tpu_torch.pipeline import driver
from tests.test_torch_pipeline import (STAGE_FILES, assert_outputs_equal,
                                       cli_args, make_cfg, outputs,
                                       write_sim)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The sim's FASTA files, and the JAX pipeline's output on them with
    misassembly removal and stream_reads=True."""
    inputs = tmp_path_factory.mktemp("inputs")
    write_sim(inputs)
    jdir = tmp_path_factory.mktemp("jax")
    jax_run_pipeline(make_cfg(inputs, jdir, misassembly_removal=True,
                              stream_reads=True))
    assert (jdir / "tmp" / "_reads.npy").exists()
    return inputs, outputs(jdir)


@pytest.fixture
def cpu_as_card(monkeypatch):
    """graph_build_for with the CPU counted as the CUDA card."""
    rule = driver.graph_build_for
    monkeypatch.setattr(driver, "graph_build_for",
                        lambda device, k_mer: rule("cuda", k_mer))


def run_cli(argv, work: Path, capsys) -> str:
    """The CLI on the CPU in work (its work dir is ./tmp) -> the k-mer
    build its last line names."""
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert cli.main(argv, device="cpu") == 0
    finally:
        os.chdir(cwd)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("FINISHED:"), last
    return last.rsplit("k-mer build ", 1)[1]


def rewind_to_alignment(work: Path) -> None:
    """Leave only the alignment stage's checkpoint, so that --resume builds
    every part's graph again."""
    (work / "tmp" / "_checkpoint.txt").write_text("0\n")


@pytest.mark.parametrize("device,k,want", [
    ("cuda", 5, "device"), ("cuda", 10, "device"), ("cuda", 11, "host"),
    ("cpu", 5, "host"), ("cpu", 11, "host")])
def test_graph_build_rule(device, k, want):
    assert driver.graph_build_for(torch.device(device), k) == want
    assert driver.graph_build_for(device, k) == want


def test_cli_device_build_equals_jax_through_resume(sim, tmp_path, capsys,
                                                    cpu_as_card):
    inputs, want = sim
    argv = cli_args(make_cfg(inputs, tmp_path)) + ["--misassemblyRemoval"]
    assert run_cli(argv, tmp_path, capsys) == "device"
    assert_outputs_equal(outputs(tmp_path), want, STAGE_FILES)
    rewind_to_alignment(tmp_path)
    for f in ("extended.fa", "corrected_extended.fa",
              "tmp/_extended_contigs.0.fa"):
        (tmp_path / f).unlink()
    assert run_cli(["--resume"], tmp_path, capsys) == "device"
    assert_outputs_equal(outputs(tmp_path), want, STAGE_FILES)


def test_cli_k11_takes_host_build_through_resume(sim, tmp_path, capsys,
                                                 cpu_as_card):
    """k 11 is past the device build's 3-bit packing, so the rule picks
    the host build before the run.  The host build (graph/kmer_layer.py,
    the JAX package's, copied) packs 3 bits a base too and stops at its
    own assertion, after the alignment checkpoint.  --resume reloads k 11
    (the CLI's own default is 5) and picks the host build again: the
    device build's ValueError would show a rule applied before the
    reload."""
    inputs, _ = sim
    argv = cli_args(make_cfg(inputs, tmp_path)) + ["--kMer", "11"]
    for args in (argv, ["--resume"]):
        with pytest.raises(AssertionError, match="3-bit uint32 packing"):
            run_cli(args, tmp_path, capsys)
    assert (tmp_path / "tmp" / "_checkpoint.txt").read_text().split() == \
        ["0"]


def test_stream_reads_equals_jax_and_in_memory(sim, tmp_path):
    inputs, want = sim
    runs = {}
    for stream in (True, False):
        out = tmp_path / f"stream_{stream}"
        out.mkdir()
        res = driver.run_pipeline(
            make_cfg(inputs, out, misassembly_removal=True,
                     stream_reads=stream), device="cpu")
        assert (out / "tmp" / "_reads.npy").exists() == stream
        assert res.stats["graph_build"] == "host"
        runs[stream] = outputs(out)
    assert_outputs_equal(runs[True], want, STAGE_FILES)
    assert_outputs_equal(runs[True], runs[False])


def test_formalize_memmap_equals_in_memory(sim, tmp_path):
    """The memmap read matrix: the in-memory one's values, and writable
    (torch.from_numpy takes it without a copy or a warning)."""
    inputs, _ = sim
    r1, r2 = inputs / "r1.fa", inputs / "r2.fa"
    mem = formalize_reads(r1, r2)
    mm = formalize_reads(r1, r2, memmap_path=tmp_path / "_reads.npy")
    assert isinstance(mm.data, np.memmap) and mm.data.flags.writeable
    np.testing.assert_array_equal(mm.data, mem.data)
    np.testing.assert_array_equal(mm.lengths, mem.lengths)
    assert torch.equal(torch.from_numpy(mm.data[:8]),
                       torch.from_numpy(mem.data[:8]))


@pytest.mark.parametrize("block", [3, 1 << 16])
def test_write_reads_fasta_equals_write_fasta(tmp_path, monkeypatch, block):
    monkeypatch.setattr(workload, "FASTA_BLOCK_PAIRS", block)
    rng = np.random.default_rng(0)
    n = 40
    data = rng.integers(0, 5, (2 * n, 130)).astype(np.int8)
    lens = rng.integers(0, 131, n).astype(np.int32)
    workload.write_reads_fasta(tmp_path, data, lens)
    for mate in (0, 1):
        write_fasta(tmp_path / "want.fa", [f"p{i}" for i in range(n)],
                    [decode(data[2 * i + mate, :lens[i]]) for i in range(n)])
        assert (tmp_path / f"r{mate + 1}.fa").read_bytes() == \
            (tmp_path / "want.fa").read_bytes()
