"""The three-chromosome sim of tests/test_torch_multichrom.py with --part 2
--iterativeMap (six parts, the reads and the contigs aligned part by part),
the port on the CPU against the JAX package, byte for byte; one seed index
a part serves both aligners."""

import pytest
import torch

from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch.align import contig_aligner, read_aligner
from aligngraph_tpu_torch.io.formalize import formalize_genome
from aligngraph_tpu_torch.pipeline import driver
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from tests.test_torch_multichrom import N_PAIRS, write_multichrom_sim
from tests.test_torch_pipeline import assert_outputs_equal, make_cfg, outputs

PART_FILES = ("extended.fa", "remaining.fa") + tuple(
    f"tmp/_{kind}.{p}.fa" for p in range(6)
    for kind in ("initial_contigs", "pre_extended_contigs",
                 "extended_contigs"))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pipeline and the port's (on the CPU) on the same inputs,
    with the genome lengths of every seed index build (any module's
    build_index) that the port's alignment stage made."""
    inputs = tmp_path_factory.mktemp("inputs")
    write_multichrom_sim(inputs)
    jdir = tmp_path_factory.mktemp("jax")
    jres = jax_run_pipeline(make_cfg(inputs, jdir, part=2,
                                     iterative_map=True))
    tdir = tmp_path_factory.mktemp("torch")
    built, in_align = [], []
    mods = (driver, contig_aligner, read_aligner)
    build, align = driver.build_index, driver._align

    def counted(genome, *args, **kw):
        if in_align:
            built.append(len(genome))
        return build(genome, *args, **kw)

    def stage(*args, **kw):
        in_align.append(True)
        try:
            return align(*args, **kw)
        finally:
            in_align.clear()

    for m in mods:
        m.build_index = counted
    driver._align = stage
    try:
        cfg = make_cfg(inputs, tdir, part=2, iterative_map=True)
        res = run_pipeline(cfg, device="cpu")
    finally:
        for m in mods:
            m.build_index = build
        driver._align = align
    return dict(inputs=inputs, jdir=jdir, jres=jres, tdir=tdir, res=res,
                cfg=cfg, built=built)


def test_part2_iterative_map_equals_jax(runs):
    jres, res, tdir, jdir = (runs[k] for k in ("jres", "res", "tdir",
                                               "jdir"))
    assert jres.stats["n_parts"] == 6 and len(jres.extended_ids) >= 2
    assert res.stats["n_parts"] == 6
    assert res.extended_ids == jres.extended_ids
    assert res.stats["kmer_build"] == jres.stats["kmer_build"]
    assert res.stats["read_alignments"] == jres.stats["read_alignments"]
    assert res.stats["contig_placements"] == \
        jres.stats["contig_placements"]
    assert_outputs_equal(outputs(tdir), outputs(jdir), PART_FILES)
    # every part aligned every read and every contig, on its own index;
    # the per-part records joined into the stage's records
    parts = res.stats["parts"]
    assert sorted(parts) == list(range(6))
    for p in parts.values():
        assert {"read_index_s", "reads_s", "read_records",
                "contigs_s", "contig_placements", "contig_layer_s",
                "kmer_build_s", "kmer_records", "traverse_s"} <= set(p)
    assert sum(p["read_records"] for p in parts.values()) == \
        res.stats["read_alignments"] > 0.8 * N_PAIRS
    assert "alignment_threads" not in res.stats
    assert res.stats["memory"]["alignment"]["arrays"]["rali_parts"] == \
        res.stats["part_records_bytes"] > 0


def test_one_index_per_part(runs):
    """One seed index a part, built once and handed to the part's read
    aligner and then its contig aligner: as many builds as parts of at
    least seed_len bases, each of its part's length, and no contig index
    time of its own; the output still the JAX package's, byte for byte."""
    res, cfg = runs["res"], runs["cfg"]
    genome = formalize_genome(cfg.genome, cfg.part)
    lens = [len(genome.part_seq(p)) for p in range(genome.n_parts)]
    want = [n for n in lens if n >= cfg.seed_len]
    assert runs["built"] == want and len(want) == res.stats["n_parts"]
    for p in res.stats["parts"].values():
        assert "contig_index_s" not in p and p["read_index_s"] > 0
    assert_outputs_equal(outputs(runs["tdir"]), outputs(runs["jdir"]),
                         PART_FILES)
