"""The three-chromosome sim of tests/test_torch_multichrom.py with --part 2
--iterativeMap (six parts, the reads and the contigs aligned part by part),
the port on the CPU against the JAX package, byte for byte."""

import pytest
import torch

from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
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


def test_part2_iterative_map_equals_jax(tmp_path_factory):
    inputs = tmp_path_factory.mktemp("inputs")
    write_multichrom_sim(inputs)
    jdir = tmp_path_factory.mktemp("jax")
    jres = jax_run_pipeline(make_cfg(inputs, jdir, part=2,
                                     iterative_map=True))
    assert jres.stats["n_parts"] == 6 and len(jres.extended_ids) >= 2
    tdir = tmp_path_factory.mktemp("torch")
    res = run_pipeline(make_cfg(inputs, tdir, part=2, iterative_map=True),
                       device="cpu")
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
        assert {"read_index_s", "reads_s", "read_records", "contig_index_s",
                "contigs_s", "contig_placements", "contig_layer_s",
                "kmer_build_s", "kmer_records", "traverse_s"} <= set(p)
    assert sum(p["read_records"] for p in parts.values()) == \
        res.stats["read_alignments"] > 0.8 * N_PAIRS
    assert "alignment_threads" not in res.stats
    assert res.stats["memory"]["alignment"]["arrays"]["rali_parts"] == \
        res.stats["part_records_bytes"] > 0
