"""The port's pipeline on the CPU against the JAX package's, byte for byte,
with the genome cut into two parts: --part 2 (read alignment over the whole
genome, contig alignment per part), --part 2 --iterativeMap (both per
part), and --part 2 with the device k-mer build."""

import pytest
import torch

from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch.pipeline.driver import run_pipeline
from tests.test_torch_pipeline import (
    assert_outputs_equal, make_cfg, outputs, write_sim)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    write_sim(d)
    return d


@pytest.fixture(scope="module")
def jax_part2(inputs, tmp_path_factory):
    """iterative_map -> (the JAX pipeline's result, its output bytes) with
    --part 2, each run once."""
    runs = {}

    def get(iterative_map):
        if iterative_map not in runs:
            out = tmp_path_factory.mktemp("jax")
            res = jax_run_pipeline(make_cfg(inputs, out, part=2,
                                            iterative_map=iterative_map))
            assert res.stats["n_parts"] == 2 and len(res.extended_ids) >= 1
            runs[iterative_map] = (res, outputs(out))
        return runs[iterative_map]

    return get


PART_FILES = ("extended.fa", "remaining.fa", "tmp/_initial_contigs.1.fa",
              "tmp/_pre_extended_contigs.1.fa", "tmp/_extended_contigs.1.fa")


@pytest.mark.parametrize("iterative_map", [False, True])
def test_part2_equals_jax(inputs, jax_part2, tmp_path, iterative_map):
    jres, want = jax_part2(iterative_map)
    tres = run_pipeline(make_cfg(inputs, tmp_path, part=2,
                                 iterative_map=iterative_map), device="cpu")
    assert tres.stats["n_parts"] == 2
    assert tres.extended_ids == jres.extended_ids
    assert_outputs_equal(outputs(tmp_path), want, PART_FILES)


def test_part2_device_graph_build_equals_jax(inputs, jax_part2, tmp_path):
    """graph_build="device" with --part 2: the second part's k-mer build
    runs at a non-zero part_offset."""
    jres, want = jax_part2(False)
    tres = run_pipeline(make_cfg(inputs, tmp_path, part=2,
                                 graph_build="device"), device="cpu")
    assert tres.stats["kmer_build"] == jres.stats["kmer_build"]
    assert tres.extended_ids == jres.extended_ids
    assert_outputs_equal(outputs(tmp_path), want, PART_FILES)
