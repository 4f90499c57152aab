"""The port's pipeline on the CPU against the JAX package's, byte for byte,
with the genome cut into two parts: --part 2 (read alignment over the whole
genome, contig alignment per part) and --part 2 --iterativeMap (both per
part)."""

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


@pytest.mark.parametrize("iterative_map", [False, True])
def test_part2_equals_jax(inputs, tmp_path, iterative_map):
    runs = []
    for name, run in (("jax", jax_run_pipeline),
                      ("torch", lambda c: run_pipeline(c, device="cpu"))):
        out = tmp_path / name
        out.mkdir()
        res = run(make_cfg(inputs, out, part=2,
                           iterative_map=iterative_map))
        assert res.stats["n_parts"] == 2
        runs.append((res, outputs(out)))
    (jres, want), (tres, got) = runs
    assert len(jres.extended_ids) >= 1
    assert tres.extended_ids == jres.extended_ids
    assert_outputs_equal(got, want, (
        "extended.fa", "remaining.fa", "tmp/_initial_contigs.1.fa",
        "tmp/_pre_extended_contigs.1.fa", "tmp/_extended_contigs.1.fa"))
