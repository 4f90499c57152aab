"""No module of the benchmark loads JAX or the JAX package, and the
plain reference loads nothing of the port: by the imports each file
names anywhere, and by what a whole run loads.  Names are compared by
their top-level part, whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from agbench import harness

AGBENCH = harness.HERE
JAX = {"jax", "jaxlib", "flax", "aligngraph_tpu"}
PORT = "aligngraph_tpu_torch"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(AGBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(AGBENCH)) for p in FILES])
def test_sources_import_no_jax(path):
    tops = imported_tops(path)
    assert not tops & JAX
    if "reference" in path.relative_to(AGBENCH).parts:
        assert PORT not in tops


def test_prefix_is_not_a_match():
    assert "aligngraph_tpu_torch".split(".")[0] not in JAX
    assert harness.forbidden_modules() == sorted(
        m for m in sys.modules if m.split(".")[0] in JAX)


RUN = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import bench_with_read_cell, tiny_config
from agbench import harness
res, _ = harness.execute({cell!r}, 3, 0.0, False, time.perf_counter(),
                         bench=bench_with_read_cell(),
                         config=tiny_config({config!r}), device="cpu")
assert res["correct"], res
import agbench.reference.read_aligner, agbench.reference.contig_aligner
bad = [m for m in sys.modules if m.split(".")[0] in {jax!r}]
print("LOADED", bad)
"""

REF = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from agbench import common
from agbench.reference import contig_aligner, read_aligner, seeding
g = np.random.default_rng(0).integers(0, 4, 50_000).astype(np.int8)
cfg = {{"aligner": dict(seed_len=13, seed_stride=12, max_seed_hits=8,
        band_pad=16, max_candidates=4, distance_low=300,
        distance_high=700, fast_map=False)}}
ref = common.Reference(g, cfg, "cpu")
ref.placements([g[1000:4000], g[20000:23000]])
print("LOADED", [m for m in sys.modules
                 if m.split(".")[0] in {names!r}])
"""


@pytest.mark.parametrize("cell, config", [
    ("athaliana_chr1.align_reads", "athaliana_chr1"),
    ("athaliana_chr1.align_contigs", "athaliana_chr1"),
    ("ecoli_k12.reassemble", "ecoli_k12")])
def test_a_run_loads_no_jax(cell, config):
    code = RUN.format(root=str(AGBENCH.parent),
                      tests=str(AGBENCH / "tests"), cell=cell,
                      config=config, jax=sorted(JAX))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_reference_loads_nothing_of_the_port():
    code = REF.format(root=str(AGBENCH.parent),
                      names=sorted(JAX | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
