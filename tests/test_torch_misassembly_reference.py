"""Stage (5), misassembly removal, of the port against the benchmark's
plain reference (agbench/reference/misassembly.py) on seeded samples of
BASELINE config 3's kind at a small size: a 200 kb genome at 10x (10,000
pairs), ~60 drafts, five of them chimeras (relocations and inversions).
remove_misassembly on the CPU and the reference give the same corrected
records, the same per-base coverage and the same final placements of
every draft, with the coverage summed in one group and in several
(_COV_CHUNK patched small).  The reference imports neither JAX nor the
port."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from agbench import common, workload
from agbench.reference import misassembly as reference
from aligngraph_tpu_torch.io.fasta import decode, read_fasta, write_fasta
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.pipeline import misassembly

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (2147483905, 77)
# a coverage group of at most this many bases holds a few drafts
SMALL_CHUNK = 20_000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config() -> dict:
    with open(ROOT / "agbench" / "configs" / "athaliana_chr1.json") as f:
        c = json.load(f)
    c["sample"].update(genome_len=200_000, depth=10, chimera_frac=0.15,
                       min_apart=30_000)
    c["pipeline"]["misassembly_removal"] = True
    return c


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def case(request, tmp_path_factory):
    """A sample, its drafts as FASTA, and the reference's stage (5)."""
    c = small_config()
    s = workload.make_sample(c, request.param, "cpu")
    assert len(s["lens"]) == 10_000 and 50 <= len(s["drafts"]) <= 70
    assert len(s["chimera_index"]) >= 4
    d = tmp_path_factory.mktemp("masb")
    ids = [f"c{i}" for i in range(len(s["drafts"]))]
    write_fasta(d / "contigs.fa", ids, [decode(x) for x in s["drafts"]])
    want = reference.remove_misassembly(s["ref"], s["drafts"], ids,
                                        s["data"], s["lens"], c, "cpu")
    return dict(config=c, sample=s, dir=d, want=want)


@pytest.mark.parametrize("groups", ["one", "several"])
def test_port_equals_reference(case, groups, monkeypatch, tmp_path):
    s, want = case["sample"], case["want"]
    got, calls = {}, []
    cover, place = misassembly._coverage_from_reads, misassembly._placements
    summed = misassembly.span_coverage

    def kept_cover(*args, **kwargs):
        got["cov"] = cover(*args, **kwargs)
        return got["cov"]

    def kept_place(*args, **kwargs):
        got["pos"] = place(*args, **kwargs)
        return got["pos"]

    def counted(*args, **kwargs):
        calls.append(kwargs["G"])
        return summed(*args, **kwargs)
    monkeypatch.setattr(misassembly, "_coverage_from_reads", kept_cover)
    monkeypatch.setattr(misassembly, "_placements", kept_place)
    monkeypatch.setattr(misassembly, "span_coverage", counted)
    if groups == "several":
        monkeypatch.setattr(misassembly, "_COV_CHUNK", SMALL_CHUNK)
    contigs = str(case["dir"] / "contigs.fa")
    out = str(tmp_path / "corrected.fa")
    reads = Reads(len(s["lens"]), s["data"].shape[1], s["data"], s["lens"])
    stats = {}
    misassembly.remove_misassembly(
        contigs, common.program_config(case["config"], contig=contigs),
        s["ref"], reads, "extended", None, out, device="cpu", stats=stats)
    assert (len(calls) > 1) == (groups == "several")

    ids, seqs = read_fasta(out)
    assert ids == [cid for cid, _ in want["pieces"]]
    assert seqs == [decode(x) for _, x in want["pieces"]]
    assert len(got["cov"]) == len(want["coverage"])
    for a, b in zip(got["cov"], want["coverage"]):
        np.testing.assert_array_equal(a, b)
    assert [[(p.target_id, p.source_start, p.source_end, p.target_start,
              p.target_end, p.fr) for p in plist]
            for plist in got["pos"]] == want["placements"]
    # the chimeras are split, and the sample is of the kind the cell runs
    assert stats["contigs_split"] >= 1
    assert stats["pieces_out"] == len(want["pieces"])


def test_first_spans_equal_one_whole_library_align(case):
    """Stage (5)'s read align, a batch a call, keeps of each pair the
    first record that one call over the whole library gives: over three
    full batches and a short last one, the batch shapes alike."""
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner

    s = case["sample"]
    reads = Reads(len(s["lens"]), s["data"].shape[1], s["data"], s["lens"])
    aligner = ReadAligner.build(
        s["ref"], common.program_config(case["config"]), batch_pairs=3000,
        c13=False, device="cpu")
    ts, te, n, split = misassembly._first_spans(aligner, reads)
    whole = aligner.align(reads)
    first = np.concatenate([[True], whole.pair_id[1:] != whole.pair_id[:-1]])
    assert n == whole.n and len(ts) == first.sum() > 0.8 * reads.n_pairs
    np.testing.assert_array_equal(ts, whole.target_start[first])
    np.testing.assert_array_equal(te, whole.target_end[first])
    assert set(split) == set(aligner.split)


def test_reference_imports_no_jax_and_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import agbench.reference.misassembly; "
            "print('LOADED', sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'aligngraph_tpu', 'aligngraph_tpu_torch')))").format(
                root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
