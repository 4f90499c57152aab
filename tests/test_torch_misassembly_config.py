"""BASELINE.json config 3 (misassembly removal over a genome with chimeric
draft contigs, high-coverage PE reads) on the CPU: the generator
workload.make_misassembly_workload; the pipeline with misassembly removal
at 10 kb and 40x against the JAX package's, byte for byte; the
vectorised region sweep and split of pipeline/misassembly.py against the
per-base loops they replace; and stage (5)'s figures in run_pipeline's
stats."""

from pathlib import Path

import numpy as np
import pytest
import torch

from aligngraph_tpu.config import Config as JaxConfig
from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch import workload
from aligngraph_tpu_torch.align import contig_aligner as ca
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.evaluate.evaluate import evaluate, genome_index
from aligngraph_tpu_torch.io.fasta import read_fasta
from aligngraph_tpu_torch.pipeline import misassembly
from aligngraph_tpu_torch.pipeline.driver import run_pipeline

# the pipeline case: 10 kb at 40x (2,000 pairs), drafts of ~800 bases so
# that chimera_frac 0.6 of the 10 cut drafts gives 3 chimeras, each joining
# drafts >= 2.5 kb apart.  The JAX pipeline's three read aligns on the CPU
# take ~6.5 ms a pair (~64 s of the ~75 s here; 60 kb took 235 s)
GENOME_LEN, DEPTH, SEED = 10_000, 40.0, 1
CHIMERA_FRAC, MIN_APART, DRAFT_LEN = 0.6, 2_500, 800
OUTPUTS = ("extended.fa", "remaining.fa", "corrected_extended.fa",
           "corrected_remaining.fa")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- (a) the generator --------------------------------------------------

@pytest.mark.parametrize("rc", [False, True], ids=["forward", "revcomp"])
def test_workload_chimeras(rc):
    """Deterministic for a seed; round(chimera_frac * cut / 2) chimeras,
    each draft i + junk + draft j (reverse-complemented in odd chimeras)
    with homes >= min_apart apart and junk within `junk`; every other
    draft is the target at its home; each cut draft is in one draft."""
    kw = dict(chimera_frac=0.2, junk=(300, 600), min_apart=50_000)
    wl = workload.make_misassembly_workload(300_000, 2.0, 5, **kw)
    again = workload.make_misassembly_workload(300_000, 2.0, 5, **kw)
    for key, v in wl.items():
        if key == "contigs":
            assert all(np.array_equal(a, b) for a, b in zip(v, again[key]))
        else:
            np.testing.assert_array_equal(v, again[key])
    assert len(wl["lens"]) == int(2.0 * 300_000 / 200)
    assert wl["data"].shape == (2 * len(wl["lens"]), 100)
    n = len(wl["chimera_index"])
    assert n == round(kw["chimera_frac"] * wl["n_cut"] / 2) >= 2
    assert len(wl["contigs"]) == wl["n_cut"] - n == len(wl["homes"])
    target = wl["target"]
    hi, hj = wl["chimera_homes"].T
    assert np.all(np.abs(hi - hj) >= kw["min_apart"])
    assert np.all((wl["chimera_junk"] >= 300) & (wl["chimera_junk"] <= 600))
    for k in np.flatnonzero(wl["chimera_rc"] == rc):
        seq = wl["contigs"][wl["chimera_index"][k]]
        li, lj = wl["chimera_lens"][k]
        assert len(seq) == li + wl["chimera_junk"][k] + lj
        assert np.array_equal(seq[:li], target[hi[k]:hi[k] + li])
        tail = target[hj[k]:hj[k] + lj]
        if rc:
            tail = workload.COMP[tail][::-1]
        assert np.array_equal(seq[len(seq) - lj:], tail)
        assert wl["homes"][wl["chimera_index"][k]] == hi[k]
    plain = np.setdiff1d(np.arange(len(wl["contigs"])), wl["chimera_index"])
    for c in plain:
        h, seq = wl["homes"][c], wl["contigs"][c]
        assert np.array_equal(seq, target[h:h + len(seq)])
    covered = np.concatenate([wl["homes"][plain], hi, hj])
    assert len(np.unique(covered)) == wl["n_cut"]


def test_chimera_outcomes():
    """Each chimera's outcome from remove_misassembly's ids: split before
    kept whole before one piece; an id is a word of a contig's id; the
    counts by strand."""
    masb = {"extended": {"split_ids": [], "whole_safe_ids": ["c7 c3"]},
            "remaining": {"split_ids": ["c1"], "whole_safe_ids": ["c5"]}}
    ids = {"extended": ["c7 c3", "c8 c9"],
           "remaining": ["c1", "c2", "c5", "c6"]}
    chimeras = ["c1", "c2", "c3", "c9", "c5", "c4"]
    outs = workload.chimera_outcomes(chimeras, masb, ids)
    assert outs == ["split", "kept", "whole", "kept", "whole", "absent"]
    by = workload.outcomes_by_strand(outs, [False, True, True, False,
                                            False, True])
    assert by == {"forward": {"split": 1, "whole": 1, "kept": 1,
                              "absent": 0},
                  "rc": {"split": 0, "whole": 1, "kept": 1, "absent": 1}}


# --- (c) the region sweep and split against the per-base loops ------------

def loops_pieces(state, coverage):
    """The per-base loops of remove_misassembly that _sweep and _runs
    replace (AlignGraph.cpp:4172-4210, 4228-4254), as the JAX package
    keeps them -> [(i, j)] of the pieces kept."""
    state = state.copy()
    unsafe = state != -1
    bp, n = 0, len(state)
    while bp < n:
        if not unsafe[bp]:
            bp += 1
            continue
        start = bp
        while bp < n and unsafe[bp]:
            bp += 1
        end = bp - 1
        region = state[start:end + 1]
        if region.mean() < coverage:
            state[start:end + 1] = -2
        else:
            state[start:end + 1] = -1
    safe = state == -1
    pieces, i = [], 0
    while i < n:
        if not safe[i]:
            i += 1
            continue
        j = i
        while j < n and safe[j]:
            j += 1
        if j - i > 200:
            pieces.append((i, j))
        i = j
    return pieces


def random_state(rng):
    """A contig's state as remove_misassembly builds it: raw read coverage
    around `coverage`, with placed spans set to -1 (none, some, or the
    whole contig), runs of zero coverage, and contig lengths from a few
    bases to a few kb."""
    n = int(rng.choice([1, 150, 201, 202, 700, 3000, 9000]))
    lam = float(rng.choice([0.5, 5.0, 19.0, 20.0, 40.0]))
    state = rng.poisson(lam, n).astype(np.int64)
    for _ in range(int(rng.integers(0, 4))):
        a = int(rng.integers(0, n))
        state[a:a + int(rng.integers(1, 800))] = 0
    for _ in range(int(rng.integers(0, 5))):
        a = int(rng.integers(-50, n))
        state[max(0, a):a + int(rng.integers(1, 2500))] = -1
    if rng.random() < 0.1:
        state[:] = -1
    return state


@pytest.mark.parametrize("seed", range(8))
def test_sweep_split_equals_loops(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        state = random_state(rng)
        coverage = int(rng.choice([1, 20, 40]))
        safe = misassembly._sweep(state, coverage)
        starts, ends = misassembly._runs(safe)
        long = ends - starts > 200
        got = list(zip(starts[long].tolist(), ends[long].tolist()))
        assert got == loops_pieces(state, coverage)


def test_sweep_equal_mean_boundary():
    """A run whose mean is exactly `coverage` is kept, one just below is
    removed, as region.mean() < coverage decides."""
    state = np.full(1000, -1, np.int64)
    state[300:400] = np.r_[np.full(50, 19), np.full(50, 21)]   # mean 20
    state[600:700] = np.r_[np.full(50, 19), np.full(49, 21), 20]  # 19.99
    safe = misassembly._sweep(state, 20)
    assert safe[:600].all() and not safe[600:700].any() and safe[700:].all()
    starts, ends = misassembly._runs(safe)
    assert list(zip(starts, ends)) == [(0, 600), (700, 1000)]


# --- (b) and (d): the 10 kb pipeline with misassembly removal --------------

def _cfg(cls, d: Path, out: Path, **kw):
    return cls(read1=str(d / "r1.fa"), read2=str(d / "r2.fa"),
               contig=str(d / "contigs.fa"), genome=str(d / "genome.fa"),
               distance_low=300, distance_high=700, part=1,
               misassembly_removal=True,
               extended_contig=str(out / "extended.fa"),
               remaining_contig=str(out / "remaining.fa"),
               work_dir=str(out / "tmp"), **kw)


@pytest.fixture(scope="module")
def masb_runs(tmp_path_factory):
    """The workload at 10 kb and 40x as FASTA files, through the JAX
    pipeline and the port's (device k-mer build) on the CPU, both with
    misassembly removal -> (workload, JAX dir, port dir, port result)."""
    d = tmp_path_factory.mktemp("masb")
    wl = workload.make_misassembly_workload(
        GENOME_LEN, DEPTH, SEED, chimera_frac=CHIMERA_FRAC,
        min_apart=MIN_APART, draft_len=DRAFT_LEN)
    workload.write_misassembly_fasta(d, wl)
    workload.write_reads_fasta(d, wl["data"], wl["lens"])
    jdir, tdir = d / "jax", d / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jax_run_pipeline(_cfg(JaxConfig, d, jdir))
    res = run_pipeline(_cfg(Config, d, tdir, graph_build="device"),
                       device="cpu")
    return wl, jdir, tdir, res


def test_misassembly_pipeline_equals_jax(masb_runs):
    wl, jdir, tdir, _ = masb_runs
    assert len(wl["chimera_index"]) >= 3
    assert len(wl["lens"]) == 2_000
    for name in OUTPUTS:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    corrected = b"".join((jdir / n).read_bytes() for n in OUTPUTS[2:])
    assert b" : part" in corrected


def test_misassembly_stats(masb_runs):
    """stats["misassembly"] has both files, and its counts are the
    corrected files' headers; stage (5) has its seconds and memory."""
    _, _, tdir, res = masb_runs
    st = res.stats
    assert set(st["misassembly"]) == {"extended", "remaining"}
    assert st["stage_seconds"]["misassembly_removal"] > 0
    assert "misassembly_removal" in st["memory"]
    for which, f in st["misassembly"].items():
        ids, _ = read_fasta(tdir / f"corrected_{which}.fa")
        ids_in, seqs_in = read_fasta(tdir / f"{which}.fa")
        n_in = sum(len(s) > 200 for s in seqs_in)
        assert f["contigs_in"] == n_in
        assert len(ids) == f["pieces_out"] + len(ids_in) - n_in \
            if which == "remaining" else len(ids) == f["pieces_out"]
        split = sorted({i.rsplit(" : part", 1)[0] for i in ids
                        if " : part" in i})
        assert sorted(f["split_ids"]) == split
        assert f["contigs_split"] == len(split)
        assert f["whole_safe"] == len(f["whole_safe_ids"])
        assert not set(f["whole_safe_ids"]) & set(split)
        assert f["read_records"] > 0 and f["placements"] > 0
        for key in ("index_s", "reads_s", "coverage_s", "contig_index_s",
                    "contigs_s", "placement_loops_s", "sweep_split_s"):
            assert f[key] >= 0, key
        # the contig align's _finalize, by step, and its counts
        assert 0 <= sum(f["finalize_split"].values()) <= f["finalize_s"] \
            <= f["contigs_s"]
        assert 0 <= sum(f["contigs_layer_s"].values()) <= f["contigs_s"]
        assert f["finalize_counts"]["rows"] == f["placements"]
    assert sum(f["contigs_split"] for f in st["misassembly"].values()) >= 1



def test_chimera_outcomes_of_the_run(masb_runs):
    """Every generated chimera is in the run's output: split ones are in
    a split contig's id, and the relocations and inversions add up."""
    wl, _, tdir, res = masb_runs
    masb = res.stats["misassembly"]
    chimeras = [f"c{i}" for i in wl["chimera_index"]]
    outs = workload.chimera_outcomes(
        chimeras, masb, {w: read_fasta(tdir / f"{w}.fa")[0] for w in masb})
    assert "absent" not in outs and "split" in outs
    split_words = {w for f in masb.values() for cid in f["split_ids"]
                   for w in cid.split()}
    assert all((o == "split") == (c in split_words)
               for c, o in zip(chimeras, outs))
    by = workload.outcomes_by_strand(outs, wl["chimera_rc"])
    assert sum(by["rc"].values()) == int(wl["chimera_rc"].sum())
    assert sum(map(sum, (v.values() for v in by.values()))) == len(outs)


def test_eval_shared_index_and_stats(masb_runs):
    """evaluate on a genome_index built once gives the metrics it gives
    alone, and reports its aligner's seconds, _finalize's by step, and
    _finalize's counts."""
    _, _, tdir, _ = masb_runs
    target = tdir.parent / "target.fa"
    index = genome_index(target, device="cpu")
    for name in ("remaining.fa", "corrected_remaining.fa"):
        st = {}
        got = evaluate(target, tdir / name, device="cpu", index=index,
                       stats=st)
        assert got == evaluate(target, tdir / name, device="cpu"), name
        assert set(st) == {"index_s", "align_s", "finalize_s",
                           "finalize_split", "finalize_counts", "layer_s"}
        assert set(st["layer_s"]) == set(ca.LAYERS)
        assert 0 <= sum(st["layer_s"].values()) <= st["align_s"]
        assert 0 <= st["finalize_s"] <= st["align_s"]
        assert 0 <= sum(st["finalize_split"].values()) <= st["finalize_s"]
        assert st["finalize_counts"]["placements"] >= \
            st["finalize_counts"]["rows"] > 0
