"""The big-genome run (aligngraph_tpu_torch/bigscale.py) against
scripts/bigscale_run.py and the JAX package, on the CPU at a small size:
its workload equals the script's (the reads drawn in blocks, without a
whole-matrix float64 mask), its --part 2 run with the device k-mer build
writes the JAX pipeline's bytes, its JSON lines carry the script's keys;
the contig aligner's linear clustering and chaining equal the JAX
module's; and the device-memory accounting (kmer_layer_jit.state_bytes)
that its pre-flight check uses."""

import ast
import json
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_pipeline
from aligngraph_tpu.align import contig_aligner as jax_ca
from aligngraph_tpu.config import Config as JConfig
from aligngraph_tpu.evaluate.evaluate import evaluate as jax_evaluate
from aligngraph_tpu.io.formalize import Reads as JReads
from aligngraph_tpu.io.formalize import formalize_contigs as j_contigs
from aligngraph_tpu.io.formalize import formalize_genome as j_genome
from aligngraph_tpu.ops.seeding import pack_kmers_np, rc_packed_np
from aligngraph_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from aligngraph_tpu_torch import bigscale, native, workload
from aligngraph_tpu_torch.align import contig_aligner as ca
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
from aligngraph_tpu_torch.graph.model import GraphTensors
from aligngraph_tpu_torch.io.formalize import formalize_genome
from aligngraph_tpu_torch.workload import make_bigscale_workload

REPO = Path(__file__).resolve().parent.parent
# 0.3 Mb cut in two parts; depth 5 (7,500 pairs) keeps the JAX read
# aligner's CPU batch at 8,192 pairs (depth 10 takes ~55 s there alone)
GENOME_MB, DEPTH, PART = 0.3, 5.0, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def script_workload(glen, depth, read_len=100):
    """scripts/bigscale_run.py:43-50 with bench_pipeline's functions."""
    n_pairs = int(depth * glen / (2 * read_len))
    rng = np.random.default_rng(11)
    target = rng.integers(0, 4, glen).astype(np.int8)
    ref = bench_pipeline.mutate_fast(rng, target)
    data, lens = bench_pipeline.simulate_pe_reads(rng, target, n_pairs,
                                                  read_len=read_len)
    return target, ref, data, lens, bench_pipeline.cut_contigs(rng, target)


def test_workload_equals_script():
    got = make_bigscale_workload(200_000, 5.0)
    want = script_workload(200_000, 5)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[4]) == len(want[4]) > 50
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("block_pairs", [999, 2_500, 1 << 18])
def test_reads_in_blocks_equal_script(block_pairs, monkeypatch):
    """simulate_pe_reads draws its reads and error mask in blocks of
    pairs; whole blocks, a ragged last block or one block give
    bench_pipeline's reads and leave the stream where it leaves it."""
    monkeypatch.setattr(workload, "READ_BLOCK_PAIRS", block_pairs)
    rng = np.random.default_rng(3)
    target = rng.integers(0, 4, 50_000).astype(np.int8)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    got = workload.simulate_pe_reads(a, target, 5_000)
    want = bench_pipeline.simulate_pe_reads(b, target, 5_000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert a.random() == b.random()


def test_reads_without_whole_matrix_temporaries(monkeypatch):
    """The error mask is never a float64 array of the whole read matrix
    (8 bytes a base; 10 GB at 64 Mb and 20x): the peak of the traced
    allocations stays under twice the int8 reads themselves."""
    monkeypatch.setattr(workload, "READ_BLOCK_PAIRS", 2_048)
    rng = np.random.default_rng(3)
    target = rng.integers(0, 4, 100_000).astype(np.int8)
    n_pairs = 50_000
    tracemalloc.start()
    try:
        data, _ = workload.simulate_pe_reads(rng, target, n_pairs)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert data.nbytes == 2 * n_pairs * 100
    assert peak < 2 * data.nbytes


def _same_chains(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x["votes"] == y["votes"]
        assert len(x["clusters"]) == len(y["clusters"])
        for c, e in zip(x["clusters"], y["clusters"]):
            assert {k: c[k] for k in ("diag", "qmin", "qmax", "votes")} == \
                {k: e[k] for k in ("diag", "qmin", "qmax", "votes")}
            for k in ("q", "d"):
                assert c[k].dtype == e[k].dtype
                np.testing.assert_array_equal(c[k], e[k])


@pytest.mark.parametrize("seed", range(4))
def test_cluster_and_chain_equals_jax(seed):
    """The port's linear clustering and bucketed chaining give the JAX
    module's placements: random hits at three genome sizes, collinear
    runs with diagonal jumps, min_votes 1, 2, 4, join gaps 300 and
    20,000."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(1, 400))
        G = int(rng.choice([5_000, 50_000, 2_000_000]))
        q, t = rng.integers(0, 20_000, n), rng.integers(0, G, n)
        for _ in range(int(rng.integers(0, 4))):
            run = np.arange(int(rng.integers(0, 10_000)), 20_000,
                            16)[:int(rng.integers(2, 200))]
            q = np.concatenate([q, run])
            t = np.concatenate([t, run + int(rng.integers(0, G))])
        mv, mj = int(rng.choice([1, 2, 4])), int(rng.choice([300, 20_000]))
        _same_chains(ca._cluster_and_chain(q, t, 20_000, mv, mj),
                     jax_ca._cluster_and_chain(q, t, 20_000, mv, mj))


def test_cluster_and_chain_linear_in_hits():
    """A 1 Mb Eval chunk against a 64 Mb genome: a random 13-mer hit a
    seed, about one hit per 1,000 diagonals, tens of thousands of
    clusters.  The JAX module's loops take ~50 s here on one core (one
    pass over all hits per cluster, one scan of all later clusters per
    chain); the port's take well under a second."""
    rng = np.random.default_rng(0)
    n = 60_000
    q = np.sort(rng.integers(0, 1_000_000, n))
    t = rng.integers(0, 64_000_000, n)
    t0 = time.perf_counter()
    out = ca._cluster_and_chain(q, t, 1_000_000, 2)
    assert time.perf_counter() - t0 < 10.0
    assert 1 <= len(out) <= ca.MAX_PLACEMENTS


@pytest.mark.parametrize("m", [2, 7, 300, 3_000])
def test_monotone_chain_native_equals_numpy(m):
    """The C++ chain DP (native/chain.cpp) gives the numpy loop's best,
    parent and trim, ties included (narrow target ranges make equal
    gains), from int32 block ends as _enforce_monotone passes them."""
    assert native.get_chain_lib() is not None
    rng = np.random.default_rng(m)
    for spread in (3, 20 * m):
        t0 = (np.sort(rng.integers(0, spread, m))
              + rng.integers(-300, 300, m)).astype(np.int32)
        w = rng.integers(1, 60, m).astype(np.int64)
        t1 = (t0 + w).astype(np.int32)
        got = native.monotone_chain_native(t0, t1, w)
        for g, e in zip(got, ca._chain_dp(t0, t1, w)):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("seed", range(3))
def test_enforce_monotone_equals_jax(seed):
    """_enforce_monotone on pos_maps of junk-like placements (random
    blocks, overlaps, reversed runs) and of true ones with seam repeats
    leaves what the JAX module's leaves."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(2, 3_000))
        pm = np.full(n, -1, np.int32)
        q = 0
        while q < n:
            ln = int(rng.integers(1, 80))
            if rng.random() < 0.7:
                pm[q:q + ln] = int(rng.integers(0, 50_000)) + np.arange(
                    len(pm[q:q + ln]))
            q += ln + int(rng.integers(0, 5))
        if rng.random() < 0.3:                  # a true run with repeats
            pm[:] = np.arange(n) + 1_000
            pm[n // 2:] -= int(rng.integers(0, 20))
        got, want = pm.copy(), pm.copy()
        ca._enforce_monotone(got)
        jax_ca._enforce_monotone(want)
        np.testing.assert_array_equal(got, want)


def test_seed_hits_gather_equals_slices():
    """The batched seeding (ContigAligner.seed_hits, all queries at once)
    gathers each seed's run of the index by a ragged expansion; per query
    the hits are those the per-seed slices (the JAX module's form) take."""
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 20_000).astype(np.int8)
    g[5_000:5_400] = g[100:500]                 # repeats: runs of 2+
    al = ca.ContigAligner(g, Config(), device="cpu")
    snp = g[12_000:18_000].copy()
    snp[::20] = (snp[::20] + 1) % 4
    sk = al.index.sorted_kmers.numpy()
    spf = al.index.sorted_posflip.numpy()
    seqs = [g[3_000:9_000], snp]
    off, qpos_all, tpos_all = al.seed_hits(seqs)
    runs = []
    for i, seq in enumerate(seqs):
        qpos = qpos_all[off[i]:off[i + 1]]
        tpos = tpos_all[off[i]:off[i + 1]]
        packed, valid = pack_kmers_np(seq, al.index.seed_len)
        qp = np.arange(0, len(packed), al.stride)
        qp, packed = qp[valid[qp]], packed[qp][valid[qp]]
        rc = rc_packed_np(packed, al.index.seed_len)
        qflip = rc < packed
        pcan = np.where(qflip, rc, packed)
        lo = np.searchsorted(sk, pcan, side="left")
        cnt = np.searchsorted(sk, pcan, side="right") - lo
        keep = (cnt > 0) & (cnt <= 64)
        pf = np.concatenate([spf[a:a + c] for a, c in
                             zip(lo[keep], cnt[keep])])
        fwd = (pf < 0) == np.repeat(qflip[keep], cnt[keep])
        np.testing.assert_array_equal(
            qpos, np.repeat(qp[keep], cnt[keep])[fwd])
        np.testing.assert_array_equal(tpos, (pf & 0x7FFFFFFF)[fwd])
        assert len(qpos) > 0 and qpos.dtype == tpos.dtype == np.int64
        runs.append(cnt[keep].max())
    assert runs[0] > 1 and len(off) == 3


def script_keys():
    """The keys of scripts/bigscale_run.py's first JSON line (its
    `out = dict(...)`), read from the script."""
    tree = ast.parse((REPO / "scripts" / "bigscale_run.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "out":
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no `out = dict(...)` in bigscale_run.py")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's big-genome run at GENOME_MB, DEPTH, --part PART on the
    CPU (its two JSON lines, through JSON, and its work dir), and the JAX
    pipeline (host k-mer build) on the same files and reads."""
    d = tmp_path_factory.mktemp("bigscale")
    lines = bigscale.run(GENOME_MB, DEPTH, PART, device="cpu",
                         work_dir=str(d))[:2]
    _, _, data, lens, _ = make_bigscale_workload(int(GENOME_MB * 1e6),
                                                 DEPTH)
    jd = tmp_path_factory.mktemp("jax")
    cfg = JConfig(read1="-", read2="-", contig=str(d / "contigs.fa"),
                  genome=str(d / "genome.fa"), distance_low=300,
                  distance_high=700, part=PART, ratio_check=True,
                  extended_contig=str(jd / "extended.fa"),
                  remaining_contig=str(jd / "remaining.fa"),
                  work_dir=str(jd / "tmp"))
    jres = jax_run_pipeline(cfg, reads=JReads(len(lens), 100, data, lens),
                            contigs=j_contigs(cfg.contig),
                            genome=j_genome(cfg.genome, PART))
    return [json.loads(json.dumps(s)) for s in lines], d, jres, jd


def test_part2_run_equals_jax(runs):
    (line1, line2), d, jres, jd = runs
    assert line1["part"] == PART and jres.stats["n_parts"] == PART
    assert line1["extended"] == len(jres.extended_ids) >= 2
    for name in ("extended.fa", "remaining.fa"):
        assert (d / name).read_bytes() == (jd / name).read_bytes(), name
    for p in range(PART):
        name = f"_extended_contigs.{p}.fa"
        assert (d / "tmp" / name).read_bytes() == \
            (jd / "tmp" / name).read_bytes(), name
    assert line1["kmer_stats"] == jres.stats["kmer_build"]
    assert line1["aligned_pair_fraction"] == \
        jres.stats["aligned_pair_fraction"]
    m = jax_evaluate(str(d / "target.fa"), str(jd / "extended.fa"))
    assert {k: line2[k] for k in m} == m


def test_json_lines_carry_script_keys(runs):
    (line1, line2), _, _, jd = runs
    assert script_keys() <= set(line1)
    assert set(line1["stage_seconds"]) == {
        "alignment", "contig_layer", "kmer_build", "traverse", "refinement"}
    assert {"n_contigs", "n_true_contigs", "n50", "covered_length",
            "average_identity", "mpmb", "eval_s"} <= set(line2)
    # the memory of the run; the device figures are the card's only
    assert line1["max_rss_gb"] > 0 and line1["host_ram_bytes"] > 0
    assert set(line1["stage_memory"]) == {
        "alignment", "refinement", *(f"{s}.{p}" for s in (
            "contig_layer", "kmer_build", "traverse") for p in range(PART))}
    assert all(m["host_max_rss_bytes"] > 0
               for m in line1["stage_memory"].values())
    assert line1["device_peak_bytes"] is None and line1["card"] is None
    assert line1["kmer_state_bytes_measured"] == []
    assert len(line1["kmer_state_bytes"]) == PART


@pytest.mark.parametrize("part_len", [1, 2_000, 11_111])
def test_state_bytes_equals_allocated(part_len):
    """state_bytes(n_pos) is what _state_from_graph and _cmpack allocate."""
    g = GraphTensors.create(np.zeros(part_len, np.int8))
    n_pos = int(g.km_cnt.shape[0])
    assert n_pos == bigscale.part_positions(part_len)
    state = kj._state_from_graph(g, "cpu")
    got = sum(t.nbytes for t in state.values()) + \
        kj._cmpack(g, "cpu").nbytes
    assert kj.state_bytes(n_pos) == got
    assert kj.state_bytes(n_pos) == 552 * n_pos + 532


def test_state_check_raises_before_run(tmp_path, monkeypatch):
    """On a card too small for a part's state, check_state_fits raises;
    with room it returns every part's state bytes."""
    from aligngraph_tpu_torch.io.fasta import decode, write_fasta
    rng = np.random.default_rng(0)
    write_fasta(tmp_path / "g.fa", ["chr"],
                [decode(rng.integers(0, 4, 30_000).astype(np.int8))])
    genome = formalize_genome(tmp_path / "g.fa", 2)
    need = [kj.state_bytes(bigscale.part_positions(15_000))] * 2

    class Props:
        total_memory = need[0] + bigscale.KMER_RESERVE_BYTES - 1

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    with pytest.raises(MemoryError, match="larger --part"):
        bigscale.check_state_fits(genome.part_len, "cuda")
    Props.total_memory += 1
    assert bigscale.check_state_fits(genome.part_len, "cuda") == need
    assert bigscale.check_state_fits(genome.part_len, "cpu") == need
    # run() checks before it makes any data
    Props.total_memory -= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(MemoryError, match="larger --part"):
        bigscale.run(0.03, 1, 2, device="cuda", work_dir=tmp_path / "bs")
    assert not (tmp_path / "bs").exists()


def test_without_gpu_raises(tmp_path, monkeypatch):
    """The default device is CUDA; with none it raises before making any
    data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BIGSCALE_DIR", str(tmp_path / "bs"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        bigscale.main(["0.01", "1", "2"])
    assert not (tmp_path / "bs").exists()
