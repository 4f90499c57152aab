"""The port's multi-device paths (aligngraph_tpu_torch.parallel, the dry
run) on gloo CPU ranks at world sizes 2, 3 and 4, against the JAX
package's sharded functions on conftest's 8-device CPU mesh and against
the single-device port and the host oracle, on the inputs of
tests/test_parallel.py and tests/test_kmer_shard.py.  Every value is an
integer: tolerance 0.

Each world size is one launch of its ranks (parallel/mesh.run_ranks
through dryrun.run_jobs) that runs every case; the tests read its
results.  The ranks import only the port (run_jobs is a module-level
function of it), and their inputs are the port's own types."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aligngraph_tpu.graph.kmer_layer import build_kmer_layer
from aligngraph_tpu.parallel import coverage as jax_cov
from aligngraph_tpu.parallel import halo as jax_halo
from aligngraph_tpu.parallel import mesh as jax_mesh
from aligngraph_tpu.parallel.kmer_shard import (
    build_kmer_layer_sharded as jax_build_sharded)
from aligngraph_tpu_torch import dryrun
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.config import THRESHOLD, Config
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
from aligngraph_tpu_torch.graph.contig_layer import build_contig_layer
from aligngraph_tpu_torch.graph.model import GraphTensors
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.parallel.coverage import span_coverage
from aligngraph_tpu_torch.parallel.mesh import (make_mesh, run_ranks,
                                                shard_reads_pairwise)
from aligngraph_tpu_torch.pipeline.driver import _subset_pairs
from tests.simdata import make_simdata
from tests.test_contig_aligner import contigs_from_arrays
from tests.test_kmer_jit import KM_FIELDS

REPO = Path(__file__).resolve().parents[1]
WORLD = (2, 3, 4)
HALO_BLOCK, HALO = 4, 2
WINDOW = 7
ALIGN_FIELDS = ("pair_id", "fr", "score", "source_start", "source_end",
                "target_start", "target_end", "pos_map")
CHUNK = 97
SKEW_RANK = 1


def _jax_mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("dp",))


# ----------------------------------------------------------------------
# inputs, numpy from seeds, as in tests/test_parallel.py and
# tests/test_kmer_shard.py
# ----------------------------------------------------------------------

def halo_input(S):
    return np.arange(S * HALO_BLOCK, dtype=np.int32)


def window_input(S):
    return np.random.default_rng(0).integers(0, 100, S * 512) \
        .astype(np.int32)


def coverage_input(S):
    """tests/test_parallel.py:113's spans, with one straddling every cut
    of S blocks."""
    rng = np.random.default_rng(3)
    G = S * 1024
    starts = rng.integers(-50, G + 50, 4096).astype(np.int32)
    ends = (starts + rng.integers(0, 300, 4096)).astype(np.int32)
    for b in range(1, S):
        starts[b] = b * 1024 - 100
        ends[b] = b * 1024 + 100
    return starts, ends, G


@pytest.fixture(scope="module")
def align_case():
    """tests/test_parallel.py:36's sim: 64 pairs of 80 bp."""
    sim = make_simdata(seed=5, genome_len=10_000, n_pairs=64, read_len=80,
                       insert=400, snp_rate=0.01)
    n, L = 64, 80
    data = np.empty((2 * n, L), np.int8)
    data[0::2] = np.stack(sim.reads1[:n])
    data[1::2] = np.stack(sim.reads2[:n])
    reads = Reads(n, L, data, np.full(n, L, np.int32))
    cfg = Config(distance_low=100, distance_high=700)
    single = ReadAligner.build(sim.reference, cfg, batch_pairs=n,
                               device="cpu").align(reads)
    return np.asarray(sim.reference, np.int8), cfg, reads, single


@pytest.fixture(scope="module")
def kmer_case():
    """tests/test_kmer_shard.py:14's workload (seed 3, 16 kb, 900 pairs),
    aligned by the port's CPU aligners (held equal to JAX's by
    tests/test_torch_{read,contig}_aligner.py)."""
    sim = make_simdata(seed=3, genome_len=16_000, n_pairs=900,
                       read_len=100, insert=500, snp_rate=0.01)
    ref = np.asarray(sim.reference, np.int8)
    n = 900
    data = np.empty((2 * n, 100), np.int8)
    data[0::2] = np.stack(sim.reads1)
    data[1::2] = np.stack(sim.reads2)
    reads = Reads(n, 100, data, np.full(n, 100, np.int32))
    cfg = Config(distance_low=200, distance_high=800)
    rali = ReadAligner.build(ref, cfg, device="cpu").align(reads)
    rali = _subset_pairs(rali, rali.ratio_ok(THRESHOLD))
    contigs = contigs_from_arrays(sim.contigs)
    cali = ContigAligner(ref, cfg, device="cpu").align(contigs)

    def fresh():
        g = GraphTensors.create(ref)
        build_contig_layer(g, contigs, cali, part_offset=0)
        return g

    k, iv = cfg.k_mer, cfg.insert_variation
    oracle = fresh()
    oracle_st = build_kmer_layer(oracle, rali, reads, k, iv,
                                 chunk_records=1 << 30)
    g_jax = fresh()
    jax_st = jax_build_sharded(g_jax, rali, reads, k, iv,
                               Mesh(np.array(jax.devices()[:4]), ("pos",)))
    chunked = fresh()
    chunked_st = kj.build_kmer_layer_device(chunked, rali, reads, k, iv,
                                            chunk_records=CHUNK,
                                            device="cpu")
    return dict(fresh=fresh, rali=rali, reads=reads, k=k, iv=iv,
                oracle=oracle, oracle_st=oracle_st, g_jax=g_jax,
                jax_st=jax_st, chunked=chunked, chunked_st=chunked_st)


def skewed_records(case, S):
    """The records whose aligned positions all lie in rank SKEW_RANK's
    block of S: every row goes to one owner."""
    n_pos = case["oracle"].km_cnt.shape[0]
    n_local = -(-n_pos // S)
    pm = case["rali"].pos_map
    lo, hi = SKEW_RANK * n_local + 1, (SKEW_RANK + 1) * n_local - 1
    inside = ((pm < 0) | ((pm >= lo) & (pm < hi))).all(axis=(1, 2)) & \
        (pm >= 0).any(axis=(1, 2))
    return _subset_pairs(case["rali"], inside)


@pytest.fixture(scope="module")
def ranks(align_case, kmer_case):
    """World size -> the results of every case, from one launch of its
    gloo ranks each."""
    genome, cfg, reads, _ = align_case
    kc = kmer_case
    base = (kc["reads"], kc["k"], kc["iv"])
    out = {}
    for S in WORLD:
        jobs = [("halo", (halo_input(S), HALO)),
                ("window", (window_input(S), WINDOW)),
                ("coverage", coverage_input(S)),
                ("align", (genome, cfg, reads, reads.n_pairs)),
                ("kmer", (kc["fresh"](), kc["rali"]) + base),
                ("kmer", (kc["fresh"](), kc["rali"]) + base + (CHUNK,)),
                ("kmer", (kc["fresh"](), skewed_records(kc, S)) + base)]
        res = run_ranks(dryrun.run_jobs, S, "cpu", jobs)
        out[S] = dict(zip(["halo", "window", "coverage", "align", "kmer",
                           "kmer_chunked", "kmer_skewed"], res))
    return out


# ----------------------------------------------------------------------
# halo exchange and the window sum (tests/test_parallel.py:21,145)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", WORLD)
def test_halo_exchange_equals_jax(ranks, S):
    """Edge ranks get zero halos, interior ranks their neighbours' rows,
    as JAX's exchange_halos under shard_map."""
    x = halo_input(S)
    mesh = _jax_mesh(S)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda b: jax_halo.exchange_halos(b, "dp", HALO), mesh=mesh,
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(
            jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp")))))
    got = ranks[S]["halo"]
    np.testing.assert_array_equal(got.reshape(-1), want)
    np.testing.assert_array_equal(got[0], [0, 0, 0, 1, 2, 3, 4, 5])
    last = S * HALO_BLOCK
    np.testing.assert_array_equal(
        got[-1], [last - 6, last - 5, last - 4, last - 3, last - 2,
                  last - 1, 0, 0])


@pytest.mark.parametrize("S", WORLD)
def test_window_sum_equals_jax(ranks, S):
    x = window_input(S)
    mesh = _jax_mesh(S)
    want = np.asarray(jax_halo.sliding_window_sum_sharded(
        mesh, "dp", WINDOW)(jax.device_put(jnp.asarray(x),
                                           NamedSharding(mesh, P("dp")))))
    pad = np.concatenate([x, np.zeros(WINDOW - 1, np.int32)])
    oracle = np.array([pad[i:i + WINDOW].sum() for i in range(len(x))])
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(ranks[S]["window"], want)


# ----------------------------------------------------------------------
# coverage (tests/test_parallel.py:113)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", WORLD)
def test_coverage_equals_jax(ranks, S):
    starts, ends, G = coverage_input(S)
    mesh = _jax_mesh(S)
    s_p, e_p = jax_cov.pad_spans(starts, ends, S)
    sh = NamedSharding(mesh, P("dp"))
    want = np.asarray(jax_cov.make_sharded_coverage(mesh, G)(
        jax.device_put(jnp.asarray(s_p), sh),
        jax.device_put(jnp.asarray(e_p), sh)))
    np.testing.assert_array_equal(want, jax_cov.span_coverage_np(starts, ends,
                                                                 G))
    np.testing.assert_array_equal(ranks[S]["coverage"], want)
    np.testing.assert_array_equal(
        span_coverage(torch.from_numpy(starts), torch.from_numpy(ends),
                      G).numpy(), want)


# ----------------------------------------------------------------------
# the data-parallel aligner (tests/test_parallel.py:36)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded_records(align_case):
    """JAX's sharded production aligner on 4 shards, each shard's packed
    buffer decoded and merged with global pair ids."""
    from aligngraph_tpu.align.read_aligner import (
        _expand_packed, pack_reads_np, revcomp_padded_np, unpack_records)
    from aligngraph_tpu.ops.seeding import build_index

    genome, cfg, reads, _ = align_case
    S, L = 4, reads.max_len
    idx = build_index(genome, cfg.seed_len)
    u2, nmask = pack_reads_np(reads.data)
    u2r, nmr = pack_reads_np(revcomp_padded_np(
        reads.data, np.repeat(reads.lengths, 2)))
    u2, nmask, pl = jax_mesh.shard_reads_pairwise(u2, nmask, reads.lengths,
                                                  S)
    u2r, nmr, _ = jax_mesh.shard_reads_pairwise(u2r, nmr, reads.lengths, S)
    mesh = jax_mesh.make_mesh(S)
    step = jax_mesh.make_sharded_aligner(
        mesh, L=L, seed_len=cfg.seed_len, stride=cfg.seed_stride,
        pad=cfg.band_pad, C=cfg.max_candidates, dlow=cfg.distance_low,
        dhigh=cfg.distance_high, bsteps=idx.search_steps,
        sbits=idx.suffix_bits, c13=True)
    rep = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("dp", None))
    out = step(*[jax.device_put(a, rep) for a in (
        jnp.asarray(genome), idx.sorted_kmers, idx.sorted_posflip,
        idx.bucket_lo)],
        *[jax.device_put(jnp.asarray(a), rows) for a in (u2, nmask, u2r,
                                                          nmr)],
        jax.device_put(jnp.asarray(pl), NamedSharding(mesh, P("dp"))))
    out = jax.tree_util.tree_map(np.asarray, out)
    per = len(pl) // S
    bufs = out["buf"].reshape(S, -1)
    chunks = [_expand_packed(unpack_records(bufs[s], per), s * per, per, L,
                             pl[s * per:(s + 1) * per]) for s in range(S)]
    merged = {f: np.concatenate([c[f] for c in chunks]) for f in chunks[0]}
    return merged, int(out["n_valid_total"][0]), \
        [int(b[0]) for b in bufs]


@pytest.mark.parametrize("S", WORLD)
def test_sharded_aligner_equals_single_and_jax(ranks, align_case,
                                               jax_sharded_records, S):
    """Record for record equal to the port's single-rank align, and at
    S = 4 to JAX's decoded shard buffers with the same per-shard counts."""
    _, _, _, single = align_case
    res = ranks[S]["align"]
    assert res.total == sum(res.per_rank) == res.records.n == single.n > 50
    for f in dataclasses.fields(single):
        a, b = getattr(res.records, f.name), getattr(single, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    jax_recs, jax_total, jax_per_shard = jax_sharded_records
    assert jax_total == single.n
    for f in ALIGN_FIELDS:
        np.testing.assert_array_equal(getattr(res.records, f), jax_recs[f],
                                      err_msg=f)
    if S == 4:
        assert res.per_rank == jax_per_shard


def test_shard_reads_pairwise_pads_like_jax():
    """The same padded pair count and lengths as JAX's (which pads packed
    words); pad reads are N."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 4, (2 * 13, 20)).astype(np.int8)
    plens = rng.integers(10, 21, 13).astype(np.int32)
    got, got_l = shard_reads_pairwise(data, plens, 4)
    _, _, want_l = jax_mesh.shard_reads_pairwise(
        np.zeros((26, 3), np.uint32), np.zeros((26, 3), np.uint8), plens, 4)
    np.testing.assert_array_equal(got_l, want_l)
    assert got.shape == (32, 20) and (got[26:] == 4).all()
    np.testing.assert_array_equal(got[:26], data)


# ----------------------------------------------------------------------
# the position-sharded k-mer build (tests/test_kmer_shard.py)
# ----------------------------------------------------------------------

def assert_layers_equal(got, want):
    for f in KM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("S", WORLD)
def test_kmer_one_chunk_equals_jax_and_oracle(ranks, kmer_case, S):
    """chunk_records=None: all 13 arrays equal JAX's sharded build and the
    one-chunk host oracle, the stats equal JAX's; at S = 3 the position
    blocks are uneven."""
    g, st = ranks[S]["kmer"]
    assert_layers_equal(g, kmer_case["g_jax"])
    assert_layers_equal(g, kmer_case["oracle"])
    assert dataclasses.asdict(st) == dataclasses.asdict(kmer_case["jax_st"])
    assert dataclasses.asdict(st) == dataclasses.asdict(
        kmer_case["oracle_st"])
    assert st.tuples > 10_000
    n_pos = g.km_cnt.shape[0]
    if S == 3:
        assert n_pos % 3
    # k-mers sit next to every cut, so rows and edges cross them
    n_local = -(-n_pos // S)
    for c in range(1, S):
        assert g.km_cnt[c * n_local - 1:c * n_local + 1].sum() > 0


@pytest.mark.parametrize("S", WORLD)
def test_kmer_chunked_equals_device_build(ranks, kmer_case, S):
    """chunk_records=97: the arrays and stats of build_kmer_layer_device at
    the same chunking, and the oracle's arrays."""
    g, st = ranks[S]["kmer_chunked"]
    assert_layers_equal(g, kmer_case["chunked"])
    assert_layers_equal(g, kmer_case["oracle"])
    assert dataclasses.asdict(st) == dataclasses.asdict(
        kmer_case["chunked_st"])


@pytest.mark.parametrize("S", WORLD)
def test_kmer_skewed_load_equals_oracle(ranks, kmer_case, S):
    """Every record's positions in one rank's block: that rank owns every
    row; the build has no capacity to overflow and equals the oracle."""
    recs = skewed_records(kmer_case, S)
    assert recs.n > 20
    want = kmer_case["fresh"]()
    want_st = build_kmer_layer(want, recs, kmer_case["reads"],
                               kmer_case["k"], kmer_case["iv"],
                               chunk_records=1 << 30)
    g, st = ranks[S]["kmer_skewed"]
    assert_layers_equal(g, want)
    assert dataclasses.asdict(st) == dataclasses.asdict(want_st)
    n_local = -(-g.km_cnt.shape[0] // S)
    assert g.km_cnt[:SKEW_RANK * n_local].sum() == 0
    assert g.km_cnt[SKEW_RANK * n_local:].sum() > 0


# ----------------------------------------------------------------------
# the launcher and the dry run
# ----------------------------------------------------------------------

def test_dryrun_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "aligngraph_tpu_torch.dryrun", "--nproc",
         "2", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("dryrun(2 ranks on cpu, gloo)")
    assert "== oracle" in proc.stdout


def test_multi_gpu_script_on_cpu_ranks():
    """scripts/multi_gpu.py on 2 gloo ranks at a small size: every step
    runs, the sharded paths equal the single-device ones on rank 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "scripts/multi_gpu.py", "--device", "cpu",
         "--nproc", "2", "--genome-len", "30000", "--depth", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["world_size"] == 2 and rep["align_differs_in"] == []
    assert rep["records"]["sharded"] == rep["records"]["single"] > 1000
    assert rep["kmer_stats"]["tuples"] > 10_000
    assert set(rep["walls_s"]) == {"align", "kmer", "coverage", "window"}
    assert all(len(w) == 2 for w in rep["walls_s"].values())


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match=r"rank \d failed:[\s\S]*halo 5"):
        run_ranks(dryrun.run_jobs, 2, "cpu",
                  [("halo", (halo_input(2), HALO_BLOCK + 1))])


def test_make_mesh_needs_the_devices_backend(tmp_path):
    """A cuda mesh over a gloo group is refused (the backend follows the
    device)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/g",
                            rank=0, world_size=1)
    try:
        assert make_mesh("cpu").world_size == 1
        with pytest.raises(ValueError, match="nccl"):
            make_mesh("cuda")
    finally:
        dist.destroy_process_group()
