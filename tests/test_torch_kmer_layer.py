"""The port's device k-mer layer build (aligngraph_tpu_torch.graph.
kmer_layer_jit, device="cpu") against the host oracle
(aligngraph_tpu.graph.kmer_layer.build_kmer_layer) on the cases of
tests/test_kmer_jit.py, and against the JAX device build directly on the
smallest one: every GraphTensors field of the k-mer layer and every build
statistic equal, tolerance 0.  Alignments come from the port's CPU
aligners, which tests/test_torch_{read,contig}_aligner.py hold equal to
JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aligngraph_tpu.config import Config, THRESHOLD
from aligngraph_tpu.graph import kmer_layer_jit as jax_kj
from aligngraph_tpu.graph.contig_layer import build_contig_layer
from aligngraph_tpu.graph.kmer_layer import (KmerBuildStats,
                                             build_kmer_layer,
                                             normalize_records)
from aligngraph_tpu.graph.model import NONE32, GraphTensors
from aligngraph_tpu.io.formalize import Reads
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
from tests.simdata import make_simdata
from tests.test_contig_aligner import contigs_from_arrays
from tests.test_kmer_jit import KM_FIELDS

CFG = Config(distance_low=300, distance_high=700)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _subset(pa, mask):
    return dataclasses.replace(
        pa, **{f.name: getattr(pa, f.name)[mask]
               for f in dataclasses.fields(pa)})


def aligned_graph(seed, n_pairs=900, genome_len=20_000, contigs="aligned",
                  err_rate=0.003):
    """tests/test_kmer_jit.py's case: C13-accepted pair records from the
    port's CPU read aligner, and a maker of fresh graphs.  contigs:
    "aligned" builds the contig layer from the port's CPU contig aligner,
    "none" leaves it empty, "random" fills 0-3 seeded ContiMers per
    position (two contig ids, offsets scattered around the position) so
    that the 2x2 anchor combos, the slot cap and the edge cap all occur."""
    sim = make_simdata(seed=seed, genome_len=genome_len, n_pairs=n_pairs,
                       read_len=100, insert=500, n_contigs=8,
                       snp_rate=0.01, err_rate=err_rate)
    data = np.empty((2 * n_pairs, 100), np.int8)
    data[0::2] = np.stack(sim.reads1)
    data[1::2] = np.stack(sim.reads2)
    reads = Reads(n_pairs, 100, data, np.full(n_pairs, 100, np.int32))
    rali = ReadAligner.build(sim.reference, CFG, batch_pairs=1024,
                             device="cpu").align(reads)
    rali = _subset(rali, rali.ratio_ok(THRESHOLD))
    if contigs == "aligned":
        ctg = contigs_from_arrays(sim.contigs)
        cali = ContigAligner(sim.reference, CFG, device="cpu").align(ctg)

    def make_graph():
        g = GraphTensors.create(sim.reference)
        if contigs == "aligned":
            build_contig_layer(g, ctg, cali)
        elif contigs == "random":
            rng = np.random.default_rng(seed)
            P, S = g.cm_contig.shape
            cnt = np.minimum(rng.choice(4, P, p=[0.3, 0.3, 0.3, 0.1]), S)
            live = np.arange(S)[None, :] < cnt[:, None]
            ids = rng.integers(0, 2, (P, S))
            off = np.arange(P)[:, None] + rng.choice(
                [0, 30, -30, 130, -130, 500], (P, S))
            g.cm_cnt[:] = cnt
            g.cm_contig[:] = np.where(live, ids, NONE32)
            g.cm_coff[:] = np.where(live, off.clip(0), NONE32)
        return g

    return make_graph, rali, reads


def assert_graphs_equal(got: GraphTensors, want: GraphTensors):
    for f in KM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def run_both(make_graph, rali, reads, chunk):
    g_host = make_graph()
    st_host = build_kmer_layer(g_host, rali, reads, CFG.k_mer,
                               CFG.insert_variation, chunk_records=chunk)
    g_dev = make_graph()
    st_dev = kj.build_kmer_layer_device(
        g_dev, rali, reads, CFG.k_mer, CFG.insert_variation,
        chunk_records=chunk, device="cpu")
    assert_graphs_equal(g_dev, g_host)
    assert dataclasses.asdict(st_dev) == dataclasses.asdict(st_host)
    return g_dev, st_dev


@pytest.mark.parametrize("seed,chunk", [(21, 4096), (22, 257)])
def test_device_build_equals_oracle(seed, chunk):
    make_graph, rali, reads = aligned_graph(seed)
    _, st = run_both(make_graph, rali, reads, chunk)
    assert st.tuples > 10_000      # the workload is non-trivial


def test_device_build_no_contig_layer():
    """Read-only graph (no ContiMers): the no-anchor combo path and the
    coverage/vote accumulation."""
    make_graph, rali, reads = aligned_graph(
        23, n_pairs=400, genome_len=12_000, contigs="none")
    g, _ = run_both(make_graph, rali, reads, 16384)
    assert int(g.km_cov.sum()) > 0


def test_device_build_replay_case():
    """The case in which the JAX build overflows its group capacity at
    chunk 128 and replays chunks through the host oracle
    (tests/test_kmer_jit.py::test_device_build_overflow_fallback): the
    port has no capacity and runs every chunk itself."""
    make_graph, rali, reads = aligned_graph(
        24, n_pairs=300, genome_len=12_000, err_rate=0.02)
    _, st = run_both(make_graph, rali, reads, 128)
    assert st.tuples > 10_000


def test_device_build_random_anchors():
    """Up to 3 ContiMers per position: multi-combo rows, edges between
    combos of different ranks, dropped slots and dropped edges."""
    make_graph, rali, reads = aligned_graph(
        26, n_pairs=400, genome_len=12_000, contigs="random")
    _, st = run_both(make_graph, rali, reads, 1000)
    assert st.rows > 3 * st.tuples
    assert st.dropped_slots > 0 and st.dropped_edges > 0


@pytest.mark.parametrize("contigs", ["none", "random"])
def test_device_build_equals_jax(contigs):
    """The port against the JAX device build on seed 23 (400 pairs,
    12 kb), one chunk of 512 records."""
    make_graph, rali, reads = aligned_graph(
        23, n_pairs=400, genome_len=12_000, contigs=contigs)
    assert rali.n <= 512
    g_jax = make_graph()
    st_jax = jax_kj.build_kmer_layer_device(
        g_jax, rali, reads, CFG.k_mer, CFG.insert_variation,
        chunk_records=512)
    g_dev = make_graph()
    st_dev = kj.build_kmer_layer_device(
        g_dev, rali, reads, CFG.k_mer, CFG.insert_variation,
        chunk_records=512, device="cpu")
    assert_graphs_equal(g_dev, g_jax)
    assert dataclasses.asdict(st_dev) == dataclasses.asdict(st_jax)


def test_emit_tuples_equal_jax():
    """Phase 1: the port's compact tuples are the valid rows of JAX's
    dense `_emit_tuples_jit`, in order."""
    make_graph, rali, reads = aligned_graph(23, n_pairs=400,
                                            genome_len=12_000, contigs="none")
    k = CFG.k_mer
    p1, p2, s1, lens, keep = normalize_records(rali, reads, k, 0,
                                               make_graph().part_len)
    args = (p1.astype(np.int32), p2.astype(np.int32), s1,
            lens.astype(np.int32), keep)
    out, ovf = jax_kj._emit_tuples_jit(*[jnp.asarray(a) for a in args], k,
                                       8192)
    assert not bool(ovf)
    valid = np.asarray(out["valid"])
    got = kj._emit_tuples(*[torch.from_numpy(a) for a in args], k)
    assert set(got) == set(out) - {"valid"}
    assert got["cur"].numel() == int(valid.sum()) > 10_000
    for f, v in got.items():
        np.testing.assert_array_equal(
            v.numpy().astype(np.int64),
            np.asarray(out[f])[valid].astype(np.int64), err_msg=f)


def test_lex_order_equals_lexsort():
    """Stable multi-key order, keys packed by runtime range: -1 values,
    a constant key, keys wide enough to need several int64 words."""
    rng = np.random.default_rng(0)
    n = 5000
    keys = [rng.integers(-1, 3, n), np.full(n, 7),
            rng.integers(-1, 1 << 30, n), rng.integers(0, 4, n),
            rng.integers(-(1 << 20), 1 << 31, n), rng.integers(0, 2, n)]
    got = kj._lex_order([torch.from_numpy(k) for k in keys]).numpy()
    # np.lexsort takes the most-major key last and is stable
    np.testing.assert_array_equal(got, np.lexsort(keys[::-1]))
    assert kj._lex_order([torch.zeros(0, dtype=torch.int32)]).numel() == 0


def test_state_round_trip():
    """_state_from_graph / _state_to_graph keep every field and dtype;
    the state carries one sentinel row."""
    make_graph, _, _ = aligned_graph(21, n_pairs=8, genome_len=20_000,
                                     contigs="none")
    g = make_graph()
    g.km_contig[5, 1] = 7
    g.ed_pos[3, 0, 2] = 1 << 31
    g.km_slen[2, 3] = 5
    want = {f: getattr(g, f).copy() for f in KM_FIELDS}
    state = kj._state_from_graph(g, "cpu")
    assert all(state[f].shape[0] == g.km_cnt.shape[0] + 1
               and state[f].dtype == torch.int32 for f in KM_FIELDS)
    kj._state_to_graph(state, g)
    for f in KM_FIELDS:
        assert getattr(g, f).dtype == want[f].dtype, f
        np.testing.assert_array_equal(getattr(g, f), want[f], err_msg=f)


def test_empty_and_bad_k():
    make_graph, rali, reads = aligned_graph(21, n_pairs=8,
                                            genome_len=20_000,
                                            contigs="none")
    g = make_graph()
    st = KmerBuildStats(tuples=3)
    out = kj.build_kmer_layer_device(g, _subset(rali, np.zeros(rali.n,
                                                               bool)),
                                     reads, 5, 50, stats=st, device="cpu")
    assert out is st and st.tuples == 3
    with pytest.raises(ValueError, match="k-mer size 11"):
        kj.build_kmer_layer_device(g, rali, reads, 11, 50, device="cpu")


def test_marks_every_stage():
    """The build calls mark(stage) after phase 0's skip, the state's
    upload, each chunk's gather and upload, its phase 0 rows, each phase
    of a chunk, and the state's download."""
    make_graph, rali, reads = aligned_graph(21, n_pairs=8,
                                            genome_len=20_000,
                                            contigs="none")
    names = []
    chunk = -(-rali.n // 2)
    kj.build_kmer_layer_device(make_graph(), rali, reads, 5, 50,
                               chunk_records=chunk, device="cpu",
                               mark=names.append)
    per_chunk = ["gather", "phase0", "emit", "group", "rounds", "edges"]
    assert names == ["normalize", "h2d"] + 2 * per_chunk + ["d2h"]
