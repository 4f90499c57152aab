"""The port's seeding (aligngraph_tpu_torch/ops/seeding.py), its window
gather and score floor against the JAX package, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligngraph_tpu.align import read_aligner as jra
from aligngraph_tpu.ops import seeding as jsd
from aligngraph_tpu_torch.align import read_aligner as tra
from aligngraph_tpu_torch.align.contig_aligner import ContigAligner
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.ops import seeding as tsd
from aligngraph_tpu_torch.pipeline import misassembly


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def genome_with_ns(seed, n, n_rate=0.0):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.int8)
    g[rng.random(n) < n_rate] = 4
    return g


def reads_from(genome, seed, R=64, L=100, n_rate=0.0):
    rng = np.random.default_rng(seed)
    qs = np.full((R, L), 4, np.int8)
    for i in range(R):
        s = rng.integers(0, len(genome) - L)
        ln = int(rng.integers(L // 2, L + 1)) if i % 5 == 0 else L
        qs[i, :ln] = genome[s:s + ln]
    qs[rng.random(qs.shape) < n_rate] = 4
    return qs


INDEX_CASES = {          # seed_len, genome length, N rate
    "direct_7": (7, 30_000, 0.0),
    "bucketed_15": (15, 50_000, 0.001),
    "bucketed_13": (13, 20_000, 0.0),
}


def assert_index_equal(got: tsd.SeedIndex, want: jsd.SeedIndex):
    for f in ("sorted_kmers", "sorted_posflip", "bucket_lo"):
        g = getattr(got, f).numpy()
        w = getattr(want, f + "_np")
        assert g.dtype == w.dtype == np.int32, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("search_steps", "suffix_bits", "seed_len", "genome_len"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_build_index_equals_jax(case):
    sl, n, n_rate = INDEX_CASES[case]
    genome = genome_with_ns(1, n, n_rate)
    got = tsd.build_index(genome, sl, device="cpu")
    want = jsd.build_index(genome, sl)
    assert_index_equal(got, want)
    assert (got.suffix_bits == 0) == (case == "direct_7")


def contig_axis(seed, seed_len):
    """Contigs end to end with SEP_N-base N separators after each, as
    stage (5) and refinement join them: lengths from below seed_len to a
    few thousand bases, one with an N run of its own."""
    rng = np.random.default_rng(seed)
    lens = [5, seed_len - 1, seed_len, 3_000, 64, 12_000, 700]
    pieces = []
    for ln in lens + list(rng.integers(100, 5_000, 20)):
        c = rng.integers(0, 4, ln).astype(np.int8)
        if ln == 12_000:
            c[4_000:4_100] = 4
        pieces += [c, np.full(misassembly.SEP_N, 4, np.int8)]
    return np.concatenate(pieces)


def genome_of_kmers(seed, seed_len, n_kmers):
    """An N-free genome with exactly n_kmers valid windows."""
    return genome_with_ns(seed, n_kmers + seed_len - 1)


EDGE_CASES = {   # case -> (seed_len, genome, direct-addressed)
    "axis_13": (13, lambda: contig_axis(7, 13), False),
    "axis_15": (15, lambda: contig_axis(8, 15), False),
    "shorter_than_seed": (13, lambda: genome_with_ns(9, 12), False),
    "empty": (15, lambda: np.zeros(0, np.int8), False),
    "all_n": (13, lambda: np.full(500, 4, np.int8), False),
    "seed13_2^20-1_kmers": (13, lambda: genome_of_kmers(10, 13, (1 << 20) - 1),
                            False),
    "seed13_2^20_kmers": (13, lambda: genome_of_kmers(10, 13, 1 << 20), True),
    "seed15_past_2^20_kmers": (15, lambda: genome_with_ns(11, 1_200_000,
                                                          0.0005), False),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_build_index_edge_cases_equal_jax(case):
    """N-separated contig axes, genomes with no valid window, both sides
    of the switch to the direct table, and a bucketed table past 2^20
    k-mers (search_steps > 0): every field equal to the JAX build's."""
    sl, make, direct = EDGE_CASES[case]
    genome = make()
    got = tsd.build_index(genome, sl, device="cpu")
    assert_index_equal(got, jsd.build_index(genome, sl))
    assert (got.suffix_bits == 0) == direct
    n_kmers = got.sorted_kmers.shape[0]
    if case.startswith(("shorter", "empty", "all_n")):
        assert n_kmers == 0 and got.bucket_lo.numel() > 1
    else:
        assert n_kmers > 1000
    if case == "seed15_past_2^20_kmers":
        assert n_kmers > 1 << 20 and got.search_steps > 0


@pytest.mark.parametrize("seed_len", [1, 7, 13, 15])
def test_pack_kmers_equals_jax(seed_len):
    """The device pack (int32, one shift-or pass a base) == the JAX
    package's int64 numpy pack, invalid windows' bits included."""
    g = genome_with_ns(12, 3_000, 0.01)
    packed, valid = tsd.pack_kmers(torch.from_numpy(g), seed_len)
    want_p, want_v = jsd.pack_kmers_np(g, seed_len)
    np.testing.assert_array_equal(valid.numpy(), want_v)
    np.testing.assert_array_equal(packed.numpy(), want_p)


def test_build_index_on_cpu_feeds_both_aligners():
    """device="cpu" gives CPU tensors (from a numpy array or an int8
    tensor alike), nbytes counts them, and both aligners take the index
    as it is."""
    cfg = Config()
    g = genome_with_ns(13, 30_000, 0.001)
    idx = tsd.build_index(g, cfg.seed_len, device="cpu")
    same = tsd.build_index(torch.from_numpy(g), cfg.seed_len, device="cpu")
    tensors = (idx.sorted_kmers, idx.sorted_posflip, idx.bucket_lo)
    assert all(t.device.type == "cpu" for t in tensors)
    assert_index_equal(same, jsd.build_index(g, cfg.seed_len))
    assert idx.nbytes == sum(t.numel() * 4 for t in tensors)
    ra = tra.ReadAligner.from_index(g, idx, cfg, device="cpu")
    assert ra.index.sorted_kmers is idx.sorted_kmers
    assert ra.index.bucket_lo is idx.bucket_lo
    assert ContigAligner(g, cfg, index=idx, device="cpu").index is idx
    built = ContigAligner(g, cfg, device="cpu").index
    assert built.sorted_kmers.device.type == "cpu"
    assert_index_equal(built, jsd.build_index(g, cfg.seed_len))


def test_seed_index_from_numpy_carries_jax_index():
    genome = genome_with_ns(2, 20_000, 0.001)
    want = jsd.build_index(genome, 13)
    got = tsd.SeedIndex.from_numpy(want, "cpu")
    assert_index_equal(got, want)
    assert got.sorted_kmers.device.type == "cpu"


def test_build_index_rejects_bad_seed_len():
    g = genome_with_ns(0, 1000)
    for sl in (14, 17):
        with pytest.raises(ValueError):
            tsd.build_index(g, sl, device="cpu")


@pytest.mark.parametrize("seed_len,stride", [(13, 12), (15, 8), (7, 5)])
def test_pack_query_seeds_equals_jax(seed_len, stride):
    genome = genome_with_ns(3, 5_000)
    qs = reads_from(genome, 4, R=32, L=90, n_rate=0.01)
    got = tsd.pack_query_seeds(torch.from_numpy(qs), seed_len, stride)
    want = jsd.pack_query_seeds(jnp.asarray(qs), seed_len, stride)
    for g, w, name in zip(got, want, ("packed", "offsets", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    rc_t = tsd.rc_packed(got[0], seed_len)
    rc_j = jsd.rc_packed(want[0], seed_len)
    np.testing.assert_array_equal(rc_t.numpy(), np.asarray(rc_j))


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_lookup_seeds_bucketed_equals_jax(case):
    """Both lookup paths (direct-addressed and binary search), as in
    tests/test_read_aligner.py:233-290; every output slot compared."""
    sl, n, n_rate = INDEX_CASES[case]
    genome = genome_with_ns(1, n, n_rate)
    qs = reads_from(genome, 6, n_rate=0.002)
    # a repetitive seed: more than max_hits copies of one read's start
    genome_rep = genome.copy()
    for k in range(12):
        genome_rep[1000 + 200 * k:1000 + 200 * k + 100] = qs[0]
    for g in (genome, genome_rep):
        jidx = jsd.build_index(g, sl)
        tidx = tsd.build_index(g, sl, device="cpu")
        pk, offs, valid = jsd.pack_query_seeds(jnp.asarray(qs), sl, 8)
        pcan = jnp.minimum(pk, jsd.rc_packed(pk, sl))
        want = jsd.lookup_seeds_bucketed(
            jidx.sorted_kmers, jidx.sorted_posflip, jidx.bucket_lo, pcan,
            valid, 8, jidx.search_steps, jidx.suffix_bits)
        got = tsd.lookup_seeds_bucketed(
            tidx.sorted_kmers, tidx.sorted_posflip, tidx.bucket_lo,
            torch.from_numpy(np.array(pcan)),
            torch.from_numpy(np.array(valid)), 8, tidx.search_steps,
            tidx.suffix_bits)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1].sum() > 100


def candidate_inputs(seed, R=48, S=8, H=8):
    """Hit tables with many ties: positions drawn from a few clustered
    values (equal votes, equal diagonals), random flips, sparse ok, a few
    empty rows and diagonals below 0."""
    rng = np.random.default_rng(seed)
    base = np.array([3, 5, 40, 41, 57, 300, 318, 1000], np.int64)
    pos = rng.choice(base, (R, S, H))
    flip = rng.random((R, S, H)) < 0.5
    posflip = np.where(flip, pos | -2**31, pos).astype(np.int32)
    ok = rng.random((R, S, H)) < 0.4
    ok[::7] = False
    qflip = rng.random((R, S)) < 0.5
    offs = np.arange(0, S * 12, 12, dtype=np.int32)
    qlens = rng.integers(60, 101, R).astype(np.int32)
    return posflip, ok, qflip, offs, qlens


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("band_pad,C", [(16, 4), (8, 6)])
def test_select_candidates_ties_equal_jax(seed, band_pad, C):
    inputs = candidate_inputs(seed)
    want = jsd.select_candidates(*(jnp.asarray(a) for a in inputs), 13,
                                 band_pad, C)
    got = tsd.select_candidates(*(torch.from_numpy(a) for a in inputs), 13,
                                band_pad, C)
    for g, w, name in zip(got, want, ("diag", "votes", "orient")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    votes = got[1].numpy()
    # ties in votes were present and broken by diagonal
    assert (votes[:, 0] == votes[:, 1])[votes[:, 1] > 0].any()


def test_sort_pairs_is_stable_lexicographic():
    rng = np.random.default_rng(0)
    hi = rng.integers(-3, 3, (5, 40)).astype(np.int32)
    lo = rng.choice(np.array([-2**31, -7, 0, 7, 2**31 - 1]), (5, 40)).astype(
        np.int32)
    got = tsd.sort_pairs(torch.from_numpy(hi), torch.from_numpy(lo),
                         dim=1).numpy()
    for r in range(5):
        want = np.lexsort((np.arange(40), lo[r], hi[r]))
        np.testing.assert_array_equal(got[r], want)


def test_window_gather_equals_jax():
    """Starts at and past both ends of the genome, as the aligner's
    candidate diagonals give them (down to -L - pad, up to G)."""
    L, pad = 100, 16
    WL = L + 2 * pad
    genome = genome_with_ns(8, 3_000, 0.01)
    G = len(genome)
    rng = np.random.default_rng(9)
    start = np.concatenate([
        np.array([-L - pad, -WL - 1, -WL, -WL + 1, -33, -1, 0, 1, 7, 31, 32,
                  G - WL, G - WL + 1, G - 5, G - 1, G, G + 3, -9000,
                  G + 9000], np.int64),
        rng.integers(-L - pad, G, 45)]).astype(np.int32)
    want = jra._window_slices(jnp.asarray(jra.pack_genome_words_np(genome)),
                              jnp.asarray(start), WL, WL, G=G)
    gp = np.full(G + 2 * tra.GENOME_PAD, 4, np.int8)
    gp[tra.GENOME_PAD:tra.GENOME_PAD + G] = genome
    got = tra.window_slices(torch.from_numpy(gp), torch.from_numpy(start),
                            WL)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_score_min_table_equals_jax_formula():
    n = 40_000
    lens = jnp.arange(n, dtype=jnp.int32)
    want = jnp.ceil(
        jra.SCORE_MIN_CONST
        + jra.SCORE_MIN_COEFF * jnp.log(jnp.maximum(lens, 2).astype(
            jnp.float32))).astype(jnp.int32)
    np.testing.assert_array_equal(tra.score_min_table(n - 1),
                                  np.asarray(want))
