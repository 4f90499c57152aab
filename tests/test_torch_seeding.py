"""The port's seeding (aligngraph_tpu_torch/ops/seeding.py), its window
gather and score floor against the JAX package, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligngraph_tpu.align import read_aligner as jra
from aligngraph_tpu.ops import seeding as jsd
from aligngraph_tpu_torch.align import read_aligner as tra
from aligngraph_tpu_torch.ops import seeding as tsd


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
    got = tsd.build_index(genome, sl)
    want = jsd.build_index(genome, sl)
    assert_index_equal(got, want)
    assert (got.suffix_bits == 0) == (case == "direct_7")


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
            tsd.build_index(g, sl)


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
        tidx = tsd.build_index(g, sl)
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
