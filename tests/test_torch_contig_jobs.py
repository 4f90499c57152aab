"""The contig aligner's tile jobs (ContigAligner.tile_jobs: the hits
clustered on the device, chained on the host, the tiles' diagonals and
the jobs on the device) on the CPU against the JAX ContigAligner's host
steps: per segment _seed_hits, _cluster_and_chain, _tile_diags and the
job loop of align, then _run_tile_jobs' batch fill.  Every job's
placement, tile start, length, g0 and destination, and every DP batch's
tiles, lengths, windows, g0 and destinations equal (tolerance 0, all
integer); the placements' chunk, orientation and length too."""

import numpy as np
import pytest
import torch

from aligngraph_tpu.align import contig_aligner as jca
from aligngraph_tpu.config import Config as JConfig
from aligngraph_tpu_torch.align import contig_aligner as ca
from aligngraph_tpu_torch.config import Config
from tests.test_contig_aligner import contigs_from_arrays
from tests.test_torch_contig_aligner import (CASES,
                                             assert_contig_alignments_equal)

TILE, PAD = ca.TILE, ca.TILE_PAD


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(seed, n):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)


def jax_jobs(jal, contigs):
    """The JAX ContigAligner.align's job loop -> (jobs, placements):
    jobs (pid, ts, tile, tlen, g0) and placements (chunk, fr, length)."""
    jobs, meta = [], []
    for c in range(contigs.n_chunks):
        fwd = np.asarray(contigs.chunk_seq(c), np.int8)
        n_tiles = (len(fwd) + TILE - 1) // TILE
        for fr, seq in ((0, fwd), (1, jca._revcomp_np(fwd))):
            qpos, tpos = jal._seed_hits(seq)
            chains = jca._cluster_and_chain(qpos, tpos, len(seq),
                                            jal.min_votes, jal.max_join_gap)
            for ch in chains:
                td, has = jca._tile_diags(ch["clusters"], n_tiles)
                pid = len(meta)
                meta.append((c, fr, len(seq)))
                for t in range(n_tiles):
                    if not has[t]:
                        continue
                    ts = t * TILE
                    tile = np.full(TILE, 4, np.int8)
                    piece = seq[ts:ts + TILE]
                    tile[:len(piece)] = piece
                    jobs.append((pid, ts, tile, len(piece),
                                 int(td[t]) + ts))
    return jobs, meta


def jax_batch(jobs, meta, genome, s, bs):
    """The JAX _run_tile_jobs' fill of the batch at job s, and each job's
    destination in the placements' buffer."""
    G = len(genome)
    off = np.cumsum([0] + [n for _, _, n in meta])
    tiles = np.full((bs, TILE), 4, np.int8)
    tlens = np.zeros(bs, np.int32)
    g0s = np.zeros(bs, np.int32)
    dst = np.zeros(bs, np.int64)
    for k, (pid, ts, tile, plen, g0) in enumerate(jobs[s:s + bs]):
        tiles[k] = tile
        tlens[k] = plen
        g0s[k] = np.clip(g0, -(2**30), 2**30)
        dst[k] = off[pid] + ts
    x = g0s[:, None] - PAD + np.arange(TILE + 2 * PAD)[None, :]
    ok = (x >= 0) & (x < G)
    windows = np.where(ok, genome[np.clip(x, 0, G - 1)], np.int8(4))
    return tiles, tlens, windows, g0s, dst


def aligners(genome, cfg_kw, min_votes=None):
    jal = jca.ContigAligner(genome, JConfig(**cfg_kw))
    al = ca.ContigAligner(genome, Config(**cfg_kw), device="cpu")
    if min_votes is not None:
        jal.min_votes = al.min_votes = min_votes
    return jal, al


def assert_jobs_equal(genome, seqs, cfg_kw, min_votes=None, least=1):
    """The port's tile jobs and batches == the JAX host steps'; returns
    the two aligners and the contigs."""
    contigs = contigs_from_arrays(seqs)
    jal, al = aligners(genome, cfg_kw, min_votes)
    want, meta = jax_jobs(jal, contigs)
    got = al.tile_jobs(contigs)
    assert got.n == len(want) >= least
    np.testing.assert_array_equal(got.chunk_id, [m[0] for m in meta])
    np.testing.assert_array_equal(got.fr, [m[1] for m in meta])
    np.testing.assert_array_equal(got.length, [m[2] for m in meta])
    assert (got.chunk_id.dtype, got.fr.dtype) == (np.int32, np.int8)
    off = np.cumsum([0] + [n for _, _, n in meta])
    fields = dict(pid=[j[0] for j in want], ts=[j[1] for j in want],
                  tlen=[j[3] for j in want],
                  g0=[np.clip(j[4], -(2**30), 2**30) for j in want],
                  dst=[off[j[0]] + j[1] for j in want])
    for name, w in fields.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                      err_msg=name)
    for bs in (al.dp_batch, 7):
        for s in range(0, got.n, bs):
            for name, g, w in zip(("tiles", "tlens", "windows", "g0s", "dst"),
                                  got.batch(s, bs),
                                  jax_batch(want, meta, genome, s, bs)):
                assert g.dtype == torch.from_numpy(w).dtype, name
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"{name} at {s}/{bs}")
    return jal, al, contigs


@pytest.mark.parametrize("fast_map", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_jobs_equal_jax(case, fast_map):
    genome, seqs = CASES[case][0]()
    assert_jobs_equal(genome, seqs, dict(fast_map=fast_map), least=0)


def _gap(gap):
    """A deletion of `gap` genome bases in the contig: its hits' diagonal
    steps by exactly `gap`."""
    g = _rand(11, 20_000)
    return g, [np.concatenate([g[2000:6000], g[6000 + gap:10_000 + gap]])]


def _hitless():
    """1,500 inserted bases: two hitless tiles inside the chain's span,
    carried forward."""
    g = _rand(12, 20_000)
    return g, [np.concatenate([g[1000:4000], _rand(13, 1500),
                               g[4000:7000]])]


def _not_multiple():
    g = _rand(14, 20_000)
    return g, [g[5000:8333].copy(), g[9000:9700].copy()]


def _genome_ends():
    """Contigs that run past both ends of the genome: windows past both."""
    g = _rand(15, 12_000)
    return g, [np.concatenate([_rand(16, 300), g[:3000]]),
               np.concatenate([g[-3000:], _rand(17, 300)]),
               g[:1500].copy(), g[-1500:].copy()]


def _no_hits():
    g = _rand(18, 20_000)
    return g, [_rand(19, 2500), g[3000:6000].copy(), _rand(20, 700)]


def _repeats():
    """One 1,500-base piece at six places 25 kb apart, two of them with
    mutations: six chains in one segment, cut to MAX_PLACEMENTS, ties in
    votes broken by the first cluster's diagonal."""
    g = _rand(21, 160_000)
    piece = _rand(22, 1500)
    for k in range(6):
        p = piece.copy()
        if k in (1, 4):
            p[100 * k:100 * k + 40:7] ^= 1
        g[5000 + 25_000 * k:6500 + 25_000 * k] = p
    return g, [piece.copy(), g[30_000:33_000].copy()]


# (inputs, Config keywords, min_votes or None, least jobs)
SPECIAL = {
    "gap_equal_cluster_gap": (lambda: _gap(ca.CLUSTER_GAP), {}, None, 10),
    "gap_over_cluster_gap": (lambda: _gap(ca.CLUSTER_GAP + 1), {}, None,
                             10),
    "hitless_tiles": (_hitless, {}, None, 14),
    "length_not_multiple": (_not_multiple, {}, None, 8),
    "windows_past_genome_ends": (_genome_ends, {}, None, 10),
    "segment_without_hits": (_no_hits, {}, None, 6),
    "min_votes_1_random_hits": (
        lambda: (_rand(23, 30_000), [_rand(24, 4000), _rand(25, 3000)]),
        dict(seed_len=9), 1, 14),
    "more_chains_than_placements": (_repeats, {}, None, 18),
}


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_tile_jobs_equal_jax_special(case):
    make, cfg_kw, min_votes, least = SPECIAL[case]
    genome, seqs = make()
    assert_jobs_equal(genome, seqs, cfg_kw, min_votes, least)


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_align_equals_jax_special(case):
    """ContigAligner.align on the same inputs equals the JAX align, field
    by field and map by map."""
    make, cfg_kw, min_votes, _ = SPECIAL[case]
    genome, seqs = make()
    contigs = contigs_from_arrays(seqs)
    jal, al = aligners(genome, cfg_kw, min_votes)
    assert_contig_alignments_equal(al.align(contigs), jal.align(contigs))


@pytest.mark.parametrize("gap,runs", [(ca.CLUSTER_GAP, 1),
                                      (ca.CLUSTER_GAP + 1, 2)])
def test_cluster_gap_boundary(gap, runs):
    """A diagonal step of exactly CLUSTER_GAP stays in one cluster, one
    more starts a second; both are chained into one placement."""
    genome, seqs = _gap(gap)
    _, al = aligners(genome, {})
    off, q, t = al.seed_hits(seqs[:1])
    out = ca._cluster_and_chain(q, t, len(seqs[0]), al.min_votes)
    assert [len(p["clusters"]) for p in out] == [runs]


def _hits(rng, n_segs):
    """Random hits of n_segs segments (some empty), with collinear runs
    and diagonal jumps, segment-major -> (offsets, qpos, tpos)."""
    qs, ts = [], []
    for _ in range(n_segs):
        n = int(rng.choice([0, 1, 5, int(rng.integers(1, 300))]))
        G = int(rng.choice([5_000, 50_000, 2_000_000]))
        q, t = rng.integers(0, 20_000, n), rng.integers(0, G, n)
        for _ in range(int(rng.integers(0, 5))):
            run = np.arange(int(rng.integers(0, 10_000)), 20_000,
                            16)[:int(rng.integers(2, 200))]
            q = np.concatenate([q, run])
            t = np.concatenate([t, run + int(rng.integers(0, G))])
        qs.append(q.astype(np.int64))
        ts.append(t.astype(np.int64))
    off = np.cumsum([0] + [len(q) for q in qs])
    return off, qs, ts


@pytest.mark.parametrize("seed", range(3))
def test_cluster_and_chain_every_segment_equals_jax(seed):
    """cluster_hits and chain_clusters over many segments at once give,
    segment by segment, the JAX _cluster_and_chain's placements in its
    order: each cluster's diag, qmin, qmax and votes, each placement's
    votes, query span and segment."""
    rng = np.random.default_rng(seed)
    for min_votes, gap in ((1, 300), (2, 20_000), (4, 20_000)):
        off, qs, ts = _hits(rng, 40)
        cl = ca.cluster_hits(torch.from_numpy(np.concatenate(qs)),
                             torch.from_numpy(np.concatenate(ts)),
                             torch.from_numpy(off), min_votes)
        ch = ca.chain_clusters(cl, gap)
        got = {}
        for p in range(len(ch.seg)):
            ks = ch.members[ch.moff[p]:ch.moff[p + 1]]
            got.setdefault(int(ch.seg[p]), []).append((
                [(int(cl.diag[k]), int(cl.qmin[k]), int(cl.qmax[k]),
                  int(cl.votes[k])) for k in ks],
                int(ch.votes[p]), int(ch.qlo[p]), int(ch.qhi[p])))
        for s, (q, t) in enumerate(zip(qs, ts)):
            want = [([(c["diag"], c["qmin"], c["qmax"], c["votes"])
                      for c in p["clusters"]], p["votes"],
                     min(c["qmin"] for c in p["clusters"]),
                     max(c["qmax"] for c in p["clusters"]))
                    for p in jca._cluster_and_chain(q, t, 20_000, min_votes,
                                                    gap)]
            assert got.get(s, []) == want, s
