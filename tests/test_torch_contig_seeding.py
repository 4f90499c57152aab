"""The contig aligner's batched seeding (ops/seeding.contig_seed_hits,
through ContigAligner.seed_hits) on the CPU against the JAX
ContigAligner._seed_hits, query by query: for every chunk and orientation
the same qpos and tpos, in the same order, both int64 (tolerance 0)."""

import numpy as np
import pytest
import torch

from aligngraph_tpu.align.contig_aligner import ContigAligner as JaxAligner
from aligngraph_tpu.config import Config as JConfig
from aligngraph_tpu.ops.seeding import pack_kmers_np, rc_packed_np
from aligngraph_tpu_torch.align.contig_aligner import (ContigAligner,
                                                       query_segments)
from aligngraph_tpu_torch.config import Config
from aligngraph_tpu_torch.io.fasta import decode, write_fasta
from aligngraph_tpu_torch.io.formalize import formalize_contigs
from aligngraph_tpu_torch.ops import seeding
from tests.test_contig_aligner import contigs_from_arrays
from tests.test_torch_contig_aligner import assert_contig_alignments_equal


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _genome(seed, n):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)


def _mutated(rng, seq, rate=0.01):
    out = seq.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, hit.sum())) % 4
    return out


def _n_runs(tmp_path):
    """Contigs with runs of N (code 4) and single Ns; some reversed."""
    rng = np.random.default_rng(3)
    g = _genome(3, 60_000)
    g[20_000:20_300] = 4                      # an N run in the genome too
    seqs = []
    for k in range(8):
        s = int(rng.integers(0, 54_000))
        q = _mutated(rng, g[s:s + int(rng.integers(300, 6_000))])
        for _ in range(3):
            a = int(rng.integers(0, len(q)))
            q[a:a + int(rng.integers(1, 60))] = 4
        q[rng.random(len(q)) < 0.002] = 4
        seqs.append(q[::-1] ^ 3 if k % 3 == 0 else q)
    seqs = [np.where(q > 4, 4, q).astype(np.int8) for q in seqs]
    return g, contigs_from_arrays(seqs)


def _short_and_empty(tmp_path):
    """A contig shorter than seed_len, an empty one, one of exactly
    seed_len and a normal one between them."""
    g = _genome(4, 30_000)
    seqs = [g[100:110].copy(), np.zeros(0, np.int8), g[5_000:9_000].copy(),
            g[200:213].copy(), g[15_000:15_500].copy()]
    return g, contigs_from_arrays(seqs)


def _repeat_64_65(tmp_path):
    """Unit U planted at 64 places and unit V at 65: the seeds inside U
    have runs of 64 (kept), those inside V runs of 65 (dropped)."""
    rng = np.random.default_rng(5)
    g = _genome(5, 200_000)
    u, v = _genome(6, 60), _genome(7, 60)
    slots = rng.choice(np.arange(1, 199_000 // 100), 129, replace=False)
    for i, slot in enumerate(slots):
        unit = u if i < 64 else v
        if i % 2:
            unit = unit[::-1] ^ 3              # planted on either strand
        g[slot * 100:slot * 100 + 60] = unit
    flank = [_genome(8 + i, 100) for i in range(3)]
    q = np.concatenate([flank[0], u, flank[1], v, flank[2]])
    return g, contigs_from_arrays([q, g[50_000:53_000].copy()])


def _long_chunked(tmp_path):
    """A contig over 1 Mb, which formalize cuts into chunks, on a genome
    of more than 2^20 k-mers (a direct-addressed index)."""
    rng = np.random.default_rng(9)
    g = _genome(9, 1_150_000)
    long_q = _mutated(rng, g[20_000:1_120_000], 0.005)
    short_q = g[400_000:402_500][::-1] ^ 3
    path = tmp_path / "contigs.fa"
    write_fasta(path, ["long", "short"], [decode(long_q), decode(short_q)])
    contigs = formalize_contigs(path)
    assert contigs.n_chunks == 3
    return g, contigs


CASES = {"n_runs": _n_runs, "short_and_empty": _short_and_empty,
         "repeat_64_65": _repeat_64_65, "long_chunked": _long_chunked}


def assert_seeding_equals_jax(genome, contigs, fast_map=False):
    """ContigAligner.seed_hits over every chunk and orientation at once
    == the JAX aligner's _seed_hits on each; returns the port's aligner."""
    jal = JaxAligner(genome, JConfig(fast_map=fast_map))
    al = ContigAligner(genome, Config(fast_map=fast_map), device="cpu")
    segs = query_segments(contigs)
    assert len(segs) == 2 * contigs.n_chunks
    off, qpos, tpos = al.seed_hits(segs)
    assert off.dtype == np.int64 and len(off) == len(segs) + 1
    assert off[0] == 0 and off[-1] == len(qpos) == len(tpos)
    for i, seg in enumerate(segs):
        c, fr = divmod(i, 2)
        fwd = np.asarray(contigs.chunk_seq(c), np.int8)
        np.testing.assert_array_equal(
            seg, fwd if fr == 0 else np.array([3, 2, 1, 0, 4],
                                              np.int8)[fwd][::-1])
        want_q, want_t = jal._seed_hits(seg)
        got_q, got_t = qpos[off[i]:off[i + 1]], tpos[off[i]:off[i + 1]]
        assert got_q.dtype == want_q.dtype == np.int64
        assert got_t.dtype == want_t.dtype == np.int64
        np.testing.assert_array_equal(got_q, want_q, err_msg=f"qpos {i}")
        np.testing.assert_array_equal(got_t, want_t, err_msg=f"tpos {i}")
    assert al.seeding["hits"] == len(qpos)
    assert al.seeding["seeds"] >= len(np.unique(qpos))
    return al, jal


@pytest.mark.parametrize("fast_map", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_hits_equal_jax(case, fast_map, tmp_path):
    genome, contigs = CASES[case](tmp_path)
    al, _ = assert_seeding_equals_jax(genome, contigs, fast_map)
    assert al.stride == (32 if fast_map else 16)
    assert (al.index.suffix_bits == 0) == (case == "long_chunked")
    assert al.seeding["batches"] == 1


def test_runs_of_64_kept_65_dropped(tmp_path):
    """The repeat case probes a seed with a run of exactly 64 and one of
    65, and the whole align still equals JAX's."""
    genome, contigs = _repeat_64_65(tmp_path)
    al, jal = assert_seeding_equals_jax(genome, contigs)
    sk = al.index.sorted_kmers.numpy()
    seq = contigs.chunk_seq(0)
    packed, valid = pack_kmers_np(seq, 13)
    packed = packed[::al.stride][valid[::al.stride]]
    pcan = np.minimum(packed, rc_packed_np(packed, 13))
    runs = (np.searchsorted(sk, pcan, side="right")
            - np.searchsorted(sk, pcan, side="left"))
    assert {64, 65} <= set(runs.tolist())
    off, qpos, _ = al.seed_hits(query_segments(contigs)[:1])
    at_64 = (np.arange(0, len(seq) - 12, al.stride)[valid[::al.stride]]
             [runs == 64])
    assert np.isin(at_64, qpos).all()
    assert_contig_alignments_equal(al.align(contigs), jal.align(contigs))


@pytest.mark.parametrize("case", ["n_runs", "repeat_64_65"])
def test_small_seed_budget_many_batches(case, tmp_path, monkeypatch):
    """A seed budget of 7 seeds a batch: many batches (a run of 64 hits
    in one of them), the same hits."""
    monkeypatch.setattr(seeding, "CONTIG_SEED_BUDGET", 7)
    genome, contigs = CASES[case](tmp_path)
    al, _ = assert_seeding_equals_jax(genome, contigs)
    assert al.seeding["batches"] == -(-al.seeding["seeds"] // 7) > 50


def test_flat_hits_split_by_offsets(monkeypatch):
    """contig_seed_hits over all segments at once, in batches of 64 seeds
    that straddle segments: each segment's offsets slice is that
    segment's own call, in order; empty input gives empty output."""
    monkeypatch.setattr(seeding, "CONTIG_SEED_BUDGET", 64)
    genome, contigs = _n_runs(None)
    al = ContigAligner(genome, Config(), device="cpu")
    segs = query_segments(contigs)
    flat = torch.from_numpy(np.concatenate(segs))
    hits = seeding.contig_seed_hits(al.index, flat, [len(s) for s in segs],
                                    16)
    off = hits.offsets.numpy()
    assert hits.batches > 1 and len(hits.qpos) > 100
    for i, seg in enumerate(segs):
        one = seeding.contig_seed_hits(
            al.index, torch.from_numpy(seg.copy()), [len(seg)], 16)
        assert one.offsets.tolist() == [0, off[i + 1] - off[i]]
        assert torch.equal(one.qpos, hits.qpos[off[i]:off[i + 1]])
        assert torch.equal(one.tpos, hits.tpos[off[i]:off[i + 1]])
    none = seeding.contig_seed_hits(al.index, torch.zeros(0, dtype=torch.int8),
                                    [], 16)
    assert none.seeds == none.batches == 0 and none.offsets.tolist() == [0]
    assert none.qpos.dtype == none.tpos.dtype == torch.int64


@pytest.mark.parametrize("n", [30_000, 1_100_000])
def test_run_bounds_equal_searchsorted(n):
    """run_bounds (bucket, or two bounded binary searches inside it) ==
    np.searchsorted's left and right sides on present and absent keys."""
    idx = seeding.build_index(_genome(11, n), 13, device="cpu")
    assert (idx.suffix_bits == 0) == (n > 1 << 20)
    sk = idx.sorted_kmers.numpy()
    rng = np.random.default_rng(12)
    keys = np.concatenate([rng.choice(sk, 5_000),
                           rng.integers(0, 1 << 26, 5_000)]).astype(np.int32)
    lo, hi = seeding.run_bounds(idx, torch.from_numpy(keys))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(sk, keys))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.searchsorted(sk, keys, side="right"))
