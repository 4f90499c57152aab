"""The contig aligner's segments laid out on the device
(ContigAligner._segments: the real contigs written end to end into the
reused staging buffer, one copy up, segment_layout) on the CPU against
the host oracle, np.concatenate(query_segments(contigs)) and its
segments' lengths, for every kind of chunk table the port's callers
build; and one aligner's tile jobs over draft sets that grow, shrink and
grow again, against a fresh aligner's each time."""

import numpy as np
import pytest
import torch

from aligngraph_tpu_torch.align import contig_aligner as ca
from aligngraph_tpu_torch.config import LARGE_CHUNK, Config
from aligngraph_tpu_torch.io.fasta import write_fasta
from aligngraph_tpu_torch.io.formalize import (Contigs, _chunk_boundaries,
                                               formalize_contigs)
from aligngraph_tpu_torch.utils import spans
from tests.test_contig_aligner import contigs_from_arrays


def _rand(seed, n, codes=4):
    return np.random.default_rng(seed).integers(0, codes, n).astype(np.int8)


def _aligner(seed=1, n=5000):
    return ca.ContigAligner(_rand(seed, n), Config(), device="cpu")


def _formalized(tmp_path, seqs, chaff):
    """formalize_contigs of `seqs` with the chaff drafts `chaff` between
    them; checks the chunk table is _chunk_boundaries' of each kept."""
    drafts = [s for pair in zip(seqs, chaff + [None] * len(seqs))
              for s in pair if s is not None]
    path = tmp_path / "drafts.fa"
    write_fasta(str(path), [f"d{i}" for i in range(len(drafts))], drafts)
    contigs = formalize_contigs(str(path))
    want = [(r, a, n) for r, s in enumerate(seqs)
            for a, n in _chunk_boundaries(len(s))]
    assert list(zip(contigs.chunk_real, contigs.chunk_start,
                    contigs.chunk_len)) == want
    assert len(contigs.chaff_seqs) == len(chaff)
    return contigs


def _over_1mb(tmp_path):
    """A real of 1.3 Mb (two chunks), one of LARGE_CHUNK + 50 (its tail
    merged: one chunk) and a short one."""
    return _formalized(tmp_path, [_rand(2, 1_300_000),
                                  _rand(3, LARGE_CHUNK + 50),
                                  _rand(4, 700)], [])


def _with_n(tmp_path):
    """Drafts holding code 4 (N), alone and in runs, at both ends."""
    seqs = [_rand(5, 2000, codes=5), _rand(6, 900, codes=5)]
    seqs[0][:30] = 4
    seqs[1][-45:] = 4
    return contigs_from_arrays(seqs)


def _with_chaff(tmp_path):
    return _formalized(tmp_path, [_rand(7, 3000), _rand(8, 201),
                                  _rand(9, 1500)],
                       [_rand(10, 200), _rand(11, 50)])


def _shuffled(tmp_path):
    """The chunks of three reals, cut in pieces and listed in a random
    order."""
    c = contigs_from_arrays([_rand(12, 5000), _rand(13, 3100),
                             _rand(14, 800)])
    cr, cs, cl = [], [], []
    for r, s in enumerate(c.seqs):
        cuts = [0, 1300, 2900, len(s)] if len(s) > 2900 else [0, len(s)]
        for a, b in zip(cuts, cuts[1:]):
            cr.append(r), cs.append(a), cl.append(b - a)
    o = np.random.default_rng(15).permutation(len(cr))
    return _table(c.seqs, np.array(cr)[o], np.array(cs)[o], np.array(cl)[o])


def _partial(tmp_path):
    """Chunks that leave out a real and parts of others, overlap, and
    include a zero-length one; the reals as int64 codes."""
    seqs = [_rand(16, 4000).astype(np.int64), _rand(17, 600).astype(np.int64),
            _rand(18, 2500).astype(np.int64)]
    return _table(seqs, [2, 0, 0, 2, 0], [100, 3000, 2500, 2499, 10],
                  [2000, 999, 1000, 1, 0])


def _one_seed(tmp_path):
    return contigs_from_arrays([_rand(19, Config().seed_len)])


def _empty(tmp_path):
    return contigs_from_arrays([])


def _table(seqs, cr, cs, cl):
    return Contigs(ids=[f"c{i}" for i in range(len(seqs))], seqs=list(seqs),
                   chaff_ids=[], chaff_seqs=[],
                   chunk_real=np.asarray(cr, np.int32),
                   chunk_start=np.asarray(cs, np.int64),
                   chunk_len=np.asarray(cl, np.int64))


CASES = {"formalized_over_1mb": _over_1mb, "code_4": _with_n,
         "chaff": _with_chaff, "shuffled_table": _shuffled,
         "partial_table": _partial, "one_seed_draft": _one_seed,
         "empty": _empty}


@pytest.mark.parametrize("piece", [ca.LAYOUT_PIECE, 4099])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_equal_query_segments(case, piece, tmp_path, monkeypatch):
    """The device-built segments and their lengths equal the host
    oracle's, byte for byte, in pieces of either size."""
    monkeypatch.setattr(ca, "LAYOUT_PIECE", piece)
    contigs = CASES[case](tmp_path)
    want = ca.query_segments(contigs)
    segs, lens, counts = _aligner()._segments(contigs)
    assert segs.dtype == torch.int8 and lens.dtype == np.int64
    np.testing.assert_array_equal(
        segs.numpy(), np.concatenate(want) if want else np.zeros(0, np.int8))
    np.testing.assert_array_equal(lens, [len(s) for s in want])
    assert counts == dict(host_bytes=sum(len(s) for s in contigs.seqs),
                          pinned=0, staging_grows=int(bool(contigs.seqs)))


def _drafts(genome, seed, total):
    """Drafts of `total` bases cut from the genome at random, a few bases
    changed in each."""
    rng = np.random.default_rng(seed)
    out, left = [], total
    while left:
        n = min(left, int(rng.integers(400, 2500)))
        a = int(rng.integers(0, len(genome) - n))
        d = genome[a:a + n].copy()
        d[rng.integers(0, n, 3)] ^= 1
        out.append(d)
        left -= n
    return out


def _assert_jobs_equal(got, want):
    for f in ("chunk_id", "fr", "length"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("pid", "ts", "tlen", "g0", "dst", "src", "segs"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_reused_staging_buffer_gives_fresh_aligners_jobs():
    """One aligner over draft sets that grow, shrink and grow again: each
    call's jobs are a fresh aligner's (no stale bytes of a larger set),
    and the buffer grows only past its size, to twice it at least."""
    genome = _rand(20, 40_000)
    al = ca.ContigAligner(genome, Config(), device="cpu")
    totals = [3000, 9000, 2000, 12_000, 15_000, 4000]
    grows = []
    for i, total in enumerate(totals):
        contigs = contigs_from_arrays(_drafts(genome, 30 + i, total))
        spans.records(clear=True)
        with spans.recording():
            got = al.tile_jobs(contigs)
        (rec,) = [r for r in spans.records(clear=True)
                  if r["name"] == "align.contigs.segments"]
        assert rec["counts"]["host_bytes"] == total
        grows.append(rec["counts"]["staging_grows"])
        want = ca.ContigAligner(genome, Config(), index=al.index,
                                device="cpu").tile_jobs(contigs)
        assert got.n > 0
        _assert_jobs_equal(got, want)
    # capacities 3000, 9000, 9000, 18000, 18000, 18000
    assert grows == [1, 1, 0, 1, 0, 0]
    assert len(al._staging) == 18_000
