"""The contig aligner's batched _finalize on the CPU against the JAX
package: the chain DP's plain version (ops/monotone_chain) against the
JAX _enforce_monotone and the port's C++ loop, finalize_placements against
the JAX ContigAligner._finalize, and ContigAligner.align against the JAX
one on long chimeric contigs.  Everything is integer: tolerance 0."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aligngraph_tpu.align import contig_aligner as jax_ca
from aligngraph_tpu.config import Config as JaxConfig
from aligngraph_tpu_torch import native
from aligngraph_tpu_torch.align import contig_aligner as ca
from aligngraph_tpu_torch.config import INIT_CONTIG_THRESHOLD, Config
from aligngraph_tpu_torch.ops import monotone_chain as mc
from aligngraph_tpu_torch.workload import make_misassembly_workload
from tests.test_contig_aligner import contigs_from_arrays
from tests.test_torch_contig_aligner import assert_contig_alignments_equal

# the assembler's acceptance and the one Eval and stage (5) pass
ACCEPTS = {"assembler": (INIT_CONTIG_THRESHOLD, INIT_CONTIG_THRESHOLD, 200),
           "eval": (0.0, 0.0, 0)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_blocks(rng, m, spread):
    """m blocks in query order: targets from a sorted draw over `spread`
    plus noise (narrow spreads make equal gains), weights 1..59, and some
    overlaps past a block's weight (kept weight <= 0)."""
    t0 = np.sort(rng.integers(0, spread, m)) + rng.integers(0, 600, m)
    w = rng.integers(1, 60, m).astype(np.int64)
    t1 = t0 + w
    back = rng.random(m) < 0.1                  # overlap the block before
    t0[1:][back[1:]] = np.maximum(t1[:-1][back[1:]] - rng.integers(
        0, 120, int(back[1:].sum())), 0)
    t1 = t0 + w
    return t0.astype(np.int64), t1.astype(np.int64), w


def blocks_map(t0, w):
    """A pos_map whose M-blocks are exactly these: block k's bases are
    consecutive and map to t0[k]..t0[k]+w[k]-1, one unaligned base apart."""
    pm = np.full(int(w.sum() + len(w)), -1, np.int32)
    q = 0
    for a, n in zip(t0, w):
        pm[q:q + n] = a + np.arange(n)
        q += n + 1
    return pm


def apply_chain(pm, w, keep, trim):
    """_enforce_monotone's last two loops on blocks_map's layout."""
    q = 0
    for n, k, r in zip(w, keep, trim):
        if not k:
            pm[q:q + n] = -1
        elif r > 0:
            pm[q:q + r] = -1
        q += n + 1


@pytest.mark.parametrize("m", [1, 2, 3, 7, 64, 300, 2_000])
def test_monotone_chain_plain_equals_jax_and_native(m):
    """Three placements of m, m // 2 + 1 and 1 blocks (and an empty one)
    in one CSR batch: best, parent and trim equal the C++ loop's and
    _chain_dp's per placement, and keep applied to the placement's
    pos_map leaves what the JAX _enforce_monotone leaves."""
    rng = np.random.default_rng(m)
    for spread in (3, 40 * m):
        sizes = [m, 0, m // 2 + 1, 1]
        blocks = [random_blocks(rng, n, spread) for n in sizes]
        cat = [torch.from_numpy(np.concatenate([b[i] for b in blocks]))
               for i in range(3)]
        off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]))
        best, parent, trim, keep = mc.monotone_chain_plain(*cat, off)
        assert keep.dtype == torch.bool and best.dtype == torch.int64
        for (t0, t1, w), a, b in zip(blocks, off[:-1].tolist(),
                                     off[1:].tolist()):
            if b == a:
                continue
            got = [x[a:b].numpy() for x in (best, parent, trim)]
            for g, e, n in zip(got, ca._chain_dp(t0, t1, w),
                               native.monotone_chain_native(t0, t1, w)):
                np.testing.assert_array_equal(g, e)
                np.testing.assert_array_equal(g, n)
            pm = blocks_map(t0, w)
            want = pm.copy()
            jax_ca._enforce_monotone(want)
            apply_chain(pm, w, keep[a:b].numpy(), got[2])
            np.testing.assert_array_equal(pm, want)


def test_monotone_chain_dispatch_and_checks():
    """CPU tensors take the plain version and count no launch; the
    kernel's wrapper refuses CPU tensors, and both refuse bad inputs."""
    t0, t1, w = (torch.from_numpy(a) for a in
                 random_blocks(np.random.default_rng(0), 9, 100))
    off = torch.tensor([0, 4, 9])
    mc.reset_launches()
    got = mc.monotone_chain(t0, t1, w, off)
    want = mc.monotone_chain_plain(t0, t1, w, off)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert mc.LAUNCHES == {"chain": 0} == mc.LANES
    with pytest.raises(ValueError, match="CUDA"):
        mc.monotone_chain_cuda(t0, t1, w, off)
    with pytest.raises(ValueError, match="int64"):
        mc.monotone_chain(t0.int(), t1, w, off)
    with pytest.raises(ValueError, match="one length"):
        mc.monotone_chain(t0, t1[:-1], w, off)


def random_placement(rng, kind, n):
    """One pos_map of n bases, junk-like or true, by kind."""
    pm = np.full(n, -1, np.int32)
    base = int(rng.integers(0, 60_000))
    if kind == "junk":                  # random blocks, overlaps, reversals
        q = 0
        while q < n:
            ln = int(rng.integers(1, 80))
            if rng.random() < 0.7:
                pm[q:q + ln] = int(rng.integers(0, 50_000)) + np.arange(
                    len(pm[q:q + ln]))
            q += ln + int(rng.integers(0, 5))
    elif kind == "seams":               # a true run with 512-base seams
        pm[:] = base + np.arange(n)
        for s in range(512, n, 512):
            back = int(rng.integers(0, 20))
            pm[s:] -= back
            pm[s - int(rng.integers(0, 6)):s] = -1
    elif kind == "holes":               # gaps, gapless or on a new diagonal
        pm[:] = base + np.arange(n)
        for _ in range(int(rng.integers(1, 8))):
            a = int(rng.integers(0, n))
            pm[a:a + int(rng.integers(1, 40))] = -1
            if rng.random() < 0.3:
                pm[a + 40:] = np.where(pm[a + 40:] >= 0,
                                       pm[a + 40:] + 3, -1)
    elif kind == "single":
        a = int(rng.integers(0, n))
        ln = int(rng.integers(1, n - a + 1))
        pm[a:a + ln] = base + np.arange(ln)
    elif kind == "monotone":            # increasing blocks with gaps
        q, t = 0, base
        while q < n:
            ln = int(rng.integers(1, 200))
            pm[q:q + ln] = t + np.arange(len(pm[q:q + ln]))
            t += ln + int(rng.integers(0, 50))
            q += ln + int(rng.integers(1, 30))
    return pm                           # "empty": all -1


KINDS = ("junk", "seams", "holes", "single", "monotone", "empty")


@pytest.mark.parametrize("accept", sorted(ACCEPTS))
@pytest.mark.parametrize("seed", range(3))
def test_finalize_equals_jax(seed, accept):
    """finalize_placements on CPU tensors leaves every field, and every
    pos_map byte for byte, that the JAX ContigAligner._finalize gives the
    same placements."""
    maps, cids, frs = random_placements(np.random.default_rng(100 + seed),
                                        60)
    acc = ACCEPTS[accept]
    placements = [dict(chunk_id=c, fr=f, length=len(pm), pos_map=pm.copy())
                  for c, f, pm in zip(cids, frs, maps)]
    want = jax_ca.ContigAligner._finalize(SimpleNamespace(accept=acc),
                                          placements, None)
    pl = ca.Placements.from_maps(maps, cids, frs, "cpu")
    st: dict = {}
    got = ca.finalize_placements(pl, acc, st)
    assert_contig_alignments_equal(got, want, 10 if accept == "eval" else 1)
    counts = st["counts"]
    assert counts["placements"] == 60 and counts["rows"] == got.n
    assert counts["need_dp"] > 0 and counts["gaps_filled"] > 0
    assert counts["unkept"] > 0 and counts["trimmed"] > 0
    assert set(st["split"]) == set(ca.FINALIZE_STEPS)


def random_placements(rng, n_maps):
    """n_maps position maps of every kind (the first 12 by turns, then
    drawn), with chunk ids and strands."""
    maps, cids, frs = [], [], []
    for k in range(n_maps):
        kind = KINDS[k % len(KINDS)] if k < 12 else KINDS[
            int(rng.integers(0, len(KINDS)))]
        maps.append(random_placement(rng, kind,
                                     int(rng.integers(50, 3_000))))
        cids.append(int(rng.integers(0, 30)))
        frs.append(int(rng.integers(0, 2)))
    return maps, cids, frs


@pytest.mark.parametrize("pass_bases", [1, 2_500, 20_000])
def test_finalize_passes_equal_jax(pass_bases, monkeypatch):
    """Passes of at most pass_bases buffer bases (1: a placement a pass)
    leave what the JAX ContigAligner._finalize leaves, and the counts
    of one pass."""
    maps, cids, frs = random_placements(np.random.default_rng(7), 40)
    acc = ACCEPTS["assembler"]
    placements = [dict(chunk_id=c, fr=f, length=len(pm), pos_map=pm.copy())
                  for c, f, pm in zip(cids, frs, maps)]
    want = jax_ca.ContigAligner._finalize(SimpleNamespace(accept=acc),
                                          placements, None)
    one: dict = {}
    ca.finalize_placements(ca.Placements.from_maps(maps, cids, frs, "cpu"),
                           acc, one)
    st: dict = {}
    monkeypatch.setattr(ca, "FINALIZE_PASS_BASES", pass_bases)
    got = ca.finalize_placements(
        ca.Placements.from_maps(maps, cids, frs, "cpu"), acc, st)
    assert_contig_alignments_equal(got, want, 1)
    n_passes = st["counts"].pop("passes")
    assert one["counts"].pop("passes") == 1
    assert st["counts"] == one["counts"]
    assert 1 < n_passes <= 40 and (n_passes == 40) == (pass_bases == 1)


@pytest.mark.parametrize("seed", range(3))
def test_finalize_equals_port_oracles(seed):
    """With Eval's acceptance (every placement with an aligned base is
    kept) each kept pos_map is what the port's per-placement oracles
    leave: _enforce_monotone (its C++ chain DP), then
    _fill_gapless_holes."""
    maps, cids, frs = random_placements(np.random.default_rng(200 + seed),
                                        60)
    want = []
    for pm in maps:
        pm = pm.copy()
        ca._enforce_monotone(pm)
        ca._fill_gapless_holes(pm)
        if (pm >= 0).any():
            want.append(pm)
    got = ca.finalize_placements(
        ca.Placements.from_maps(maps, cids, frs, "cpu"), ACCEPTS["eval"], {})
    assert [m.tobytes() for m in got.pos_map] == [m.tobytes() for m in want]
    np.testing.assert_array_equal(got.score, [(m >= 0).sum() for m in want])


def test_finalize_no_placements_and_nothing_aligned():
    for maps in ([], [np.full(300, -1, np.int32)]):
        pl = ca.Placements.from_maps(maps, [0] * len(maps), [0] * len(maps),
                                     "cpu")
        got = ca.finalize_placements(pl, ACCEPTS["eval"], {})
        assert got.n == 0 and got.pos_map == []
        assert got.chunk_id.dtype == np.int32 and got.fr.dtype == np.int8


@pytest.fixture(scope="module")
def chimeric():
    """Long drafts of a 300 kb misassembly workload, a third of them in a
    chimera, against the target."""
    wl = make_misassembly_workload(300_000, 1.0, 11, chimera_frac=0.6,
                                   min_apart=60_000, draft_len=20_000)
    assert len(wl["chimera_index"]) > 0
    return wl["target"], wl["contigs"]


@pytest.mark.parametrize("join_gap", [ca.MAX_JOIN_GAP, 2000])
def test_align_long_chimeric_equals_jax(chimeric, join_gap):
    """ContigAligner.align with Eval's acceptance (and stage (5)'s join
    gap) equals the JAX one on long chimeric contigs, whose junk
    placements need the chain DP."""
    target, seqs = chimeric
    contigs = contigs_from_arrays(seqs)
    acc = ACCEPTS["eval"]
    want = jax_ca.ContigAligner(target, JaxConfig(), max_join_gap=join_gap,
                                accept=acc).align(contigs)
    al = ca.ContigAligner(target, Config(), max_join_gap=join_gap,
                          accept=acc, device="cpu")
    got = al.align(contigs)
    assert_contig_alignments_equal(got, want, len(seqs))
    assert al.finalize_counts["need_dp"] > 0
    assert al.finalize_counts["rows"] == got.n
    assert set(al.finalize_split) == set(ca.FINALIZE_STEPS)
