"""The port's plain banded SW (aligngraph_tpu_torch/ops/banded_sw.py)
against the JAX package, bit for bit (tolerance 0: every output is an
integer), and the CUDA wrappers' refusal of CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligngraph_tpu.ops import banded_sw as jsw
from aligngraph_tpu.ops.banded_sw_pallas import banded_sw_posmap_fast
from aligngraph_tpu_torch.ops import banded_sw as tsw
from aligngraph_tpu_torch.ops import banded_sw_cuda
from tests.test_banded_sw import full_sw_score, make_case


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def oracle_batch(seed, B, L, pad, max_mut=6):
    """Reads cut from random genomes with substitutions and indels
    (tests/test_banded_sw.py make_case): (reads, rlens, windows) numpy."""
    rng = np.random.default_rng(seed)
    cases = [make_case(rng, L, pad, n_mut=int(rng.integers(0, max_mut)))
             for _ in range(B)]
    reads, rlens, wins = zip(*cases)
    return (np.stack(reads), np.array(rlens, np.int32), np.stack(wins))


def posmap_batch(seed, B, L, pad, mut, zero_every):
    """The inputs of tests/test_banded_sw.py's posmap tests: reads from one
    genome with `mut` substitutions, a 2-base deletion in ~30% of lanes,
    lengths 30..L, every `zero_every`-th lane of length 0; g0 per lane."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 5000).astype(np.int8)
    reads = np.full((B, L), 4, np.int8)
    rlens = np.zeros(B, np.int32)
    g0 = np.zeros(B, np.int32)
    for i in range(B):
        ln = int(rng.integers(30, L + 1))
        st = int(rng.integers(0, len(genome) - ln - 2 * pad))
        seq = genome[st:st + ln].copy()
        mi = rng.random(ln) < mut
        seq[mi] = (seq[mi] + rng.integers(1, 4, mi.sum())) % 4
        if rng.random() < 0.3 and ln > 10:
            cut = int(rng.integers(5, ln - 5))
            seq = np.concatenate([seq[:cut], seq[cut + 2:]])
            ln = len(seq)
        reads[i, :ln] = seq
        rlens[i] = ln
        g0[i] = st
    rlens[::zero_every] = 0
    x = g0[:, None] - pad + np.arange(L + 2 * pad)[None, :]
    windows = np.where((x >= 0) & (x < len(genome)),
                       genome[np.clip(x, 0, len(genome) - 1)],
                       np.int8(4)).astype(np.int8)
    return reads, rlens, windows, g0


def tied_batch(pad):
    """Crafted ties: a read inside a tandem repeat (the same best in
    several bands: the lowest band wins), a read whose best is reached on
    two rows (the first row wins), an all-N read, an empty lane."""
    L = 40
    W = 2 * pad
    unit = np.array([0, 1, 2, 3], np.int8)
    rep = np.tile(unit, (L + W) // 4 + 1)[:L + W]
    reads = np.full((4, L), 4, np.int8)
    windows = np.zeros((4, L + W), np.int8)
    rlens = np.array([L, L, L, 0], np.int32)
    reads[0] = rep[pad:pad + L]
    windows[0] = rep
    # match 10, 12 mismatches (-36 < 0: a fresh start), match 10 again
    rng = np.random.default_rng(5)
    win = rng.integers(0, 4, L + W).astype(np.int8)
    r1 = win[pad:pad + L].copy()
    r1[10:22] = (r1[10:22] + 1) % 4
    r1[32:] = (r1[32:] + 2) % 4
    reads[1] = r1
    windows[1] = win
    windows[2] = rng.integers(0, 4, L + W)      # reads[2] stays all N
    windows[3] = rng.integers(0, 4, L + W)
    return reads, rlens, windows


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def assert_sw_equal(got: tsw.SWResult, want):
    for name in ("score", "best_i", "best_b", "tb"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("pad", [8, 16])
@pytest.mark.parametrize("seed", range(3))
def test_banded_sw_equals_jax(seed, pad):
    reads, rlens, wins = oracle_batch(seed, 16, 64, pad)
    got = tsw.banded_sw(*_t(reads, rlens, wins), pad=pad)
    want = jsw.banded_sw(*_j(reads, rlens, wins), pad=pad)
    assert_sw_equal(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_banded_sw_matches_full_sw_oracle(seed):
    pad = 16
    reads, rlens, wins = oracle_batch(100 + seed, 12, 48, pad)
    got = tsw.banded_sw(*_t(reads, rlens, wins), pad=pad)
    for k in range(len(reads)):
        assert int(got.score[k]) == full_sw_score(reads[k, :rlens[k]],
                                                  wins[k]), f"case {k}"


@pytest.mark.parametrize("pad", [8, 16])
def test_banded_sw_ties_equal_jax(pad):
    reads, rlens, wins = tied_batch(pad)
    got = tsw.banded_sw(*_t(reads, rlens, wins), pad=pad)
    want = jsw.banded_sw(*_j(reads, rlens, wins), pad=pad)
    assert_sw_equal(got, want)
    # the repeat's best ties across bands: the lowest one is reported
    assert int(got.best_b[0]) < pad
    assert int(got.score[2]) == 0 and int(got.best_i[3]) == 0


@pytest.mark.parametrize("pad", [8, 16])
def test_sw_traceback_equals_jax(pad):
    reads, rlens, wins = oracle_batch(7 + pad, 24, 80, pad, max_mut=8)
    want = jsw.banded_sw(*_j(reads, rlens, wins), pad=pad)
    g0 = np.random.default_rng(pad).integers(-50, 5000, len(reads)).astype(
        np.int32)
    pm_j = jsw.sw_traceback(want.tb, want.best_i, want.best_b,
                            jnp.asarray(g0), pad=pad)
    got = tsw.banded_sw(*_t(reads, rlens, wins), pad=pad)
    pm_t = tsw.sw_traceback(got.tb, got.best_i, got.best_b,
                            torch.from_numpy(g0), pad=pad)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    assert pm_t.dtype == torch.int32 and (pm_t >= 0).any()


def test_gapless_diag_ties_equal_jax():
    pad, L = 8, 24
    rng = np.random.default_rng(3)
    win = rng.integers(0, 4, (6, L + 2 * pad)).astype(np.int8)
    reads = win[:, pad:pad + L].copy()
    rlens = np.full(6, L, np.int32)
    # two equal runs split by a deep dip: the first end wins
    reads[0, 8:16] = (reads[0, 8:16] + 1) % 4
    # a run, a dip back to exactly the prefix minimum, a run: the start is
    # the last minimum
    reads[1, 4:6] = (reads[1, 4:6] + 1) % 4
    reads[1, 9] = (reads[1, 9] + 1) % 4
    # every base a mismatch: best 0
    reads[2] = (reads[2] + 1) % 4
    reads[3, 5] = 4
    rlens[4] = 0
    rlens[5] = 7
    got = tsw.gapless_diag(*_t(reads, rlens, win), pad)
    want = jsw.gapless_diag(*_j(reads, rlens, win), pad)
    for g, w, name in zip(got, want, ("best", "start", "end")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["pad8_b128", "pad8_b256", "pad16_b128"])
@pytest.mark.parametrize("with_smin", [False, True])
def test_posmap_auto_equals_jax(case, with_smin):
    pad, B, mut, zero_every, seed = {
        "pad8_b128": (8, 128, 0.05, 17, 21),
        "pad8_b256": (8, 256, 0.04, 23, 33),
        "pad16_b128": (16, 128, 0.05, 19, 44)}[case]
    reads, rlens, wins, g0 = posmap_batch(seed, B, 60, pad, mut, zero_every)
    smin = np.full(B, 40, np.int32) if with_smin else None
    s_t, pm_t = tsw.banded_sw_posmap_auto(
        *_t(reads, rlens, wins, g0), pad=pad,
        smin=None if smin is None else torch.from_numpy(smin))
    s_j, pm_j = jsw.banded_sw_posmap_auto(
        *_j(reads, rlens, wins, g0), pad=pad,
        smin=None if smin is None else jnp.asarray(smin))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))


def test_posmap_auto_equals_jax_pallas_fast_path():
    """The JAX TPU orchestration (Pallas kernels in interpret mode), on the
    inputs of tests/test_banded_sw.py:216."""
    pad = 8
    reads, rlens, wins, g0 = posmap_batch(33, 256, 60, pad, 0.04, 23)
    smin = np.full(256, 30, np.int32)
    s_t, pm_t = tsw.banded_sw_posmap_auto(*_t(reads, rlens, wins, g0),
                                          pad=pad,
                                          smin=torch.from_numpy(smin))
    s_j, pm_j = banded_sw_posmap_fast(*_j(reads, rlens, wins, g0), pad=pad,
                                      smin=jnp.asarray(smin), interpret=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))


WRAPPERS = {
    "sw_score_cuda": lambda r, n, w, g: banded_sw_cuda.sw_score_cuda(
        r, n, w, 8),
    "sw_dp_cuda": lambda r, n, w, g: banded_sw_cuda.sw_dp_cuda(r, n, w, 8),
    "sw_dp_cuda_cells": lambda r, n, w, g: banded_sw_cuda.sw_dp_cuda(
        r, n, w, 8, cells_per_lane=4),
    "sw_traceback_cuda": lambda r, n, w, g: banded_sw_cuda.sw_traceback_cuda(
        torch.zeros((r.shape[0], r.shape[1], 16), dtype=torch.uint8), n, n,
        g, 8),
    "banded_sw_cuda": lambda r, n, w, g: banded_sw_cuda.banded_sw_cuda(
        r, n, w, 8),
    "banded_sw_posmap_cuda": lambda r, n, w, g:
        banded_sw_cuda.banded_sw_posmap_cuda(r, n, w, g, 8),
    "banded_sw_posmap_fast": lambda r, n, w, g:
        banded_sw_cuda.banded_sw_posmap_fast(r, n, w, g, 8),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_wrappers_raise_on_cpu_tensors(name):
    reads, rlens, wins, g0 = _t(*posmap_batch(1, 8, 30, 8, 0.0, 5))
    before = dict(banded_sw_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        WRAPPERS[name](reads, rlens, wins, g0)
    assert banded_sw_cuda.LAUNCHES == before


@pytest.mark.parametrize("pad,cells", [(8, 3), (8, 16), (16, 0), (5, 2)])
def test_sw_dp_cuda_rejects_unbuilt_layout(pad, cells):
    """A cells_per_lane not in DP_CELLS for the band width raises before
    any launch (and before the tensors are looked at)."""
    assert cells not in banded_sw_cuda.DP_CELLS.get(2 * pad, (1,))
    reads, rlens, wins, _ = _t(*posmap_batch(1, 8, 30, pad, 0.0, 5))
    before = dict(banded_sw_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="not built for band width"):
        banded_sw_cuda.sw_dp_cuda(reads, rlens, wins, pad,
                                  cells_per_lane=cells)
    assert banded_sw_cuda.LAUNCHES == before


def test_auto_dispatches_cpu_tensors_to_plain():
    reads, rlens, wins, g0 = _t(*posmap_batch(2, 16, 40, 8, 0.02, 5))
    before = dict(banded_sw_cuda.LAUNCHES)
    s_a, pm_a = tsw.banded_sw_posmap_auto(reads, rlens, wins, g0, pad=8)
    s_p, pm_p = tsw.banded_sw_posmap_plain(reads, rlens, wins, g0, pad=8)
    assert torch.equal(s_a, s_p) and torch.equal(pm_a, pm_p)
    assert banded_sw_cuda.LAUNCHES == before


@pytest.fixture(scope="module")
def tile_case():
    """Contig-aligner tile lanes at L 512, pad 16 (aligngraph_tpu_torch.
    workload.tile_lanes: indels up to 6 bases, diagonal offsets up to
    +-12, partial and length-0 tiles), with JAX's DP on them."""
    from aligngraph_tpu_torch.workload import tile_lanes

    tiles, tlens, wins, g0 = tile_lanes(np.random.default_rng(12), 48,
                                        G=20_000)
    assert (tlens == 0).any() and ((tlens > 0) & (tlens < 512)).any()
    want = jsw.banded_sw(*_j(tiles, tlens, wins), pad=16)
    return (tiles, tlens, wins, g0), want


def test_banded_sw_tile_l512_equals_jax(tile_case):
    (tiles, tlens, wins, _), want = tile_case
    got = tsw.banded_sw(*_t(tiles, tlens, wins), pad=16)
    assert_sw_equal(got, want)
    # some tiles carry an indel the band has to absorb
    gapless = tsw.gapless_diag(*_t(tiles, tlens, wins), 16)[0]
    assert (got.score > gapless).sum() >= 5


def test_sw_traceback_tile_l512_equals_jax(tile_case):
    """The walk's step budget at L 512 (traceback_steps(512, 32) = 1064
    moves) against JAX's unrolled scan."""
    (tiles, tlens, wins, g0), want = tile_case
    assert tsw.traceback_steps(512, 32) == 1064
    pm_j = jsw.sw_traceback(want.tb, want.best_i, want.best_b,
                            jnp.asarray(g0), pad=16)
    got = tsw.banded_sw(*_t(tiles, tlens, wins), pad=16)
    pm_t = tsw.sw_traceback(got.tb, got.best_i, got.best_b,
                            torch.from_numpy(g0), pad=16)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    # full-length tiles are walked over hundreds of bases
    assert int((pm_t >= 0).sum(dim=1).max()) > 450


def test_posmap_auto_tile_l512_equals_jax(tile_case):
    (tiles, tlens, wins, g0), _ = tile_case
    s_t, pm_t = tsw.banded_sw_posmap_auto(*_t(tiles, tlens, wins, g0),
                                          pad=16)
    s_j, pm_j = jsw.banded_sw_posmap_auto(*_j(tiles, tlens, wins, g0),
                                          pad=16)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    assert (pm_t[torch.from_numpy(tlens == 0)] == -1).all()


def test_launch_counts_survive_threads():
    """The pipeline launches from two host threads (read and contig
    aligners): no count update is lost."""
    import sys
    import threading

    banded_sw_cuda.reset_launches()
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            banded_sw_cuda._launch("dp", 100, 3, lambda: 0)
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert banded_sw_cuda.LAUNCHES["dp"] == n_threads * per_thread
    assert banded_sw_cuda.LANES["dp"] == 3 * n_threads * per_thread
    assert banded_sw_cuda.LAUNCHES_BY_L == {("dp", 100): n_threads * per_thread}
    assert banded_sw_cuda.LANES_BY_L == {("dp", 100):
                                         3 * n_threads * per_thread}
    banded_sw_cuda.reset_launches()
    assert banded_sw_cuda.LAUNCHES == {"score": 0, "dp": 0, "traceback": 0}
    assert banded_sw_cuda.LAUNCHES_BY_L == {} == banded_sw_cuda.LANES_BY_L
