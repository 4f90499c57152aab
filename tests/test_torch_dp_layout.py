"""A numpy model of sw_dp_kernel (aligngraph_tpu_torch/csrc/banded_sw.cu),
lane by lane, held to the plain banded_sw bit for bit.

The kernel itself runs only on the card (chip_smoke.py compares it with
the plain version there); this model checks its algebra here.  It
follows the kernel's per-lane arithmetic: a group of G lanes holds one
candidate, C consecutive band cells a lane (b = g*C + k); E carried as
Et = E + i (the top cell's "up" taken out by a decay of kFar), the in-row
F carried as F + 3 (S in the lane), one shuffle and a log2(G)-step
max-plus scan with decay C per lane across the group (inclusive at C 1,
with no shift); the traceback byte from those values; each lane's best
as a key (H * 32 + 31 - b; H alone at C 1) replaced on a strictly better
row, and one butterfly reduction per candidate by (score desc, row asc,
band asc).  Shuffles are modelled as CUDA defines them within a group: a
lane whose source is outside the group gets its own value.  Every layout
the kernel is built for (DP_CELLS) is checked, and C 1 over 32 lanes
with dead cells at a band width other than 16 and 32.
"""

import numpy as np
import pytest
import torch

from aligngraph_tpu_torch.ops import banded_sw as tsw
from aligngraph_tpu_torch.ops.banded_sw_cuda import DP_CELLS
from aligngraph_tpu_torch.workload import tile_lanes
from tests.test_torch_banded_sw import oracle_batch, posmap_batch, tied_batch

NEG = np.int32(-10_000_000)     # kNeg
FAR = np.int32(-(1 << 30))      # kFar


def _i32(a):
    return np.asarray(a, dtype=np.int32)


def shfl_down(x, d):
    """__shfl_down_sync(x, d, G) over the lane axis (-1) of x."""
    G = x.shape[-1]
    src = np.arange(G) + d
    return x[..., np.where(src < G, src, np.arange(G))]


def shfl_up(x, d):
    G = x.shape[-1]
    src = np.arange(G) - d
    return x[..., np.where(src >= 0, src, np.arange(G))]


def shfl_xor(x, m):
    return x[..., np.arange(x.shape[-1]) ^ m]


def dp_model(reads, rlens, windows, pad, C):
    """sw_dp_kernel<C, G, kFit> on numpy inputs -> (score, best_i, best_b
    [B] int32, tb [L, B, W] uint8), the plain version's layout."""
    B, L = reads.shape
    W = 2 * pad
    fit = W in (16, 32)
    if not fit:
        assert C == 1
    G = W // C if fit else 32
    g = np.arange(G)
    b0 = g * C
    top = b0 + C >= W                      # cell b0 + C is out of the band
    live = [(b0 + k < W) for k in range(C)]             # [C] of [G]
    decay = [np.where(g >= s, -C * s, FAR) for s in (1, 2, 4, 8, 16)]
    reads = reads.astype(np.int32)
    windows = windows.astype(np.int32)
    rl = rlens.astype(np.int32)[:, None]
    wlast = np.minimum(b0 + C - 1, W - 1)  # dead lanes: the band's last
    T_of = np.array([0xFDDD2, 0xFDD2D, 0xFD2DD, 0xF2DDD, 0xFFFFF], np.uint32)

    H = [np.broadcast_to(np.where(live[k], 0, NEG), (B, G)).astype(np.int32)
         for k in range(C)]
    Et = [np.full((B, G), NEG, np.int32) for _ in range(C)]
    sh = [_i32(28 - 4 * np.where(live[k], windows[:, np.minimum(b0 + k,
                                                                 W - 1)], 4))
          for k in range(C)]
    bkey = np.full((B, G), 0 if C == 1 else 31, np.int32)
    bi = np.zeros((B, G), np.int32)
    tb = np.zeros((L, B, W), np.uint8)
    for i in range(1, L + 1):
        T = T_of[np.minimum(reads[:, i - 1], 4)][:, None]
        hu = shfl_down(H[0], 1)
        eu = shfl_down(Et[0], 1)
        if C > 1:
            eu = np.where(top, NEG, eu)
        xoff = np.where(top, FAR, i - 3)
        Etn, Hno, S, M, eb = [], [], [], [], []
        for k in range(C):
            last = k + 1 == C
            hup = hu if last else H[k + 1]
            eup = eu if last else Et[k + 1]
            Etn.append(np.maximum(hup + (xoff if last else i - 3), eup))
            eb.append((top if last else False) | (eup - hup > i - 3))
            s = ((T << sh[k].astype(np.uint32)).astype(np.uint32)
                 .view(np.int32) >> 28)
            M.append(H[k] + s)
            Hno.append(np.maximum(np.maximum(Etn[k] - i, M[k]), 0))
            S.append(Hno[0] if k == 0 else np.maximum(S[k - 1] - 1, Hno[k]))
        # F + 3 entering the lane's first cell (C > 1) or of the next cell
        # (C 1, inclusive); Hno of the cell before
        if C == 1:
            v = S[0]
        else:
            v = np.where(g == 0, NEG + 2, shfl_up(S[C - 1], 1))
            hl = np.where(g == 0, NEG, shfl_up(Hno[C - 1], 1))
        j, s = 0, 1
        while s < G:
            v = np.maximum(shfl_up(v, s) + decay[j], v)
            j, s = j + 1, s * 2
        if C == 1:
            fb1 = np.where(g == 0, True, shfl_up(v > Hno[0], 1))
        rowkey = None
        for k in range(C):
            if C == 1:
                h = np.maximum(v - 2, Hno[0])
                fb = fb1
            else:
                fk = v if k == 0 else np.maximum(S[k - 1] + k, v)
                h = np.maximum(fk - (k + 3), Hno[k])
                fb = fk > (hl if k == 0 else Hno[k - 1]) + k
            nz, is_m, is_e = h != 0, M[k] == h, Etn[k] == h + i
            byte = ((nz & (is_m | ~is_e)).astype(np.int32)
                    | ((nz & ~is_m).astype(np.int32) << 1)
                    | (eb[k].astype(np.int32) << 2)
                    | (fb.astype(np.int32) << 3))
            e = Etn[k]
            if not fit:
                h = np.where(live[k], h, NEG)
                e = np.where(live[k], e, NEG)
            key = h if C == 1 else h * 32 - k
            rowkey = key if rowkey is None else np.maximum(rowkey, key)
            H[k] = _i32(h)
            Et[k] = _i32(e)
            cols = (b0 + k)[live[k]]
            tb[i - 1][:, cols] = byte[:, live[k]].astype(np.uint8)
        if C == 1:
            upd = (i <= rl) & (rowkey > bkey)
        else:
            rowkey = rowkey + (31 - b0)
            upd = (i <= rl) & (rowkey > (bkey | 31))
        bkey = np.where(upd, rowkey, bkey)
        bi = np.where(upd, i, bi)
        # the next row's window codes: cell k takes cell k+1's, the last
        # cell one new byte
        sh = sh[1:] + [_i32(28 - 4 * (windows[:, i + wlast] if i < L
                                      else np.full((B, G), 4)))]
    if C == 1:
        bkey = np.where(bi > 0, bkey * 32 + 31 - b0, 31)
    sc = bkey >> 5
    sec = (bi << 5) | (31 - (bkey & 31))
    m = G // 2
    while m:
        osc, osec = shfl_xor(sc, m), shfl_xor(sec, m)
        take = (osc > sc) | ((osc == sc) & (osec < sec))
        sc = np.where(take, osc, sc)
        sec = np.where(take, osec, sec)
        m //= 2
    return sc[:, 0], sec[:, 0] >> 5, sec[:, 0] & 31, tb


def layouts(pad):
    return DP_CELLS.get(2 * pad, (1,))


def assert_model_equals_plain(reads, rlens, windows, pad, C):
    want = tsw.banded_sw(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (reads, rlens, windows)), pad=pad)
    score, best_i, best_b, tb = dp_model(reads, rlens, windows, pad, C)
    for name, got in (("score", score), ("best_i", best_i),
                      ("best_b", best_b), ("tb", tb)):
        np.testing.assert_array_equal(got, getattr(want, name).numpy(),
                                      err_msg=f"{name} (C {C})")
    return want


@pytest.mark.parametrize("pad,C", [(p, c) for p in (16, 8, 5)
                                   for c in layouts(p)])
def test_dp_model_l100_equals_plain(pad, C):
    reads, rlens, windows, _ = posmap_batch(50 + pad, 24, 100, pad, 0.05, 7)
    assert (rlens == 0).any()
    want = assert_model_equals_plain(reads, rlens, windows, pad, C)
    # F and E moves and their extensions all occur
    bits = want.tb.numpy()
    assert ((bits & 3) == 3).any() and ((bits & 3) == 2).any()
    assert ((bits >> 2) & 1).any()


@pytest.mark.parametrize("pad,C", [(p, c) for p in (16, 8, 5)
                                   for c in layouts(p)])
def test_dp_model_indels_equals_plain(pad, C):
    """Reads with substitutions and indels (tests/test_banded_sw.py's
    make_case), rows past rlen included."""
    reads, rlens, windows = oracle_batch(80 + pad, 12, 60, pad, max_mut=8)
    assert_model_equals_plain(reads, rlens, windows, pad, C)


@pytest.mark.parametrize("C", DP_CELLS[32])
def test_dp_model_tile_l512_equals_plain(C):
    """The contig aligner's tile lanes at L 512, pad 16: partial and
    length-0 tiles, indels up to 6 bases."""
    reads, rlens, windows, _ = tile_lanes(np.random.default_rng(12), 48,
                                          G=20_000)
    # every partial and length-0 tile, and the first 8 full ones
    keep = np.r_[np.nonzero(rlens < 512)[0], np.nonzero(rlens == 512)[0][:8]]
    reads, rlens, windows = reads[keep], rlens[keep], windows[keep]
    assert (rlens == 0).any() and ((rlens > 0) & (rlens < 512)).any()
    want = assert_model_equals_plain(reads, rlens, windows, 16, C)
    # some tiles carry an indel the band has to absorb
    gapless = tsw.gapless_diag(*(torch.from_numpy(a) for a in
                                 (reads, rlens, windows)), 16)[0]
    assert (want.score > gapless).any()


@pytest.mark.parametrize("pad,C", [(p, c) for p in (16, 8)
                                   for c in layouts(p)])
def test_dp_model_ties_equal_plain(pad, C):
    """An equal best in several bands of one row (the lowest wins) and in
    two rows (the first wins), an all-N read and an empty lane."""
    reads, rlens, windows = tied_batch(pad)
    want = assert_model_equals_plain(reads, rlens, windows, pad, C)
    assert int(want.best_b[0]) < pad
    assert int(want.score[3]) == 0 and int(want.best_i[3]) == 0
