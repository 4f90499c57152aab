"""The chain DP kernel's decomposition on the CPU, before any card: a numpy
emulation of csrc/monotone_chain.cu's blocked DP (blocks of B steps; each
block's candidates over the rows before the previous block split over S
cluster ranks, each rank's over P producer warps with two running firsts,
then the previous block's rows and the block's own in order) against
monotone_chain_plain and the JAX package's _enforce_monotone, at tolerance
0; and the wrapper's launch plan (ops/monotone_chain.chain_plan) as a pure
function.  The kernel itself is held to the plain version on the card by
chip_smoke.py's check_chain."""

import numpy as np
import pytest
import torch

from aligngraph_tpu.align import contig_aligner as jax_ca
from aligngraph_tpu_torch.ops import monotone_chain as mc
from tests.test_torch_finalize import apply_chain, blocks_map

LIMITS = mc.source_limits()
I32 = 1 << 31


def chain_blocks(rng, sizes, spread=None, back=0.1):
    """chip_smoke.chain_blocks on the CPU: per placement of m blocks,
    targets from a sorted draw over `spread` (40 m by default; a narrow
    one makes equal gains) plus noise, weights 1..59, and a `back` share
    overlapping the block before by up to 120 (kept weight <= 0 for
    some).  -> numpy int64 (t0, t1, w, offsets)."""
    t0s, ws = [], []
    for m in sizes:
        t0 = (np.sort(rng.integers(0, spread or 40 * m, m))
              + rng.integers(0, 600, m))
        w = rng.integers(1, 60, m)
        b = np.flatnonzero(rng.random(m) < back)
        b = b[b > 0]
        t0[b] = np.maximum(t0[b - 1] + w[b - 1] - rng.integers(0, 120,
                                                               len(b)), 0)
        t0s.append(t0)
        ws.append(w)
    t0 = np.concatenate(t0s).astype(np.int64)
    w = np.concatenate(ws).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return t0, t0 + w, w, off


class Emulation:
    """The kernel's arithmetic on one placement, in int64 with every value
    checked against int32 when the plan chose int32.  x = c[j] +
    min(t0[i], t1[j]) with c = best - t1, valid when t1[j] <= v[i] =
    t0[i] + w[i] - 1 (clamped), the gain x + w[i]; candidates combine as
    (larger x, then smaller j)."""

    NONE = np.iinfo(np.int64).min

    def __init__(self, B, S, P, int32):
        self.B, self.S, self.P, self.int32 = B, S, P, int32
        self.edge_ties = 0      # rows whose max came from both sides

    def fits(self, *arrays):
        if self.int32:
            for a in arrays:
                a = np.asarray(a)
                assert ((a >= -I32) & (a < I32)).all(), a

    def first_max(self, t, v, c, e, js):
        """Per row i (t, v): the first max of x over js (ascending) ->
        (g, j), g NONE where no j is valid."""
        if len(js) == 0:
            return (np.full(len(t), self.NONE), np.full(len(t), I32))
        x = c[js][None, :] + np.minimum(t[:, None], e[js][None, :])
        self.fits(x)
        x = np.where(e[js][None, :] <= v[:, None], x, self.NONE)
        k = np.argmax(x, axis=1)
        g = x[np.arange(len(t)), k]
        return g, np.where(g == self.NONE, I32, js[k])

    @staticmethod
    def better(g, j, g2, j2):
        return (g > g2) | ((g == g2) & (j < j2))

    def combine(self, a, b):
        take = self.better(b[0], b[1], a[0], a[1])
        return np.where(take, b[0], a[0]), np.where(take, b[1], a[1])

    def cross(self, k, t, v, c, e):
        """Block k's candidates over the rows of blocks q < k - 1: rank r
        owns the blocks q % S == r, its producer p the pairs of its local
        rows p, p + P, ..., even and odd rows in two running firsts."""
        B, S, P = self.B, self.S, self.P
        out = (np.full(len(t), self.NONE), np.full(len(t), I32))
        for r in range(S):
            owned = np.arange(r, max(k - 1, 0), S)
            rows = (owned[:, None] * B + np.arange(B)[None, :]).ravel()
            for p in range(P):
                local = np.arange(len(rows))
                mine = (local // 2) % P == p
                for parity in (0, 1):
                    js = rows[mine & (local % 2 == parity)]
                    out = self.combine(out, self.first_max(t, v, c, e, js))
        return out

    def run(self, t0, t1, w, lo):
        """-> (best, parent, trim, keep) of one placement, its targets
        rebased on lo."""
        m, B = len(w), self.B
        t, e = t0 - lo, t1 - lo
        v = np.minimum(t + w - 1, I32 - 1 if self.int32 else np.iinfo(
            np.int64).max)
        self.fits(t, e, w, v)
        best = w.copy()
        parent = np.full(m, -1, np.int64)
        trim = np.zeros(m, np.int64)
        c = np.zeros(m, np.int64)
        for k in range((m + B - 1) // B):
            i = np.arange(k * B, min(k * B + B, m))
            g, j = self.cross(k, t[i], v[i], c, e)
            g_cross = g.copy()
            lag = np.arange(max(k - 1, 0) * B, k * B)
            for s in lag:           # the previous block's rows, in order
                g, j = self.offer(g, j, i, s, t, v, c, e)
            for s in i:             # the block's own rows, in order:
                row = i == s        # row s is final, then offered
                self.finalise(s, g[row][0], j[row][0], w, t, e, best,
                              parent, trim, c)
                later = i > s
                g2, j2 = self.offer(g, j, i, s, t, v, c, e)
                g, j = np.where(later, g2, g), np.where(later, j2, j)
            self.edge_ties += int(((g_cross == g) & (g != self.NONE)
                                   & (j != I32) & self.tie_after(
                                       i, g, j, t, v, c, e)).sum())
        keep = np.zeros(m, bool)
        k = int(np.argmax(best)) if m else -1
        while k >= 0:
            keep[k] = True
            k = parent[k]
        return best, parent, trim, keep

    def offer(self, g, j, i, s, t, v, c, e):
        x = c[s] + np.minimum(t[i], e[s])
        self.fits(x)
        take = (e[s] <= v[i]) & (x > g)
        return np.where(take, x, g), np.where(take, s, j)

    def tie_after(self, i, g, j, t, v, c, e):
        """Rows whose first max (from before the previous block) is
        matched by a j at or after the previous block's first row."""
        out = np.zeros(len(i), bool)
        start = max(i[0] - self.B, 0) if len(i) else 0
        for s in range(start, i[-1] if len(i) else 0):
            x = c[s] + np.minimum(t[i], e[s])
            out |= (s < i) & (j < start) & (e[s] <= v[i]) & (x == g)
        return out

    def finalise(self, s, g, j, w, t, e, best, parent, trim, c):
        if g != self.NONE and g > 0:
            best[s] = g + w[s]
            parent[s] = j
            # from before the previous block: b[j] - x; else from t1[j]
            if j < (s // self.B - 1) * self.B:
                trim[s] = best[j] - g
            else:
                trim[s] = e[j] - min(e[j], t[s])
        c[s] = best[s] - e[s]
        self.fits(best[s], c[s], trim[s])


def emulate(t0, t1, w, off, B, S, P):
    """The emulation over a CSR batch, int32 when chain_plan proves it."""
    plan = mc.chain_plan(*(torch.from_numpy(a) for a in (t0, t1, w, off)),
                         LIMITS)
    em = Emulation(B, S, P, int32=not plan.wide)
    out = [np.zeros(len(w), np.int64) for _ in range(3)]
    keep = np.zeros(len(w), bool)
    for a, b, lo in zip(off[:-1], off[1:], plan.lo.tolist()):
        res = em.run(t0[a:b], t1[a:b], w[a:b], lo)
        for o, r in zip(out + [keep], res):
            o[a:b] = r
    return (*out, keep), em, plan


def assert_equals_plain_and_jax(t0, t1, w, off, got):
    want = mc.monotone_chain_plain(*(torch.from_numpy(a)
                                     for a in (t0, t1, w, off)))
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, e.numpy())
    # keep and trim applied to each placement's pos_map leave what the JAX
    # _enforce_monotone leaves (placements whose int32 map is small: its
    # loop is per block, the map a base per w)
    for a, b in zip(off[:-1], off[1:]):
        if b - a > 400 or b == a or w[a:b].sum() > 100_000 \
                or t1[a:b].max() >= I32:
            continue
        pm = blocks_map(t0[a:b], w[a:b])
        want_pm = pm.copy()
        jax_ca._enforce_monotone(want_pm)
        apply_chain(pm, w[a:b], got[3][a:b], got[2][a:b])
        np.testing.assert_array_equal(pm, want_pm)


DATA = {
    # chip_smoke.chain_blocks' ties: narrow spreads, many overlaps
    "ties": lambda rng: chain_blocks(rng, [300, 64, 65, 1, 2, 33, 200],
                                     spread=3, back=0.6),
    # kept weight <= 0 for many pairs, and the ordinary spread
    "overlaps": lambda rng: chain_blocks(rng, [257, 96, 31, 0, 129],
                                         back=0.8),
    "spread": lambda rng: chain_blocks(rng, [400, 7, 160]),
    # every block alike: equal gains on both sides of every block edge
    "equal": lambda rng: (lambda t0, w: (t0, t0 + w, w, np.array(
        [0, 400, 800]))) (np.tile(np.arange(0, 60, 4), 60).astype(
            np.int64)[:800], np.full(800, 6, np.int64)),
}


@pytest.mark.parametrize("B,S", [(1, 1), (2, 3), (32, 1), (32, 3),
                                 (32, 8), (128, 1), (128, 8), (2, 8)])
@pytest.mark.parametrize("kind", sorted(DATA))
def test_blocked_dp_equals_plain(kind, B, S):
    """The blocked DP, at block size B and over S cluster ranks (3
    producer warps each), gives best, parent, trim and keep equal to the
    plain version and, per placement, to JAX's _enforce_monotone."""
    rng = np.random.default_rng(len(kind) * 100 + B + S)
    t0, t1, w, off = DATA[kind](rng)
    got, em, plan = emulate(t0, t1, w, off, B, S, P=3)
    assert not plan.wide
    assert_equals_plain_and_jax(t0, t1, w, off, got)
    if kind in ("ties", "equal"):
        # the first-index rule across a block edge was exercised
        assert em.edge_ties > 0


@pytest.mark.parametrize("S", [1, 3, 8])
def test_blocked_dp_at_the_int32_bounds(S):
    """A placement spanning 2^31 - 1 target bases with a w sum just under
    2^31: chain_plan keeps int32, and every value of the emulated int32
    arithmetic fits (Emulation.fits) while the result equals the plain
    version's."""
    rng = np.random.default_rng(S)
    m = 150
    w = rng.integers(1, (I32 - 1) // m, m).astype(np.int64)
    w[-1] = I32 - 1 - w[:-1].sum()
    t0 = np.sort(rng.integers(0, I32 - 1 - int(w.max()), m)).astype(np.int64)
    t0[0] = 0
    back = np.flatnonzero(rng.random(m) < 0.3)
    back = back[back > 0]
    t0[back] = np.maximum(t0[back - 1] + w[back - 1] // 2, 0)
    t1 = t0 + w
    t1[-1] = I32 - 1
    t0[-1] = t1[-1] - w[-1]
    off = np.array([0, m], np.int64)
    got, _, plan = emulate(t0, t1, w, off, 32, S, P=3)
    assert (plan.wide, plan.exact) == (False, False)
    assert_equals_plain_and_jax(t0, t1, w, off, got)


def test_blocked_dp_wide():
    """Targets past 2^31 in one placement: the plan picks int64 and the
    emulation in int64 equals the plain version."""
    rng = np.random.default_rng(31)
    t0, t1, w, off = chain_blocks(rng, [200, 40], spread=1 << 33)
    got, _, plan = emulate(t0, t1, w, off, 32, 3, P=3)
    assert plan.wide and plan.exact
    assert_equals_plain_and_jax(t0, t1, w, off, got)


def plan_of(t0, t1, w, off):
    return mc.chain_plan(*(torch.as_tensor(np.asarray(a, np.int64))
                           for a in (t0, t1, w, off)), LIMITS)


def test_chain_plan_order_and_paths():
    """Every placement exactly once, longest first (stable on ties), the
    longest past the cluster threshold on clusters, the rest past B on a
    CTA each, m <= B (empty ones too) a warp each."""
    B, thr = LIMITS["rows"], LIMITS["cluster_from"]
    rng = np.random.default_rng(7)
    sizes = np.concatenate([[0, 1, 2, B, B + 1, thr, thr + 1, 3 * thr],
                            rng.integers(0, 3 * B, 40)])
    rng.shuffle(sizes)
    t0, t1, w, off = chain_blocks(rng, sizes)
    plan = plan_of(t0, t1, w, off)
    order = plan.order.numpy()
    assert plan.order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(len(sizes)))
    m = sizes[order]
    assert (np.diff(m) <= 0).all()
    for a, b in zip(order[:-1], order[1:]):     # stable among equal m
        assert sizes[a] != sizes[b] or a < b
    a, b = plan.n_cluster, plan.n_cluster + plan.n_cta
    cl, cta, warp = m[:a], m[a:b], m[b:]
    assert len(cl) + len(cta) + len(warp) == len(sizes)
    assert (cl > thr).all() and len(cl) == (sizes > thr).sum() == 2
    assert (cta <= thr).all() and (cta > B).all()
    assert (warp <= B).all() and len(warp) == (sizes <= B).sum()
    assert plan.max_m == sizes.max()
    assert plan.max_m_cluster == 3 * thr
    assert plan.max_m_cta == thr
    # a batch within 2^31 rebases every placement on its least target
    assert not plan.exact and not plan.wide
    assert (plan.lo.numpy() == min(t0.min(), t1.min())).all()


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("span,wsum,wide", [
    (I32 - 1, 100, False), (I32, 100, True),
    ((1 << 30) + 50, I32 - 1, False), ((1 << 30) + 50, I32, True)])
def test_chain_plan_int32_exactly_below_2_31(span, wsum, wide, far):
    """int32 is chosen exactly when every placement's target span (max of
    t0, t1 less min) and its sum of w are < 2^31: from the whole batch's
    span and w sum when they are (far=False), else placement by placement
    (far=True: a second placement 2^42 away)."""
    w = np.array([wsum // 2, wsum - wsum // 2 - 1, 1], np.int64)
    t0 = np.array([0, 10, span - 1], np.int64)
    t1 = np.array([w[0], 10 + w[1], span], np.int64)
    off = [0, 3]
    if far:
        t0 = np.concatenate([t0, [1 << 42]])
        t1 = np.concatenate([t1, [(1 << 42) + 3]])
        w = np.concatenate([w, [3]])
        off = [0, 3, 4]
    plan = plan_of(t0, t1, w, off)
    assert (plan.wide, plan.exact) == (wide, far or wide)
    lo = plan.lo.numpy()
    assert lo[0] == 0 and (not far or lo[1] == 1 << 42)


def test_chain_plan_batch_past_2_31_placements_within():
    """Two placements each under 2^31 in w sum (and span) whose batch is
    not: decided placement by placement, int32."""
    w = np.full(4, (1 << 30) - 100, np.int64)
    t0 = np.array([0, 50, 7, 50], np.int64)
    plan = plan_of(t0, t0 + w, w, [0, 2, 4])
    assert (plan.wide, plan.exact) == (False, True)
    assert plan.lo.tolist() == [0, 7]


@pytest.mark.parametrize("d", [-1, 0, 1])
@pytest.mark.parametrize("wide", [False, True])
def test_scratch_rows_past_the_clusters_shared_memory(wide, d):
    """A cluster's placement keeps its rows in its CTAs' shared memory up
    to cluster x the CTA's capacity of its type, and needs the scratch
    rows one block past it; a CTA's placements never do (the kernel's
    static_assert: the cluster threshold is within a CTA's capacity)."""
    cap = LIMITS["cluster"] * LIMITS["smem_rows64" if wide else
                                      "smem_rows32"]
    m, thr = cap + d, LIMITS["cluster_from"]
    spread = 1 << 33 if wide else None
    t0, t1, w, off = chain_blocks(np.random.default_rng(cap + d),
                                  [m, thr, 20], spread=spread)
    plan = plan_of(t0, t1, w, off)
    assert (plan.wide, plan.n_cluster, plan.n_cta, plan.n_warp) == (
        wide, 1, 1, 1)
    assert mc.needs_scratch(plan, LIMITS) == (d > 0)
    assert thr <= LIMITS["smem_rows64"]


def test_chain_plan_refuses_w_below_one():
    """The kernel drops gains of -1, which needs every w >= 1 (an
    M-block has at least one base)."""
    with pytest.raises(ValueError, match="w must be >= 1"):
        plan_of([0, 5], [3, 9], [3, 0], [0, 2])


def test_source_limits():
    """The sizes csrc/monotone_chain.cu defines, as the wrapper and the
    smoke read them (ag_monotone_chain_limits reports the same on the
    card): B is a warp, the shared-memory capacities are whole blocks and
    cover the longest placement of the masb workload (18,235 blocks)."""
    lim = LIMITS
    assert lim["rows"] == 32
    assert lim["smem_rows32"] % 32 == 0 and lim["smem_rows64"] % 32 == 0
    assert lim["smem_rows32"] * 8 <= 232_448
    assert lim["smem_rows32"] >= 18_235
    assert 1 <= lim["cluster"] <= 8 and lim["cluster_from"] > lim["rows"]
