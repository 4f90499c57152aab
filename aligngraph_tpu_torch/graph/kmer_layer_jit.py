"""Device-resident read/k-mer-layer graph build in torch: the port of
aligngraph_tpu/graph/kmer_layer_jit.py (C18/C19, `updateGenomeWithRead` +
`updateKMer`, AlignGraph.cpp:1635-1870, 1353-1624).

Same phases and bit-identical results as the host oracle
(graph/kmer_layer.py, the port's copy of aligngraph_tpu/graph/kmer_layer.py)
and the JAX device build (held equal
in tests/test_torch_kmer_layer.py), as eager torch ops on `device`:

  - rows are COMPACT, not dense + masked: boolean masks and `nonzero`
    keep the valid tuples, combo rows and edge candidates in the order the
    JAX build's dense concatenations give them, so every stable sort
    breaks ties as it does there.  No capacity bounds the bridge rows,
    groups or edges, so no chunk ever overflows and nothing is replayed
    through the host oracle.
  - multi-operand stable sorts become one or a few stable `torch.sort`
    passes over int64 words that pack the keys by their runtime ranges
    (`_lex_order`, after kmer_layer._pack_keys).
  - the first-fit merge runs the same K_KM+2 assign/create rounds with no
    host sync inside; `mode="drop"` scatters go to one sentinel row past
    the last position, which the state carries and `_state_to_graph`
    drops.
  - the state is int32 throughout: uint32 arrays travel as their int32
    view (NONE32 is -1 there), so the JAX build's enc/unpk are identities.

A chunk's ops sync with the host where a compaction sizes its output (a
handful per chunk); the graph state stays on the device across chunks and
returns to the GraphTensors once, at the end.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from aligngraph_tpu_torch.config import EP
from aligngraph_tpu_torch.graph.kmer_layer import (
    _COMP, CPM, CPO, KmerBuildStats,
)
from aligngraph_tpu_torch.graph.model import E_ED, K_KM, NONE32, GraphTensors

I32 = torch.int32
I64 = torch.int64
NC = CPO * CPM
# records a chunk of the build takes (the host oracle's default)
CHUNK_RECORDS = 16384
# the largest k-mer the build takes: it packs a k-mer 3 bits a base into
# an int32 key
MAX_K = 10
# the row fields phase 3 needs, and its group-key fields (most-major first)
ROW_FIELDS = ("pos", "arrival", "weight", "contig", "coff", "contig0",
              "coff0", "gpos0", "s_pack", "s_len", "s0")
GROUP_KEYS = ("pos", "contig", "coff", "contig0", "coff0", "gpos0")


def _lex_order(keys):
    """Stable lexicographic order of rows by `keys` (integer tensors of one
    length, most-major first): ties keep row order, as a multi-operand
    stable `lax.sort` does.  Each key is biased by its minimum and the keys
    are bit-packed into as few non-negative int64 words as their runtime
    ranges allow; constant keys drop out.  The words are sorted least-major
    first with stable sorts."""
    n = keys[0].numel()
    dev = keys[0].device
    if n == 0:
        return torch.zeros(0, dtype=I64, device=dev)
    lo_hi = torch.stack([torch.stack([k.min().to(I64), k.max().to(I64)])
                         for k in keys]).tolist()
    words, cur, used = [], None, 0
    for key, (lo, hi) in zip(keys, lo_hi):
        b = (hi - lo).bit_length()
        if b == 0:
            continue
        v = key.to(I64) - lo
        if cur is None or used + b > 63:
            if cur is not None:
                words.append(cur)
            cur, used = v, b
        else:
            cur = (cur << b) | v
            used += b
    if cur is not None:
        words.append(cur)
    order = None
    for w in reversed(words):
        if order is None:
            order = torch.argsort(w, stable=True)
        else:
            order = order[torch.argsort(w[order], stable=True)]
    return order if order is not None else torch.arange(n, device=dev)


def _run_starts(*cols):
    """Bool mask of rows whose value in any of `cols` differs from the
    row before (row 0 always starts a run)."""
    new = torch.ones(cols[0].numel(), dtype=torch.bool, device=cols[0].device)
    if cols[0].numel() > 1:
        diff = torch.zeros_like(new[1:])
        for c in cols:
            diff |= c[1:] != c[:-1]
        new[1:] = diff
    return new


# ----------------------------------------------------------------------
# phase 1: tuple emission (oracle emit_tuples semantics, JAX :53)
# ----------------------------------------------------------------------

def _emit_tuples(p1, p2, s1, lens, keep, k: int, rec0: int = 0):
    """The valid tuples of one chunk, in the order of the JAX build's
    concatenation (stream A cells, stream B cells, stream C bridges, each
    record-major): dict of [T] int32 tensors, `arrival` int64.

    p1, p2: [M, L] int32 part-local positions (-1 unaligned); s1 [M, L]
    int8; lens [M] int32; keep [M] bool.  rec0: the index of the first
    record within its chunk (a rank's slice of the chunk in the sharded
    build), so that arrival orders tuples across the whole chunk."""
    M, L = p1.shape
    Lk = L - k
    dev = p1.device
    i_idx = torch.arange(Lk, dtype=I32, device=dev)[None, :]
    cur = p1[:, :Lk]
    nxt = p1[:, 1:Lk + 1]
    mc = p2[:, :Lk]
    mn = p2[:, 1:Lk + 1]
    in_range = keep[:, None] & (i_idx < (lens - k)[:, None]) & (cur >= 0)

    # next aligned index after i+1 (cummin over the reversed row)
    big = L + 1
    rev = torch.where(p1.flip(1) >= 0,
                      torch.arange(L - 1, -1, -1, dtype=I32,
                                   device=dev)[None, :], big)
    na = torch.cummin(rev, dim=1).values.flip(1)
    na = torch.cat([na, torch.full((M, 2), big, dtype=I32, device=dev)], 1)
    npp = na[:, 2:2 + Lk]
    npp_ok = npp < L
    nppc = npp.clamp(0, L - 1).long()
    tgt = torch.gather(p1, 1, nppc)
    mate_tgt = torch.gather(p2, 1, nppc)

    ordinary = in_range & (nxt == cur + 1)
    deletion = in_range & (nxt >= 0) & (nxt != cur + 1)
    insertion = in_range & (nxt < 0) & npp_ok
    ins_a1 = insertion & (tgt == cur + 1)
    ins_a2 = insertion & (tgt != cur + 1)

    # packed k-mers at every base: 3-bit codes, anything outside 0-4 is 4
    # (the oracle's uint32 `_pack`); 3k <= 30 bits fit int32
    code = s1.to(I32)
    code = torch.where((code < 0) | (code > 4), 4, code)
    pk = torch.zeros((M, Lk + 1), dtype=I32, device=dev)
    for i in range(k):
        pk = (pk << 3) | code[:, i:i + Lk + 1]
    packs = torch.cat([pk, torch.zeros((M, k - 1), dtype=I32, device=dev)],
                      1)

    rec = torch.arange(rec0, rec0 + M, dtype=I64, device=dev)[:, None]
    cell_arr = (rec * L + i_idx) * 4                 # [M, Lk] int64

    ns_len_np = torch.minimum(npp + k, lens[:, None]) - npp
    packs_np = torch.gather(packs, 1, nppc)
    s0_np = torch.gather(s1, 1, nppc).to(I32)
    s0 = s1[:, :Lk].to(I32)
    ns0 = s1[:, 1:Lk + 1].to(I32)

    def full(v):
        return torch.full((M, Lk), v, dtype=I32, device=dev)

    # stream A: one tuple per cell (ordinary|deletion / ins_a1 / ins_a2(i))
    m_od = ordinary | deletion
    sA = dict(
        cur=cur,
        nxt=torch.where(ordinary, cur + 1,
                        torch.where(deletion, nxt, cur + 1)),
        mate_cur=mc,
        mate_nxt=torch.where(m_od, mn, torch.where(ins_a1, mate_tgt, -1)),
        s_pack=packs[:, :Lk],
        s_len=full(k),
        ns_pack=torch.where(m_od, packs[:, 1:Lk + 1],
                            torch.where(ins_a1, packs_np, 0)),
        ns_len=torch.where(m_od, k, torch.where(ins_a1, ns_len_np, 0)),
        s0=s0,
        ns0=torch.where(m_od, ns0, torch.where(ins_a1, s0_np, 4)),
        arrival=cell_arr,
    )
    # stream B: ins_a2 case (iii): (target-1) -> target
    sB = dict(
        cur=tgt - 1, nxt=tgt, mate_cur=full(-1), mate_nxt=mate_tgt,
        s_pack=full(0), s_len=full(0), ns_pack=packs_np, ns_len=ns_len_np,
        s0=full(4), ns0=s0_np, arrival=cell_arr + 2,
    )
    a_idx = (m_od | ins_a1 | ins_a2).reshape(-1).nonzero().squeeze(1)
    b_idx = ins_a2.reshape(-1).nonzero().squeeze(1)

    # stream C: bridge tuples through the intermediate genome positions,
    # cell-major, then by position within the cell
    span = torch.where(ins_a2, (tgt - cur - 2).clamp(min=0), 0).reshape(-1)
    cells = b_idx[span[b_idx] > 0]
    counts = span[cells].long()
    bcell = torch.repeat_interleave(cells, counts)
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(bcell.numel(), dtype=I64, device=dev) - \
        torch.repeat_interleave(first, counts)
    bc = (cur.reshape(-1)[bcell] + 1 + within).to(I32)
    nb = bc.numel()

    def cfull(v):
        return torch.full((nb,), v, dtype=I32, device=dev)

    sC = dict(
        cur=bc, nxt=bc + 1, mate_cur=cfull(-1), mate_nxt=cfull(-1),
        s_pack=cfull(0), s_len=cfull(0), ns_pack=cfull(0), ns_len=cfull(0),
        s0=cfull(4), ns0=cfull(4), arrival=cell_arr.reshape(-1)[bcell] + 1,
    )
    out = {}
    for key in sA:
        out[key] = torch.cat([sA[key].reshape(-1)[a_idx],
                              sB[key].reshape(-1)[b_idx], sC[key]])
        if key != "arrival":
            out[key] = out[key].to(I32)
    return out


# ----------------------------------------------------------------------
# phase 2: anchor-combo expansion (JAX :168)
# ----------------------------------------------------------------------

def _expand(cmpack, n_pos: int, pos, mate, arrival_t, kind: int,
            s_pack, s_len, s0):
    """The valid [CPO x CPM] anchor-combo rows of the tuples for one
    endpoint kind, combo-major then tuple (the JAX build's order).

    cmpack [n_pos, 5] int32 = (cm_cnt, contig0, contig1, coff0, coff1).
    Returns (rows dict of [R] tensors, valid [NC, T] bool grid)."""
    T = pos.numel()
    dev = pos.device
    own = cmpack[pos.clamp(0, n_pos - 1).long()]           # [T, 5]
    mat = cmpack[mate.clamp(0, n_pos - 1).long()]
    c_cm = own[:, 0].clamp(max=CPO)
    m_cm = torch.where(mate >= 0, mat[:, 0].clamp(max=CPM), 0)
    combo = torch.arange(NC, device=dev)[:, None]
    valid = ((combo // CPM < c_cm.clamp(min=1)[None, :])
             & (combo % CPM < m_cm.clamp(min=1)[None, :]))     # [NC, T]
    flat = valid.reshape(-1).nonzero().squeeze(1)
    c, t = (flat // T, flat % T) if T else (flat, flat)
    jj, jj0 = c // CPM, c % CPM
    own_t, mat_t = own[t], mat[t]
    has_own = (c_cm[t] > 0)
    has_mate = (m_cm[t] > 0)
    mate_t = mate[t]

    def col(a, j):
        return torch.gather(a, 1, j[:, None]).squeeze(1)

    rows = dict(
        pos=pos[t],
        arrival=arrival_t[t] * 2 + kind,
        weight=torch.full((t.numel(),), 1 - kind, dtype=I32, device=dev),
        contig=torch.where(has_own, col(own_t, 1 + jj), -1),
        coff=torch.where(has_own, col(own_t, 3 + jj), -1),
        contig0=torch.where(has_mate, col(mat_t, 1 + jj0), -1),
        coff0=torch.where(has_mate, col(mat_t, 3 + jj0), -1),
        gpos0=torch.where(mate_t >= 0, mate_t, -1),
        s_pack=s_pack[t], s_len=s_len[t], s0=s0[t],
    )
    return rows, valid


def _compat(gc, gf, gc0, gf0, gg0, sc, sf, sc0, sf0, sg0, win):
    """Vectorized `compatible()` (kmer_layer._compat_vec semantics)."""
    bad1 = (gc >= 0) & (sc >= 0) & (gc == sc) & ((gf - sf).abs() > 5 * EP)
    bad2 = (gc0 >= 0) & (sc0 >= 0) & (gc0 == sc0) & \
        ((gf0 - sf0).abs() > win)
    bad3 = (gg0 >= 0) & (sg0 >= 0) & ((gg0 - sg0).abs() > win)
    return ~(bad1 | bad2 | bad3)


# ----------------------------------------------------------------------
# phase 3: grouping by the exact anchor signature (JAX :239-299)
# ----------------------------------------------------------------------

def _group(rows):
    """Sort rows by (pos, anchor signature, arrival) and collapse equal
    signatures into groups.  Returns (order: sorted row -> row, gid of
    each sorted row, groups dict: the first-arrival row's fields plus
    summed weight and votes [G, 5])."""
    order = _lex_order([rows[f] for f in GROUP_KEYS] + [rows["arrival"]])
    newg = _run_starts(*[rows[f][order] for f in GROUP_KEYS])
    gid = torch.cumsum(newg, 0) - 1
    rep = order[newg.nonzero().squeeze(1)]          # first-arrival row
    G = rep.numel()
    grp = {f: rows[f][rep] for f in GROUP_KEYS + ("arrival", "s_pack",
                                                   "s_len")}
    w = rows["weight"][order]
    grp["weight"] = torch.zeros(G, dtype=I32, device=w.device) \
        .index_add_(0, gid, w)
    s0 = rows["s0"][order].long()
    voters = ((rows["s_len"][order] > 0) & (w > 0) & (s0 >= 0) & (s0 < 5))
    grp["votes"] = torch.zeros(G * 5, dtype=I32, device=w.device) \
        .index_add_(0, gid * 5 + s0.clamp(0, 4), voters.to(I32)) \
        .view(G, 5)
    return order, gid, grp


# ----------------------------------------------------------------------
# phase 4: first-fit merge, assign/create rounds (JAX :301-404)
# ----------------------------------------------------------------------

def _rounds(state, grp, n_pos: int, win: int):
    """Merge the groups into the slot state in place; returns (slot of
    each group, dropped_slots as a device scalar).  Row n_pos of every
    state array is the sentinel that the masked slot writes go to."""
    G = grp["pos"].numel()
    dev = grp["pos"].device
    gsort = _lex_order([grp["pos"], grp["arrival"]])
    pos_s = grp["pos"][gsort]
    gidx = torch.arange(G, device=dev)
    run_start = torch.cummax(torch.where(_run_starts(pos_s), gidx, 0),
                             0).values
    sgc, sgf, sgc0, sgf0, sgg0, sgw, sgv, sgsp, sgsl = (
        grp[f][gsort] for f in ("contig", "coff", "contig0", "coff0",
                                "gpos0", "weight", "votes", "s_pack",
                                "s_len"))
    posc = pos_s.clamp(0, n_pos - 1).long()
    contig, coff, contig0, coff0, mate = (
        state[f] for f in ("km_contig", "km_coff", "km_contig0", "km_coff0",
                           "km_mate"))
    cov, votes, spk, sln, cnt = (
        state[f] for f in ("km_cov", "km_votes", "km_s", "km_slen",
                           "km_cnt"))
    pending = torch.ones(G, dtype=torch.bool, device=dev)
    slot_s = torch.full((G,), -1, dtype=I64, device=dev)
    dslots = torch.zeros((), dtype=I64, device=dev)
    slots = torch.arange(K_KM, device=dev)[None, :]
    cols = (sgc[:, None], sgf[:, None], sgc0[:, None], sgf0[:, None],
            sgg0[:, None])
    for _ in range(K_KM + 2):
        # (a) every pending group to its first compatible slot
        kc = cnt[posc].long()
        comp = (slots < kc[:, None]) & _compat(
            *cols, contig[posc], coff[posc], contig0[posc], coff0[posc],
            mate[posc], win)                                 # [G, K]
        has = comp.any(1)
        first = torch.zeros(G, dtype=I64, device=dev)
        for s in range(K_KM - 1, -1, -1):
            first = torch.where(comp[:, s], s, first)
        assign = pending & has
        # adds of 0 for the groups not assigned keep every index at its
        # own position: piling them onto the sentinel would serialise
        cell = posc * K_KM + first
        cov.view(-1).index_add_(0, cell, torch.where(assign, sgw, 0))
        votes.view(-1, 5).index_add_(
            0, cell, torch.where(assign[:, None], sgv, 0))
        slot_s = torch.where(assign, first, slot_s)
        pending = pending & ~has
        # drop all pending at capped positions
        at_cap = kc >= K_KM
        dslots += (pending & at_cap).sum()
        pending = pending & ~at_cap
        # (b) the earliest pending group per position creates one slot
        S = torch.cumsum(pending, 0)
        base = S[run_start] - pending[run_start].long()
        creator = pending & ((S - base) == 1)
        cpos = torch.where(creator, posc, n_pos)
        acs = kc.clamp(0, K_KM - 1)
        for arr, val in ((contig, sgc), (coff, sgf), (contig0, sgc0),
                         (coff0, sgf0), (mate, sgg0), (spk, sgsp),
                         (sln, sgsl)):
            arr.index_put_((cpos, acs), val)
        cov.index_put_((cpos, acs), torch.where(creator, sgw, 0))
        votes.index_put_((cpos, acs), torch.where(creator[:, None], sgv, 0))
        cnt.index_add_(0, posc, creator.to(I32))
        slot_s = torch.where(creator, kc, slot_s)
        pending = pending & ~creator
    g_slot = torch.empty(G, dtype=I64, device=dev)
    g_slot[gsort] = slot_s
    return g_slot, dslots


# ----------------------------------------------------------------------
# phase 5: edges (JAX :413-503)
# ----------------------------------------------------------------------

ANCHORS = ("km_contig", "km_coff", "km_contig0", "km_coff0")


def _edge_candidates(tup, valid1, valid2, slot1, slot2):
    """This chunk's edge candidates: one per (k1 row, k2 row) pair of a
    tuple whose rows both got a slot.  Returns (sp, ss, dp, ds, ea) as
    int64 tensors (source position and slot, destination position and
    slot, arrival key) and the [NC, T] grid index (b, t) of each
    candidate's k2 row.

    valid1/valid2: [NC, T] combo grids of the k1/k2 rows; slot1/slot2:
    [NC, T] slot of each valid combo row (-1 elsewhere)."""
    T = tup["cur"].numel()
    rank_a = torch.cumsum(valid1, 0) - 1
    rank_b = torch.cumsum(valid2, 0) - 1
    ev = (slot1 >= 0)[:, None, :] & (slot2 >= 0)[None, :, :]  # [a, b, T]
    flat = ev.reshape(-1).nonzero().squeeze(1)
    ab, t = (flat // T, flat % T) if T else (flat, flat)
    a, b = ab // NC, ab % NC
    sp = tup["cur"][t].long()
    dp = tup["nxt"][t].long()
    ss = slot1[a, t]
    ds = slot2[b, t]
    ea = tup["arrival"][t] * (NC * NC) + rank_a[a, t] * NC + rank_b[b, t]
    return (sp, ss, dp, ds, ea), (b, t)


def _append_edges(state, sp, ss, dp, ds, ea, dst, n_pos: int, win: int):
    """Append the new edges among the candidates to the state in place;
    returns dropped_edges as a device scalar.  Every candidate's source
    position lies in the state's rows [0, n_pos); dst holds the
    destination slots' anchors, one tensor per field of ANCHORS, so the
    destination position need not be in this state."""
    dev = sp.device
    # dedup by (sp, ss, dp, ds), keeping the first arrival
    o = _lex_order([sp, ss, dp, ds, ea])
    u = o[_run_starts(sp[o], ss[o], dp[o], ds[o]).nonzero().squeeze(1)]
    sp, ss, dp, ds, ea = sp[u], ss[u], dp[u], ds[u], ea[u]
    dst = [d[u] for d in dst]

    # the contig-anchor edge gate between the two slot k-mers (no
    # genome-anchor clause, AlignGraph.cpp:1600-1615), then the
    # existing-edge check against prior chunks
    spc = sp.clamp(0, n_pos - 1)
    none = torch.full_like(sp, -1)
    ok = _compat(*(state[f][spc, ss] for f in ANCHORS), none, *dst, none,
                 win)
    ed_cnt, ed_pos, ed_item = (state[f] for f in ("ed_cnt", "ed_pos",
                                                  "ed_item"))
    have = ed_cnt[spc, ss]
    for e in range(E_ED):
        ok &= ~((e < have) & (ed_pos[spc, ss, e] == dp)
                & (ed_item[spc, ss, e] == ds))
    keep = ok.nonzero().squeeze(1)
    sp, ss, dp, ds, ea = sp[keep], ss[keep], dp[keep], ds[keep], ea[keep]

    # append in (sp, ss, arrival) order with per-(pos, slot) run ranks
    o = _lex_order([sp, ss, ea])
    sp, ss, dp, ds = sp[o], ss[o], dp[o], ds[o]
    idx = torch.arange(sp.numel(), device=dev)
    rrank = idx - torch.cummax(torch.where(_run_starts(sp, ss), idx, 0),
                               0).values
    tgt = ed_cnt[sp.clamp(0, n_pos - 1), ss].long() + rrank
    can = tgt < E_ED
    spf = torch.where(can, sp, n_pos)
    tgtc = tgt.clamp(0, E_ED - 1)
    ed_pos.index_put_((spf, ss, tgtc), dp.to(I32))
    ed_item.index_put_((spf, ss, tgtc), ds.to(I32))
    ed_cnt.view(-1).index_add_(0, sp.clamp(0, n_pos - 1) * K_KM + ss,
                               can.to(I32))
    return (~can).sum()


# ----------------------------------------------------------------------
# the per-chunk update
# ----------------------------------------------------------------------

def _emit_rows(cmpack, n_pos: int, p1, p2, s1, lens, keep, k: int,
               rec0: int = 0):
    """Phases 1-2 on one chunk (or a rank's slice of it, records from
    rec0 on): (tuples, rows: the k1 rows then the k2 rows, the [NC, T]
    combo grids valid1 and valid2, the number of k1 rows)."""
    tup = _emit_tuples(p1, p2, s1, lens, keep, k, rec0)
    k1, valid1 = _expand(cmpack, n_pos, tup["cur"], tup["mate_cur"],
                         tup["arrival"], 0, tup["s_pack"], tup["s_len"],
                         tup["s0"])
    k2, valid2 = _expand(cmpack, n_pos, tup["nxt"], tup["mate_nxt"],
                         tup["arrival"], 1, tup["ns_pack"], tup["ns_len"],
                         tup["ns0"])
    rows = {f: torch.cat([k1[f], k2[f]]) for f in ROW_FIELDS}
    return tup, rows, valid1, valid2, k1["pos"].numel()


def _on_grid(vals, valid):
    """Values of the valid combo rows (in their order) spread onto the
    [NC, T] grid `valid`, -1 elsewhere."""
    out = torch.full(valid.shape, -1, dtype=vals.dtype, device=vals.device)
    out[valid] = vals
    return out


def _chunk_update(state, cmpack, p1, p2, s1, lens, keep, *, k: int,
                  win: int, n_pos: int, mark=None):
    """One chunk of records into the device state (in place).  Returns
    (tuples, rows, groups) as ints and (dropped_slots, dropped_edges) as
    device scalars.  mark(name), when given, is called after each phase
    ("emit": emission and expansion, "group", "rounds", "edges")."""
    tup, rows, valid1, valid2, R1 = _emit_rows(cmpack, n_pos, p1, p2, s1,
                                               lens, keep, k)
    if mark:
        mark("emit")

    order, gid, grp = _group(rows)
    if mark:
        mark("group")

    g_slot, dslots = _rounds(state, grp, n_pos, win)
    if mark:
        mark("rounds")

    # slot of every row, spread back onto the [NC, T] combo grids
    row_slot = torch.empty_like(gid)
    row_slot[order] = g_slot[gid]
    cand, _ = _edge_candidates(tup, valid1, valid2,
                               _on_grid(row_slot[:R1], valid1),
                               _on_grid(row_slot[R1:], valid2))
    dpc, ds = cand[2].clamp(0, n_pos - 1), cand[3]
    dedges = _append_edges(state, *cand,
                           [state[f][dpc, ds] for f in ANCHORS], n_pos, win)
    if mark:
        mark("edges")
    return (tup["cur"].numel(), rows["pos"].numel(), grp["pos"].numel(),
            dslots, dedges)


# ----------------------------------------------------------------------
# host driver
# ----------------------------------------------------------------------

STATE_FIELDS = ("km_contig", "km_coff", "km_contig0", "km_coff0", "km_mate",
                "km_cov", "km_votes", "km_s", "km_slen", "km_cnt", "ed_cnt",
                "ed_pos", "ed_item")


def _state_from_graph(g: GraphTensors, device, lo: int = 0,
                      n: Optional[int] = None):
    """Positions [lo, lo + n) (default: all) of g's k-mer and edge arrays
    as int32 tensors of n rows on `device` (uint32 arrays through their
    int32 view, copied straight into the state; narrower ones cross at
    their own width and widen there; rows past g's end are 0), each with
    one sentinel row appended at index n for masked scatters."""
    out = {}
    for f in STATE_FIELDS:
        a = getattr(g, f)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        rows = a.shape[0] - lo if n is None else n
        a = a[lo:lo + rows]
        t = torch.zeros((rows + 1,) + a.shape[1:], dtype=I32, device=device)
        src = torch.from_numpy(a)
        if src.dtype != I32:
            src = src.to(device)
        t[:a.shape[0]].copy_(src)
        out[f] = t
    return out


def state_bytes(n_pos: int) -> int:
    """Device bytes that _state_from_graph and _cmpack allocate for a
    graph of n_pos positions (part_len + overflow_cap): every
    STATE_FIELDS array as int32 with its sentinel row, and the [n_pos, 5]
    int32 anchor pack.  133 + 5 int32 a position, 552 bytes."""
    g = GraphTensors.create(np.zeros(1, np.int8), overflow_cap=1)
    row = sum(int(np.prod(getattr(g, f).shape[1:])) for f in STATE_FIELDS)
    return 4 * (row * (n_pos + 1) + (1 + 2 * CPO) * n_pos)


def _state_to_graph(state, g: GraphTensors) -> None:
    """Write the first rows of the state (those of g's positions: no
    sentinel or padding row) into g's own arrays, in place: each field is
    converted to the array's dtype where the state lies (uint32 arrays
    take the int32 rows through their int32 view) and copied straight
    into the array's memory, so no field exists twice on the host."""
    for f in STATE_FIELDS:
        a = getattr(g, f)
        dst = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                               else a)
        dst.copy_(state[f][:a.shape[0]].to(dst.dtype))


def _cmpack(g: GraphTensors, device) -> torch.Tensor:
    """[n_pos, 5] int32 (cm_cnt, contig0, contig1, coff0, coff1), -1 for
    NONE32, on `device`: the uint32 anchors' int32 view, which is -1 for
    NONE32, built where the tensor lies (no host temporary)."""
    out = torch.empty((g.cm_cnt.shape[0], 1 + 2 * CPO), dtype=I32,
                      device=device)
    out[:, 0] = torch.from_numpy(g.cm_cnt).to(device)
    for j, a in enumerate((g.cm_contig, g.cm_coff)):
        out[:, 1 + j * CPO:1 + (j + 1) * CPO] = torch.from_numpy(
            a.view(np.int32)).to(device)[:, :CPO]
    return out


# ----------------------------------------------------------------------
# phase 0, streamed: normalize_records' rows, a chunk at a time
# ----------------------------------------------------------------------

def _part_local(pm: np.ndarray, part_offset: int, part_len):
    """normalize_records' part-local positions of int32 genome positions:
    -1 where unaligned or outside [0, part_len)."""
    p = np.where(pm >= 0, pm - np.int32(part_offset), np.int32(-1))
    if part_len is not None:
        p = np.where((p >= 0) & (p < part_len), p, np.int32(-1))
    return p


def phase0_skip(pairs, rows: np.ndarray, part_offset: int = 0,
                part_len: Optional[int] = None) -> np.ndarray:
    """[M] bool: normalize_records' duplicate-placement skip over the
    records pairs[rows] (reference :1650-1655), from [M] arrays only: a
    record is dropped when an earlier record of its pair has
    |int32(b - pb)| < len, b the first base's part-local position
    (0xFFFFFFFF when unaligned or outside the part)."""
    M = len(rows)
    keep = np.ones(M, bool)
    if not M:
        return keep
    b = _part_local(pairs.pos_map[rows, 0, 0], part_offset,
                    part_len).astype(np.int64)
    base0 = np.where(b >= 0, b, 0xFFFFFFFF)
    lens = pairs.source_size[rows, 0].astype(np.int64)
    pid = pairs.pair_id[rows]
    order = np.argsort(pid, kind="stable")
    pid_s = pid[order]
    newg = np.ones(M, bool)
    newg[1:] = pid_s[1:] != pid_s[:-1]
    starts = np.nonzero(newg)[0]
    runlen = np.diff(np.concatenate([starts, [M]]))
    rank = np.arange(M) - np.repeat(starts, runlen)
    Rk = int(rank.max()) + 1
    gid = np.cumsum(newg) - 1
    b_d = np.zeros((len(starts), Rk), np.int64)
    l_d = np.zeros((len(starts), Rk), np.int64)
    b_d[gid, rank] = base0[order]
    l_d[gid, rank] = lens[order]
    drop_d = np.zeros((len(starts), Rk), bool)
    for r in range(1, Rk):
        d = (b_d[:, r:r + 1] - b_d[:, :r]) & 0xFFFFFFFF
        d[d >= 2**31] -= 2**32
        drop_d[:, r] = (np.abs(d) < l_d[:, r:r + 1]).any(axis=1)
    keep[order] = ~drop_d[gid, rank]
    return keep


def phase0_rows(pairs, rows: np.ndarray, reads, k: int, skip: np.ndarray,
                s: int, e: int, part_offset: int = 0,
                part_len: Optional[int] = None):
    """Rows [s, e) of normalize_records(pairs[rows], ...): (p1, p2, s1,
    lens, keep) with mate 1 the leftmost, equal in value, as int32 p1,
    p2 [e - s, L] and lens, int8 s1 and bool keep.  skip is
    phase0_skip(pairs, rows, part_offset, part_len); only records
    rows[s:e] are read."""
    r = rows[s:e]
    L = pairs.pos_map.shape[2]
    lens = pairs.source_size[r, 0].astype(np.int32)
    p = _part_local(pairs.pos_map[r], part_offset, part_len)
    fr = pairs.fr[r]
    pid = pairs.pair_id[r]
    col = np.arange(L)[None, :]
    seqs = np.empty((len(r), 2, L), np.int8)
    for mate in (0, 1):
        raw = reads.data[2 * pid + mate]
        if raw.shape[1] < L:
            raw = np.concatenate(
                [raw, np.full((len(r), L - raw.shape[1]), 4, np.int8)], 1)
        # the reverse complement of the length-l prefix, left-aligned
        rc = np.take_along_axis(_COMP[raw[:, ::-1]],
                                np.clip(col + (L - lens)[:, None], 0, L - 1),
                                axis=1)
        rc = np.where(col < lens[:, None], rc, np.int8(4))
        seqs[:, mate] = np.where(fr[:, mate, None] == 1, rc, raw[:, :L])
    keep = (skip[s:e] & (fr[:, 0] != fr[:, 1])
            & (p[:, 0] >= 0).any(axis=1) & (p[:, 1] >= 0).any(axis=1))
    p1, p2 = p[:, 0], p[:, 1]
    # leftmost-mate swap: the first index < len-k where both are aligned
    # decides (reference :1672-1679)
    both = (p1 >= 0) & (p2 >= 0) & (col < (lens - k)[:, None])
    gt, lt = both & (p1 > p2), both & (p1 < p2)
    first_gt = np.where(gt.any(1), gt.argmax(1), L)
    first_lt = np.where(lt.any(1), lt.argmax(1), L)
    swap = (first_gt < first_lt)[:, None]
    return (np.where(swap, p2, p1), np.where(swap, p1, p2),
            np.where(swap, seqs[:, 1], seqs[:, 0]), lens, keep)


def _upload(host, device):
    """phase0_rows' arrays as the tensors `_chunk_update` takes, on
    `device`."""
    return [torch.from_numpy(a).to(device) for a in host]


def build_kmer_layer_device(g: GraphTensors, pairs, reads, k: int,
                            insert_variation: int, part_offset: int = 0,
                            chunk_records: int = CHUNK_RECORDS,
                            stats: Optional[KmerBuildStats] = None, *,
                            device,
                            mark: Optional[Callable[[str], None]] = None,
                            rows: Optional[np.ndarray] = None
                            ) -> KmerBuildStats:
    """Drop-in for kmer_layer.build_kmer_layer with phases 1-5 on
    `device` ("cuda" on the card; "cpu" runs the same ops on the host).

    rows, when given, are the indices of the records of `pairs` to build
    from, in order (the part's accepted records): the build reads them
    through it and copies none of `pairs`.  Phase 0 is streamed: the
    duplicate-placement skip once over the records' [M] arrays
    (phase0_skip), then each chunk's rows (phase0_rows) right before its
    upload, so no [M, L] array of phase 0 exists.

    chunk_records matches the host oracle's default: KmerBuildStats
    (groups, dropped_*) depend on the chunk boundaries, so the pipeline's
    kmer stats stay comparable when toggling cfg.graph_build.

    mark(name), when given, is called after each stage of the build:
    "normalize" (the skip, on the host), "h2d" (the state, then each
    chunk's phase 0 rows and their upload), the phases of
    `_chunk_update`, and "d2h" (the state back in g).  chip_smoke.py
    records a CUDA event there to split the build's time.
    """
    if k > MAX_K:
        raise ValueError(f"k-mer size {k} > {MAX_K}: the 3-bit k-mer "
                         f"packing holds at most {MAX_K} bases")
    st = stats or KmerBuildStats()
    rows = np.arange(pairs.n) if rows is None else np.asarray(rows)
    M = len(rows)
    if M == 0:
        return st
    dev = torch.device(device)
    skip = phase0_skip(pairs, rows, part_offset, g.part_len)
    if mark:
        mark("normalize")
    if pairs.pos_map.shape[2] - k <= 0:
        return st
    # state arrays span part_len + overflow_cap (record positions are
    # always < part_len, but the array axes must agree)
    n_pos = int(g.km_cnt.shape[0])
    assert n_pos < (1 << 30)
    cmpack = _cmpack(g, dev)
    state = _state_from_graph(g, dev)
    if mark:
        mark("h2d")
    win = 2 * insert_variation + 5 * EP
    dropped = torch.zeros(2, dtype=I64, device=dev)
    for s in range(0, M, chunk_records):
        e = min(s + chunk_records, M)
        host = phase0_rows(pairs, rows, reads, k, skip, s, e, part_offset,
                           g.part_len)
        args = _upload(host, dev)
        del host
        if mark:
            mark("h2d")
        tuples, rows_n, groups, dslots, dedges = _chunk_update(
            state, cmpack, *args, k=k, win=win, n_pos=n_pos, mark=mark)
        st.tuples += tuples
        st.rows += rows_n
        st.groups += groups
        dropped[0] += dslots
        dropped[1] += dedges
    _state_to_graph(state, g)
    dslots, dedges = dropped.tolist()
    st.dropped_slots += dslots
    st.dropped_edges += dedges
    if mark:
        mark("d2h")
    return st
