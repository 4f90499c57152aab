"""Banded affine-gap local alignment with traceback, plain torch.

Frozen copy of aligngraph_tpu_torch/ops/banded_sw.py at commit 5fa5dc4,
the plain versions only: tensors on any device, CUDA ones included, take
these torch ops and never the port's hand-written kernels.  It imports
nothing of the port, so that later changes to the program are held to
these semantics.

Scoring (bowtie2 --local --mp 3,1 --rdg 2,1 --rfg 2,1 flavour): match
+2, mismatch -3, N -1, a gap of length n costs 2 + n.

posmap is the reference's one entry.  With gapless=True it is the
benchmark's control: every lane takes the best gapless run on its seed
diagonal (score and pos_map) and no lane is given gaps, which breaks the
configurations' guarantee of gapped local alignment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG = -(10**7)

MATCH = 2
MISMATCH = -3
N_PEN = -1
GAP_OPEN = 2
GAP_EXT = 1


class SWResult(NamedTuple):
    score: torch.Tensor    # [B] int32 best local score
    best_i: torch.Tensor   # [B] int32 row (1-based read prefix) of best cell
    best_b: torch.Tensor   # [B] int32 band index of best cell
    tb: torch.Tensor       # [L, B, W] uint8 traceback bits


def traceback_steps(L: int, W: int) -> int:
    """Moves the traceback walk is given: (T // 8 + 1) * 8 with
    T = 2L + W + 2, as the JAX walk's unrolled scan runs."""
    return ((2 * L + W + 2) // 8 + 1) * 8


def _subst(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Substitution score of int32 codes (4 = N or padding)."""
    eq = (r == w) & (r < 4)
    anyn = (r >= 4) | (w >= 4)
    return torch.where(eq, MATCH, torch.where(anyn, N_PEN, MISMATCH)).to(
        torch.int32)


def _first_index(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Lowest index along `dim` where mask holds (size of dim if none)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    return torch.where(mask, idx, n).amin(dim=dim).to(torch.int32)


def gapless_diag(reads, rlens, windows, pad: int):
    """Best gapless local run along the seed diagonal (band b == pad).

    Returns (best [B], start [B], end_incl [B]) as int32, with the DP's own
    tie-breaks: the first best end index, and the last preceding prefix
    minimum (the DP path starts at the last zero-reset)."""
    B, L = reads.shape
    dev = reads.device
    r = reads.to(torch.int32)
    w = windows[:, pad:pad + L].to(torch.int32)
    s = _subst(r, w)
    j = torch.arange(L, dtype=torch.int32, device=dev)
    s = torch.where(j[None, :] < rlens[:, None], s, -(10**6))
    S0 = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                    torch.cumsum(s, dim=1, dtype=torch.int32)], dim=1)
    minpfx = torch.cummin(S0, dim=1).values
    ends = S0[:, 1:] - minpfx[:, :-1]          # best sum ending AT base j
    emax = ends.amax(dim=1)
    best = torch.clamp(emax, min=0)
    ge = _first_index(ends == emax[:, None], 1)
    jj = torch.arange(L + 1, dtype=torch.int32, device=dev)
    vals = torch.where(jj[None, :] <= ge[:, None], S0, 2**30)
    minv = vals.amin(dim=1)
    # start = LAST argmin of S0[0..ge]
    gs = torch.where(vals == minv[:, None], jj[None, :], -1).amax(dim=1)
    return best, gs.to(torch.int32), ge


def _neg(shape, device):
    return torch.full(shape, NEG, dtype=torch.int32, device=device)


def _shift_down(a, s):
    """band-index shift: out[b] = a[b-s] (NEG fill)."""
    B, W = a.shape
    return torch.cat([_neg((B, s), a.device), a[:, :W - s]], dim=1)


def _shift_up(a, s):
    B, W = a.shape
    return torch.cat([a[:, s:], _neg((B, s), a.device)], dim=1)


def banded_sw(reads, rlens, windows, pad: int) -> SWResult:
    """Batched banded local DP.

    reads:   [B, L] int8 codes (pad 4 beyond rlens)
    rlens:   [B] int32
    windows: [B, L + W] int8 where windows[:, x] = genome[g0 - pad + x]
             (caller gathers; out-of-genome = 4)
    pad:     half band; W = 2*pad.
    """
    B, L = reads.shape
    W = 2 * pad
    if windows.shape[1] != L + W:
        raise ValueError(f"windows width {windows.shape[1]} != L + W "
                         f"= {L + W}")
    dev = reads.device
    r32 = reads.to(torch.int32)
    w32 = windows.to(torch.int32)
    Hprev = torch.zeros((B, W), dtype=torch.int32, device=dev)
    Eprev = _neg((B, W), dev)
    best_s = torch.zeros(B, dtype=torch.int32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int32, device=dev)
    best_b = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.empty((L, B, W), dtype=torch.uint8, device=dev)
    for i in range(1, L + 1):
        s = _subst(r32[:, i - 1:i], w32[:, i - 1:i - 1 + W])
        M = Hprev + s
        e_open = _shift_up(Hprev, 1) - (GAP_OPEN + GAP_EXT)
        e_ext = _shift_up(Eprev, 1) - GAP_EXT
        E = torch.maximum(e_open, e_ext)
        e_flag = e_ext > e_open                              # tie -> open
        Hno = torch.clamp(torch.maximum(M, E), min=0)
        G = Hno - GAP_OPEN
        sh = 1
        while sh < W:
            G = torch.maximum(G, _shift_down(G, sh) - GAP_EXT * sh)
            sh *= 2
        F = _shift_down(G, 1) - GAP_EXT
        H = torch.maximum(Hno, F)
        f_open = _shift_down(Hno, 1) - (GAP_OPEN + GAP_EXT)
        f_flag = F > f_open                                  # tie -> open
        choice = torch.where(
            H == 0, 0, torch.where(M == H, 1, torch.where(E == H, 2, 3)))
        tb[i - 1] = (choice | (e_flag.to(torch.int32) << 2)
                     | (f_flag.to(torch.int32) << 3)).to(torch.uint8)
        # best-cell tracking (score desc, i asc, b asc), masked by read len
        Hm = torch.where((i <= rlens)[:, None], H, NEG)
        row_best = Hm.amax(dim=1)
        row_arg = _first_index(Hm == row_best[:, None], 1)
        upd = row_best > best_s
        best_s = torch.where(upd, row_best, best_s)
        best_i = torch.where(upd, i, best_i)
        best_b = torch.where(upd, row_arg, best_b)
        Hprev, Eprev = H, E
    return SWResult(best_s, best_i, best_b, tb)


def sw_traceback(tb, best_i, best_b, g0, pad: int):
    """Walk traceback bits -> per-read-base genome position map.

    tb: [L, B, W] uint8; best_i/best_b: [B]; g0: [B] int32 genome position
    aligned to read base 0 on the candidate diagonal.
    Returns pos_map [B, L] int32 (global genome position per read base,
    -1 where unaligned).
    """
    L, B, W = tb.shape
    dev = tb.device
    tb_flat = tb.permute(1, 0, 2).reshape(B, L * W)
    i = best_i.to(torch.int32)
    b = best_b.to(torch.int32)
    phase = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    # column L collects the non-diag moves and is dropped at the end
    # (each read base is written at most once: diag moves decrement i)
    pm = torch.full((B, L + 1), -1, dtype=torch.int32, device=dev)
    for _ in range(traceback_steps(L, W)):
        inb = active & (i >= 1) & (b >= 0) & (b < W)
        idx = torch.clamp((i - 1) * W + b, 0, L * W - 1)
        byte = torch.gather(tb_flat, 1, idx.long()[:, None])[:, 0].to(
            torch.int32)
        choice = byte & 3
        e_ext = (byte >> 2) & 1
        f_ext = (byte >> 3) & 1
        in_h = inb & (phase == 0)
        in_e = inb & (phase == 1)
        in_f = inb & (phase == 2)
        stop = in_h & (choice == 0)
        diag = in_h & (choice == 1)
        to_e = in_h & (choice == 2)
        to_f = in_h & (choice == 3)
        # diag: emit read base i-1 -> genome g0 + (i-1) + b - pad
        gpos = g0 + (i - 1) + b - pad
        wr = torch.where(diag, i - 1, L)
        pm.scatter_(1, wr.long()[:, None], gpos[:, None])
        i = torch.where(diag | in_e, i - 1, i)
        b = torch.where(in_e, b + 1, torch.where(in_f, b - 1, b))
        phase = torch.where(
            to_e | (in_e & (e_ext == 1)), 1,
            torch.where(to_f | (in_f & (f_ext == 1)), 2, 0)).to(torch.int32)
        active = active & ~stop & inb
    return pm[:, :L].contiguous()


def synth_posmap(score, need, gs, ge, g0, L: int):
    """pos_map of the lanes whose banded score an ungapped run on the seed
    diagonal attains: read bases gs..ge map to g0 + j, the rest to -1."""
    j = torch.arange(L, dtype=torch.int32, device=score.device)
    syn_on = ((~need)[:, None] & (score > 0)[:, None]
              & (j[None, :] >= gs[:, None]) & (j[None, :] <= ge[:, None]))
    return torch.where(syn_on, g0[:, None] + j[None, :], -1)


def traceback_need(score, gapless_best, smin: Optional[torch.Tensor]):
    """Lanes whose pos_map needs the traceback walk: the banded score beats
    the gapless diagonal run, and (when given) reaches the acceptance floor
    `smin` (lanes below it are filtered downstream)."""
    need = score > gapless_best
    if smin is not None:
        need = need & (score >= smin)
    return need


def banded_sw_posmap_plain(reads, rlens, windows, g0, pad: int, smin=None):
    """DP + traceback -> (score [B], pos_map [B, L]) in plain torch ops.

    Lanes whose banded score an ungapped run on the seed diagonal attains
    get their pos_map synthesized (one iota range); the rest take the
    traceback walk (all lanes are walked here; the select keeps the
    semantics of the kernel path, which walks only the lanes in need)."""
    res = banded_sw(reads, rlens, windows, pad=pad)
    pm_tb = sw_traceback(res.tb, res.best_i, res.best_b, g0, pad=pad)
    gb, gs, ge = gapless_diag(reads, rlens, windows, pad)
    need = traceback_need(res.score, gb, smin)
    pm_syn = synth_posmap(res.score, need, gs, ge, g0, reads.shape[1])
    return res.score, torch.where(need[:, None], pm_tb, pm_syn)


def posmap(reads, rlens, windows, g0, pad: int, smin=None, *,
           gapless: bool = False):
    """-> (score [B], pos_map [B, L]): banded_sw_posmap_plain, or with
    gapless the control (see the module's docstring)."""
    if not gapless:
        return banded_sw_posmap_plain(reads, rlens, windows, g0, pad=pad,
                                      smin=smin)
    gb, gs, ge = gapless_diag(reads, rlens, windows, pad)
    none = torch.zeros(gb.shape, dtype=torch.bool, device=gb.device)
    return gb, synth_posmap(gb, none, gs, ge, g0, reads.shape[1])
