"""The benchmark's synthetic samples, made from --seed.

Frozen from aligngraph_tpu_torch/workload.py at commit 5fa5dc4
(make_pipeline_workload and make_misassembly_workload, with mutate_fast,
simulate_pe_reads and cut_contigs_at), with their parameters kept and
the genome, the reference and the reads made in torch on the run's
device, a block of pairs at a time, so that set-up stays short at 30 Mb
and 40x.  The draws are the benchmark's own: a seed gives the same
sample on every run, but not the arrays the port's generators give.

A sample: a random target genome; a reference = target + SNPs + small
indels (the closely related genome that the reads are aligned to); PE
reads of the target, facing each other at a gaussian insert, with
substitution errors; draft contigs cut from the target with gaps a pair
can bridge; and, with chimera_frac > 0, chimeras of two drafts lying far
apart and random junk, the second draft reverse-complemented in every
odd chimera (QUAST's relocations and inversions).
"""

from __future__ import annotations

import numpy as np
import torch

# pairs made on the device at a time
BLOCK_PAIRS = 1 << 18


def generators(seed: int, device) -> tuple:
    """(torch.Generator on `device`, numpy Generator), both from seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    return g, np.random.default_rng(int(seed) % 2**63)


def _randint(g, lo, hi, n, device) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=g, device=device)


def mutate(g, target: torch.Tensor, snp: float, indel: float,
           max_indel: int) -> torch.Tensor:
    """SNPs at rate snp, then indel events at rate indel: a deletion of
    1..max_indel bases from the target or an insertion of as many random
    bases after the event's base, one of each kind in two.  An event
    closer than max_indel + 1 bases to the one before it is dropped, so
    no two overlap."""
    dev, n = target.device, target.numel()
    m = torch.rand(n, generator=g, device=dev) < snp
    shift = _randint(g, 1, 4, n, dev).to(torch.int8)
    out = torch.where(m, (target + shift) % 4, target)
    ev = torch.nonzero(torch.rand(n, generator=g, device=dev) < indel)[:, 0]
    k = ev.numel()
    is_del = torch.rand(k, generator=g, device=dev) < 0.5
    size = _randint(g, 1, max_indel + 1, k, dev)
    keep = torch.ones(k, dtype=torch.bool, device=dev)
    keep[1:] = ev[1:] - ev[:-1] > max_indel
    # no deletion runs past the genome's end
    keep &= ~is_del | (ev + size <= n)
    ev, is_del, size = ev[keep], is_del[keep], size[keep]
    delta = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    d_at, d_size = ev[is_del], size[is_del]
    delta.index_add_(0, d_at, torch.ones_like(d_at, dtype=torch.int32))
    delta.index_add_(0, d_at + d_size,
                     -torch.ones_like(d_at, dtype=torch.int32))
    removed = torch.cumsum(delta, 0)[:n] > 0
    ins = torch.zeros(n, dtype=torch.int64, device=dev)
    ins[ev[~is_del]] = size[~is_del]
    counts = (~removed).to(torch.int64) + ins
    total = int(counts.sum())
    src = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                  output_size=total)
    first = torch.cumsum(counts, 0) - counts
    k_in = torch.arange(total, device=dev) - first[src]
    emit_base = (k_in == 0) & ~removed[src]
    rnd = _randint(g, 0, 4, total, dev).to(torch.int8)
    return torch.where(emit_base, out[src], rnd)


COMP = (3, 2, 1, 0, 4)


def reads(g, target: torch.Tensor, n_pairs: int, read_len: int,
          insert: int, insert_sd: float, err: float) -> tuple:
    """FR pairs: mate 1 forward at s, mate 2 the reverse complement of
    [s + ins - read_len, s + ins), ins gaussian (truncated to an integer,
    clipped to [2 read_len, G - 1]); each base replaced by another at
    rate err -> host (data int8 [2n, read_len] mate-interleaved, lens
    int32 [n])."""
    dev, G = target.device, target.numel()
    comp = torch.tensor(COMP, dtype=torch.int8, device=dev)
    data = np.empty((2 * n_pairs, read_len), np.int8)
    j = torch.arange(read_len, device=dev)
    for s in range(0, n_pairs, BLOCK_PAIRS):
        b = min(BLOCK_PAIRS, n_pairs - s)
        ins = (torch.randn(b, generator=g, device=dev) * insert_sd
               + insert).to(torch.int64).clamp(2 * read_len, G - 1)
        st = (torch.rand(b, generator=g, device=dev, dtype=torch.float64)
              * (G - ins - 1)).to(torch.int64)
        blk = torch.empty((2 * b, read_len), dtype=torch.int8, device=dev)
        blk[0::2] = target[st[:, None] + j]
        blk[1::2] = comp[target[(st + ins - read_len)[:, None] + j]
                         .long()].flip(1)
        e = torch.rand(blk.shape, generator=g, device=dev) < err
        shift = torch.randint(1, 4, blk.shape, generator=g, device=dev,
                              dtype=torch.int8)
        blk = torch.where(e, (blk + shift) % 4, blk)
        data[2 * s:2 * (s + b)] = blk.cpu().numpy()
    return data, np.full(n_pairs, read_len, np.int32)


def cut_drafts(rng, target: np.ndarray, mean_len: int, gap_lo: int,
               gap_hi: int) -> tuple:
    """cut_contigs_at: fragments of mean mean_len (sd mean_len // 3, at
    least 400) separated by gaps of gap_lo..gap_hi -> (seqs, homes)."""
    n = len(target)
    seqs, homes, pos = [], [], 0
    while pos + 500 < n:
        ln = max(400, int(rng.normal(mean_len, mean_len // 3)))
        e = min(pos + ln, n)
        seqs.append(target[pos:e])
        homes.append(pos)
        pos = e + int(rng.integers(gap_lo, gap_hi))
    return seqs, np.array(homes, np.int64)


def chimeras(rng, seqs: list, homes: np.ndarray, frac: float, junk: tuple,
             min_apart: int) -> tuple:
    """make_misassembly_workload's joins: round(frac * drafts / 2)
    chimeras, chimera k = draft i, junk[0]..junk[1] random bases, draft j
    (home at least min_apart from i's), j reverse-complemented in every
    odd k; the chimera takes i's place and j leaves the list -> (drafts,
    the chimeras' places in it)."""
    n_cut = len(seqs)
    n_chim = int(round(frac * n_cut / 2))
    free = np.ones(n_cut, bool)
    joins = []
    for _ in range(n_chim):
        i = int(rng.choice(np.flatnonzero(free)))
        free[i] = False
        far = np.flatnonzero(free & (np.abs(homes - homes[i]) >= min_apart))
        if len(far) == 0:
            raise ValueError(f"no draft lies {min_apart} bases from draft "
                             f"{i}: lower min_apart")
        j = int(rng.choice(far))
        free[j] = False
        joins.append((i, j, int(rng.integers(junk[0], junk[1] + 1))))
    comp = np.array(COMP, np.int8)
    made = {}
    for k, (i, j, jl) in enumerate(joins):
        tail = comp[seqs[j]][::-1] if k % 2 else seqs[j]
        made[i] = np.concatenate(
            [seqs[i], rng.integers(0, 4, jl).astype(np.int8), tail])
    gone = {j for _, j, _ in joins}
    out, places = [], []
    for i in range(n_cut):
        if i in gone:
            continue
        if i in made:
            places.append(len(out))
        out.append(made.get(i, seqs[i]))
    return out, np.array(places, np.int64)


def make_sample(cfg: dict, seed: int, device) -> dict:
    """A sample of the configuration cfg (its "sample" parameters) from
    seed -> dict(target, ref: int8 numpy; data int8 [2n, read_len]; lens
    int32 [n]; drafts: list of int8 numpy; chimera_index int64)."""
    p = cfg["sample"]
    g, rng = generators(seed, device)
    G = int(p["genome_len"])
    target_d = torch.randint(0, 4, (G,), generator=g, device=device,
                             dtype=torch.int8)
    ref = mutate(g, target_d, p["snp"], p["indel"], p["max_indel"])
    n_pairs = int(p["depth"] * G / (2 * p["read_len"]))
    data, lens = reads(g, target_d, n_pairs, p["read_len"], p["insert"],
                       p["insert_sd"], p["read_error"])
    target = target_d.cpu().numpy()
    seqs, homes = cut_drafts(rng, target, p["draft_len"], p["gap_lo"],
                             p["gap_hi"])
    drafts, places = chimeras(rng, seqs, homes, p.get("chimera_frac", 0.0),
                              p.get("junk", (300, 600)),
                              p.get("min_apart", 1_000_000))
    return dict(target=target, ref=ref.cpu().numpy(), data=data, lens=lens,
                drafts=drafts, chimera_index=places)
