"""The read aligner's compact transfer path on the CPU against the JAX
package, tolerance 0: the device reverse complement and C13 filter, the
dense and per-slot buffers word for word, their torch decoders (fixed
capacities, through the row block and its copy out) field by field
against JAX's host decoders, and ReadAligner.align in the dense, per-slot
and overflow cases."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligngraph_tpu.align import read_aligner as jra
from aligngraph_tpu.align.read_aligner import ReadAligner as JaxAligner
from aligngraph_tpu.config import THRESHOLD, Config
from aligngraph_tpu.io.formalize import Reads
from aligngraph_tpu_torch import ReadAligner
from aligngraph_tpu_torch.align import read_aligner as tra
from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.workload import make_tandem_workload
from tests.simdata import make_simdata, mutate, random_genome, simulate_reads
from tests.test_read_aligner import make_reads
from tests.test_torch_read_aligner import assert_alignments_equal

K = jra.MAX_PAIR_HITS
P = 128                      # one batch of the cases below (64 pairs used)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def indel_reads(seed=21, n_pairs=160, read_len=90):
    """Reads of a target aligned to a reference with 0.15% indels a base,
    so that many records have M-blocks past their first; every fifth
    pair's first mate ends in 45 random bases, so that C13 rejects some
    records that align."""
    rng = np.random.default_rng(seed)
    target = random_genome(rng, 15_000)
    ref = mutate(rng, target, snp_rate=0.01, indel_rate=0.0015)
    r1, r2, _ = simulate_reads(rng, target, n_pairs, read_len=read_len,
                               insert=450, err_rate=0.003)
    for r in r1[::5]:
        r[-45:] = random_genome(rng, 45)

    class Sim:
        reads1, reads2 = r1, r2
    return ref, make_reads(Sim)


def sim_reads(**kw):
    sim = make_simdata(**kw)
    return sim.reference, make_reads(sim)


# name: (genome and reads, Config kwargs, c13)
CASES = {
    # tests/test_read_aligner.py:107 and :198
    "sim11_raw": (partial(sim_reads, seed=11, genome_len=15_000,
                          n_pairs=200, read_len=90, insert=450,
                          snp_rate=0.01),
                  dict(distance_low=150, distance_high=750), False),
    "sim13_c13": (partial(sim_reads, seed=13, genome_len=15_000,
                          n_pairs=150, read_len=90, insert=450,
                          snp_rate=0.02),
                  dict(distance_low=150, distance_high=750), True),
    "indels_c13": (indel_reads, dict(distance_low=150, distance_high=750),
                   True),
}


@pytest.fixture(scope="module")
def batches():
    """Per case: the JAX aligner, the port's, and one batch of 64 pairs
    (start 64) padded to P = 128, with JAX's full layout of it."""
    got = {}
    for name, (make, cfg_kw, c13) in CASES.items():
        genome, reads = make()
        cfg = Config(**cfg_kw)
        jal = JaxAligner.build(genome, cfg, batch_pairs=64, c13=c13)
        pal = ReadAligner.build(genome, cfg, batch_pairs=64, c13=c13,
                                device="cpu")
        L = max(reads.max_len, cfg.seed_len)
        start, cnt = 64, 64
        seqs = np.full((2 * P, L), 4, np.int8)
        plens = np.zeros(P, np.int32)
        seqs[:2 * cnt] = reads.data[2 * start:2 * (start + cnt)]
        plens[:cnt] = reads.lengths[start:start + cnt]
        got[name] = dict(jal=jal, pal=pal, cfg=cfg, c13=c13, L=L,
                         start=start, cnt=cnt, seqs=seqs, plens=plens,
                         full=jax_full(jal, cfg, seqs, plens))
    return got


def jax_full(jal, cfg, seqs, plens) -> dict:
    out = jra._align_pairs_device(
        jal.gwords, jal.index.sorted_kmers, jal.index.sorted_posflip,
        jal.index.bucket_lo, jnp.asarray(seqs), jnp.asarray(plens),
        seed_len=cfg.seed_len, stride=cfg.seed_stride, pad=cfg.band_pad,
        C=cfg.max_candidates, K=K, dlow=cfg.distance_low,
        dhigh=cfg.distance_high, bsteps=jal.index.search_steps,
        sbits=jal.index.suffix_bits, mh=cfg.max_seed_hits, G=jal.glen)
    return {k: np.array(v) for k, v in out.items()}


def jax_buffer(b, dense: bool) -> np.ndarray:
    """JAX's production buffer of the batch (_align_pairs_packed)."""
    jal, cfg, seqs, plens = b["jal"], b["cfg"], b["seqs"], b["plens"]
    u2, nm = jra.pack_reads_np(seqs)
    u2r, nmr = jra.pack_reads_np(jra.revcomp_padded_np(
        seqs, np.repeat(plens, 2)))
    buf = jra._align_pairs_packed(
        jal.gwords, jal.index.sorted_kmers, jal.index.sorted_posflip,
        jal.index.bucket_lo, *(jnp.asarray(a) for a in (u2, nm, u2r, nmr,
                                                         plens)),
        L=b["L"], seed_len=cfg.seed_len, stride=cfg.seed_stride,
        pad=cfg.band_pad, C=cfg.max_candidates, K=K,
        dlow=cfg.distance_low, dhigh=cfg.distance_high,
        bsteps=jal.index.search_steps, sbits=jal.index.suffix_bits,
        c13=b["c13"], dense=dense, mh=cfg.max_seed_hits, G=jal.glen)
    return np.array(buf)


def port_buffer(b, dense: bool) -> np.ndarray:
    """The port's buffer of the batch: revcomp_padded, _align_core,
    compact (C13, then pack_dense or pack_records)."""
    pal, cfg = b["pal"], b["cfg"]
    seqs, plens = torch.from_numpy(b["seqs"]), torch.from_numpy(b["plens"])
    out = tra._align_core(
        pal.genome_p, pal.index, seqs,
        tra.revcomp_padded(seqs, plens.repeat_interleave(2)), plens,
        torch.from_numpy(tra.score_min_table(b["L"])),
        seed_len=cfg.seed_len, stride=cfg.seed_stride, pad=cfg.band_pad,
        C=cfg.max_candidates, K=K, dlow=cfg.distance_low,
        dhigh=cfg.distance_high, mh=cfg.max_seed_hits)
    return tra.compact(out, P, c13=b["c13"], dense=dense).numpy()


def c13_full(b) -> dict:
    """JAX's full layout with its C13 filter applied when the case has
    it (the device filter of _align_pairs_packed)."""
    full = dict(b["full"])
    if b["c13"]:
        full["valid"] = full["valid"] & jra._c13_mask_np(full)
    return full


def assert_dicts_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_dense_equals_jax(batches, case):
    """pack_dense on JAX's full layout equals JAX's _pack_dense word for
    word."""
    full = c13_full(batches[case])
    want = np.array(jra._pack_dense(
        {k: jnp.asarray(v) for k, v in full.items()}, P, K))
    got = tra.pack_dense({k: torch.from_numpy(v) for k, v in full.items()},
                         P, K).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "per_slot"])
def test_buffer_equals_jax_packed(batches, case, dense):
    """The port's whole batch path, from the padded reads to the buffer,
    equals JAX's _align_pairs_packed word for word, in both layouts."""
    b = batches[case]
    want = jax_buffer(b, dense)
    got = port_buffer(b, dense)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # accepted records, and M-blocks past the first where reads cross
    # indels
    n_rec = (got[0] + int((tra.unpack_dense(torch.from_numpy(got), P)
                           ["meta"] & 1).sum()) if dense else got[0])
    assert n_rec > 30
    if case == "indels_c13":
        assert got[1] > 10


def host_records(rec: dict, n, L: int) -> dict:
    """A torch decoder's (fields, n) as the aligner takes them to the
    host: its row block, then the copy of the first n rows out."""
    return tra._copy_out(tra._row_table(rec, n, 0).numpy(), L)


def torch_full(full: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in full.items()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "per_slot"])
def test_expand_equals_jax(batches, case, dense):
    """The port's torch decoders on the CPU, fed JAX's buffer, give JAX's
    records field by field, and so does the torch decode of the full
    layout (_expand_full)."""
    b = batches[case]
    buf = jax_buffer(b, dense)
    args = (b["start"], b["cnt"], b["L"])
    plens = torch.from_numpy(b["plens"])
    if dense:
        want = jra._expand_dense(jra.unpack_dense(buf, P), *args, b["plens"])
        got = tra._expand_dense(tra.unpack_dense(torch.from_numpy(buf), P),
                                *args, plens)
    else:
        want = jra._expand_packed(jra.unpack_records(buf, P), *args,
                                  b["plens"])
        got = tra._expand_packed(
            tra.unpack_records(torch.from_numpy(buf), P), *args, plens)
    got = host_records(*got, b["L"])
    assert_dicts_equal(got, want)
    full = c13_full(b)
    assert_dicts_equal(host_records(*tra._expand_full(torch_full(full),
                                                      *args), b["L"]), want)
    assert_dicts_equal(jra._expand_full(full, *args), want)
    assert len(got["pair_id"]) > 30


def synthetic_full(seed: int, cnt: int, L: int, dense: bool,
                   n_records: int) -> tuple:
    """A full [P, K] layout of random records -> (layout, plens).  About
    0.7 of the P pairs hold a first hit (those past `cnt` too: batch
    padding, which every decoder drops), and further hits are added
    until the buffer's count reaches `n_records`: the extras past each
    pair's first (dense) or all valid slots (per-slot).  A few mates
    have up to four M-blocks, within the segment-overflow capacity; the
    parse quantities follow from the segments."""
    rng = np.random.default_rng(seed)
    S = jra.MAXSEG
    valid = np.zeros((P, K), bool)
    hit = np.nonzero(rng.random(P) < 0.7)[0]
    k0 = rng.integers(0, 2, len(hit))
    valid[hit, k0] = True
    free = [(p, k) for p, f in zip(hit, k0) for k in range(f + 1, K)]
    more = n_records - (0 if dense else len(hit))
    assert 0 <= more <= len(free)
    for i in rng.choice(len(free), more, replace=False):
        valid[free[i]] = True

    segs = np.full((P, K, 2, S, 3), -1, np.int32)
    fr = np.zeros((P, K, 2), np.int8)
    score = np.zeros((P, K, 2), np.int32)
    tgt = np.full((P, K, 2), -1, np.int32)
    budget = (tra.dense_capacities(P)[1] if dense
              else tra.record_capacities(P)[1]) * 3 // 4
    for p, k in zip(*np.nonzero(valid)):
        f = int(rng.integers(0, 2))
        fr[p, k] = (f, 1 - f)
        score[p, k] = rng.integers(10, 200, 2)
        t0 = int(rng.integers(0, 1_000_000))
        for m, base in enumerate((t0, t0 + int(rng.integers(-600, 600)))):
            nseg = 1
            if budget > 0 and rng.random() < 0.3:
                nseg = int(rng.integers(2, 5))
                budget -= nseg - 1
            src, t = int(rng.integers(0, 10)), base
            for s in range(nseg):
                size = int(rng.integers(5, 20))
                segs[p, k, m, s] = (src, t, size)
                gs, gt = [(0, 1), (1, 0), (2, 1), (1, 2)][rng.integers(4)]
                src, t = src + size + gs, t + size + gt
        tgt[p, k] = segs[p, k, :, 0, 1]
    plens = np.where(np.arange(P) < cnt, L, 0).astype(np.int32)

    sz = np.where(segs[..., 2] > 0, segs[..., 2], 0)
    match = sz.sum(-1)
    last = (np.maximum((sz > 0).sum(-1), 1) - 1)[..., None]
    ss = segs[..., 0, 0]
    szl = np.take_along_axis(sz, last, -1)[..., 0]
    se = np.take_along_axis(segs[..., 0], last, -1)[..., 0] + szl
    ins = se - ss - match
    dele = (np.take_along_axis(segs[..., 1], last, -1)[..., 0] + szl
            - tgt - match)
    qlen = np.broadcast_to(plens[:, None, None], ins.shape)
    full = dict(valid=valid, fr=fr, score=score, src_start=ss, src_end=se,
                src_gap=ins, src_size=qlen, tgt_start=tgt,
                tgt_end=tgt + qlen + dele - ins, tgt_gap=dele, segs=segs)
    return {k: np.ascontiguousarray(v, dtype=np.int8 if k == "fr" else
                                    bool if k == "valid" else np.int32)
            for k, v in full.items()}, plens


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["padding", "empty", "at_capacity",
                                  "past_capacity"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "per_slot"])
def test_fixed_capacity_decode_equals_jax(seed, case, dense):
    """The torch decoders at their fixed capacities against JAX's host
    decoders on synthetic buffers: padding pairs past cnt, an empty batch
    (cnt 0), a buffer holding exactly its capacity of records (E2 extras,
    or M slots) and one past it, where the overflow flag is set and the
    full layout's decode takes over."""
    L, start = 100, 4096
    cnt = {"padding": 100, "empty": 0}.get(case, 120)
    cap = (tra.dense_capacities(P)[0] if dense
           else tra.record_capacities(P)[0])
    n_records = {"at_capacity": cap, "past_capacity": cap + 1}.get(
        case, cap // 2)
    full, plens = synthetic_full(seed, cnt, L, dense, n_records)
    if dense:
        buf = np.array(jra._pack_dense(
            {k: jnp.asarray(v) for k, v in full.items()}, P, K))
        want = jra._expand_dense(jra.unpack_dense(buf, P), start, cnt, L,
                                 plens)
        res = tra.unpack_dense(torch.from_numpy(buf), P)
        dec = tra._expand_dense
    else:
        # the port's pack_records equals JAX's per-slot buffer word for
        # word (test_buffer_equals_jax_packed)
        buf = tra.pack_records(torch_full(full), P, K).numpy()
        want = jra._expand_packed(jra.unpack_records(buf, P), start, cnt, L,
                                  plens)
        res = tra.unpack_records(torch.from_numpy(buf), P)
        dec = tra._expand_packed
    assert buf[0] == n_records
    assert bool(res["overflow"]) == (case == "past_capacity")
    got = host_records(*dec(res, start, cnt, L, torch.from_numpy(plens)), L)
    assert_dicts_equal(got, want)
    got_full = host_records(*tra._expand_full(torch_full(full), start, cnt,
                                              L), L)
    assert_dicts_equal(got_full, jra._expand_full(full, start, cnt, L))
    if case != "past_capacity":
        assert_dicts_equal(got, got_full)
    n = len(got_full["pair_id"])
    assert n == 0 if case == "empty" else n >= n_records // 2
    if n:
        assert (got_full["pos_map"] >= 0).sum(-1).max() > 20


def test_revcomp_padded_equals_np():
    rng = np.random.default_rng(8)
    R, L = 64, 23
    seqs = rng.integers(0, 5, (R, L)).astype(np.int8)
    for lens in (rng.integers(0, L + 1, R).astype(np.int32),
                 np.full(R, L, np.int32)):
        lens[:3] = (0, 1, L)
        got = tra.revcomp_padded(torch.from_numpy(seqs),
                                 torch.from_numpy(lens))
        want = jra.revcomp_padded_np(seqs, lens)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_c13_mask_equals_host(batches, case):
    full = batches[case]["full"]
    got = tra.c13_mask({k: torch.from_numpy(v) for k, v in full.items()})
    want = jra._c13_mask_np(full)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_device_c13_equals_host_filter():
    """align(c13=True) equals align(c13=False) and the host ratio_ok
    filter (tests/test_read_aligner.py:198), on the port."""
    genome, reads = indel_reads()
    cfg = Config(distance_low=150, distance_high=750)
    raw = ReadAligner.build(genome, cfg, batch_pairs=64, c13=False,
                            device="cpu").align(reads)
    dev = ReadAligner.build(genome, cfg, batch_pairs=64, c13=True,
                            device="cpu").align(reads)
    keep = np.nonzero(raw.ratio_ok(THRESHOLD))[0]
    assert dev.n == len(keep) > 100 and len(keep) < raw.n
    for f in ("pair_id", "fr", "score", "source_start", "source_end",
              "source_gap", "source_size", "target_start", "target_end",
              "target_gap", "pos_map"):
        np.testing.assert_array_equal(getattr(dev, f),
                                      getattr(raw, f)[keep], err_msg=f)


def block_bytes(rows: int, L: int) -> int:
    """Bytes of a row block of `rows` records at read length L."""
    return 4 * (tra.ROW_HEAD + rows * (19 + 2 * L))


def test_align_reads_one_buffer_a_batch(monkeypatch):
    """Three dense batches (tests/test_read_aligner.py:36's sim): the host
    gets one block of record rows a batch, at the dense capacity (the
    batch's pairs plus E2 extras), and never the full layout's."""
    calls = []
    monkeypatch.setattr(tra, "_expand_full",
                        lambda *a: calls.append(a) or None)
    sim = make_simdata(seed=3, genome_len=20_000, n_pairs=300, read_len=100,
                       insert=500, snp_rate=0.01)
    cfg = Config(distance_low=200, distance_high=800)
    al = ReadAligner.build(sim.reference, cfg, batch_pairs=128,
                           device="cpu")
    res = al.align(make_reads(sim))
    assert res.n > 250 and not calls
    E2 = tra.dense_capacities(128)[0]
    assert al.transfer == dict(dense=3, per_slot=0, overflow=0,
                               host_bytes=sum(block_bytes(cnt + E2, 100)
                                              for cnt in (128, 128, 44)))
    assert set(al.split) == {"wait_s", "copy_out_s", "concat_s"}
    assert all(v >= 0 for v in al.split.values())


def test_long_reads_take_per_slot():
    """Reads of 260 bp (L > 255): the per-slot buffer, equal to JAX."""
    sim = make_simdata(seed=19, genome_len=20_000, n_pairs=150,
                       read_len=260, insert=700, snp_rate=0.01)
    reads = make_reads(sim)
    cfg = Config(distance_low=400, distance_high=1000)
    want = JaxAligner.build(sim.reference, cfg, batch_pairs=64).align(reads)
    al = ReadAligner.build(sim.reference, cfg, batch_pairs=64, device="cpu")
    got = al.align(reads)
    assert_alignments_equal(got, want, 100)
    assert got.pos_map.shape[-1] == 260
    assert al.transfer["per_slot"] == 3
    assert al.transfer["dense"] == al.transfer["overflow"] == 0


@pytest.mark.parametrize("dhigh,layout", [(750, "dense"),
                                          (40_000, "per_slot")])
def test_overflow_equals_jax(monkeypatch, dhigh, layout):
    """The tandem-repeat genome: the first batch overflows its buffer and
    is decoded from its full layout, as JAX's align re-runs it; the
    second takes the buffer.  Every field equal to JAX."""
    genome, data, lens = make_tandem_workload()
    reads = Reads(len(lens), data.shape[1], data, lens)
    cfg = Config(distance_low=150, distance_high=dhigh)
    want = JaxAligner.build(genome, cfg, batch_pairs=1024).align(reads)
    expand_full = tra._expand_full
    calls = []

    def counted(*args):
        calls.append(args[1])
        return expand_full(*args)

    monkeypatch.setattr(tra, "_expand_full", counted)
    al = ReadAligner.build(genome, cfg, batch_pairs=1024, device="cpu")
    got = al.align(reads)
    assert_alignments_equal(got, want, 2000)
    assert calls == [0]
    t = al.transfer
    assert t["overflow"] == 1 and t[layout] == 1
    assert t["dense" if layout == "per_slot" else "per_slot"] == 0
    # the repeat's pairs hold several records each
    assert np.bincount(got.pair_id)[800:1024].max() >= 4


@pytest.mark.parametrize("dhigh,layout", [(750, "dense"),
                                          (40_000, "per_slot")])
def test_enqueue_decode_take_pair_alignments_dtypes(dhigh, layout):
    """_enqueue then _decode on the CPU, batch by batch, on the tandem
    workload: every batch's records come back in PairAlignments' fields,
    dtypes and trailing shapes; the first batch overflows its buffer and
    comes down in a second block of its full layout's records, the
    second takes its layout's block."""
    genome, data, lens = make_tandem_workload()
    reads = Reads(len(lens), data.shape[1], data, lens)
    cfg = Config(distance_low=150, distance_high=dhigh)
    al = ReadAligner.build(genome, cfg, batch_pairs=1024, device="cpu")
    al.transfer = dict(dense=0, per_slot=0, overflow=0, host_bytes=0)
    al.split = dict(wait_s=0.0, copy_out_s=0.0, concat_s=0.0)
    L = max(reads.max_len, cfg.seed_len)
    smin = torch.from_numpy(tra.score_min_table(L))
    empty = PairAlignments.empty(L)
    names = [f.name for f in dataclasses.fields(PairAlignments)]
    for start in (0, 1024):
        batch = al._enqueue(reads, start, 1024, 1024, L, smin,
                            layout == "dense")
        assert batch["event"] is None and batch["blk"].dtype == torch.int32
        rec = al._decode(batch, L)
        blk = batch["blk"].numpy()
        assert list(rec) == names
        n = len(rec["pair_id"])
        assert n > 0 and (rec["pair_id"] >= start).all()
        for f in names:
            want = getattr(empty, f)
            assert rec[f].dtype == want.dtype, f
            assert rec[f].shape == (n,) + want.shape[1:], f
            assert rec[f].flags.c_contiguous, f
            assert not np.shares_memory(rec[f], blk), f
    rows = (1024 + tra.dense_capacities(1024)[0] if layout == "dense"
            else tra.record_capacities(1024)[0])
    assert al.transfer == {
        "dense": int(layout == "dense"), "per_slot": int(layout != "dense"),
        "overflow": 1,
        "host_bytes": 2 * block_bytes(rows, L) + block_bytes(1024 * K, L)}
