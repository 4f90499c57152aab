"""The host memory of the port's big-genome path, on the CPU: phase 0 of
the device k-mer build (kmer_layer_jit.phase0_skip, and per chunk
phase0_gather on the host then phase0_rows on the device, here "cpu")
against normalize_records, the JAX package's and the port's host copy;
the build fed by the indices of a part's accepted records against the
host oracle fed by their copy, its marks in order; the state's download
into the
graph's own arrays; and run_pipeline's lifetimes: the seed index and the
aligners are gone before the first part's graph is made, each part's
graph before the next one's; and scripts/contig_placements.py, which
holds the two packages' per-part contig placements to each other.
Tolerance 0 throughout."""

import dataclasses
import types
import weakref

import numpy as np
import pytest
import torch

from aligngraph_tpu.align.types import PairAlignments as JPairs
from aligngraph_tpu.graph.kmer_layer import normalize_records as j_normalize
from aligngraph_tpu.io.formalize import Reads as JReads
from aligngraph_tpu_torch import bigscale
from aligngraph_tpu_torch.align.read_aligner import ReadAligner
from aligngraph_tpu_torch.align.types import PairAlignments
from aligngraph_tpu_torch.config import THRESHOLD, Config
from aligngraph_tpu_torch.graph import kmer_layer_jit as kj
from aligngraph_tpu_torch.graph.kmer_layer import (build_kmer_layer,
                                                   normalize_records)
from aligngraph_tpu_torch.graph.model import NONE32, GraphTensors
from aligngraph_tpu_torch.io.formalize import Reads
from aligngraph_tpu_torch.pipeline import driver
from aligngraph_tpu_torch.utils import heap
from tests.simdata import make_simdata
from tests.test_kmer_jit import KM_FIELDS

CFG = Config(distance_low=300, distance_high=700)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synthetic_records(seed: int, n_pairs: int = 40, L: int = 24,
                      read_w: int = 20, per_max: int = 4):
    """Records of n_pairs pairs, 1 to per_max records a pair in runs (so
    a pair's records straddle chunk boundaries), reads of read_w < L
    bases, source sizes 9..L, positions on [0, 8000) with unaligned runs,
    near and across the part [1000, 6000), and both strands; a pair's
    later records sometimes repeat an earlier one's first base within its
    length, so the duplicate-placement skip drops some."""
    rng = np.random.default_rng(seed)
    per = rng.integers(1, per_max + 1, n_pairs)
    pid = np.repeat(np.arange(n_pairs, dtype=np.int32), per)
    M = len(pid)
    start = rng.integers(0, 8000, M)
    dup = np.nonzero((pid[1:] == pid[:-1]) & (rng.random(M - 1) < 0.5))[0]
    start[dup + 1] = start[dup] + rng.integers(-5, 6, len(dup))
    pm = np.empty((M, 2, L), np.int32)
    for mate in (0, 1):
        off = start + mate * rng.integers(200, 600, M)
        pm[:, mate] = off[:, None] + np.arange(L)[None, :]
    pm[rng.random((M, 2, L)) < 0.15] = -1
    pm[rng.random(M) < 0.1, 0, 0] = -1
    fr = rng.integers(0, 2, (M, 2)).astype(np.int8)
    fr[:, 1] = np.where(rng.random(M) < 0.85, 1 - fr[:, 0], fr[:, 1])
    size = rng.integers(9, L + 1, (M, 2)).astype(np.int32)
    z = np.zeros((M, 2), np.int32)
    pairs = PairAlignments(pair_id=pid, fr=fr, score=z, source_start=z,
                           source_end=size, source_gap=z, source_size=size,
                           target_start=pm[:, :, 0].copy(),
                           target_end=pm[:, :, -1].copy(), target_gap=z,
                           pos_map=pm)
    data = rng.integers(0, 5, (2 * n_pairs, read_w)).astype(np.int8)
    reads = Reads(n_pairs, read_w, data, np.full(n_pairs, read_w, np.int32))
    return pairs, reads


def streamed_phase0(pairs, rows, reads, k, chunk, off, plen):
    """build_kmer_layer_device's phase 0 on "cpu": the skip, then each
    chunk of `chunk` records gathered on the host and its rows computed
    -> the chunks' (p1, p2, s1, lens, keep) concatenated, as numpy."""
    skip = kj.phase0_skip(pairs, rows, off, plen, device="cpu")
    got = []
    for s in range(0, len(rows), chunk):
        e = min(s + chunk, len(rows))
        got.append(kj.phase0_rows(
            *kj.phase0_gather(pairs, rows, reads, s, e, device="cpu"),
            skip[s:e], k, off, plen))
    return [torch.cat([c[i] for c in got]).numpy() for i in range(5)]


@pytest.mark.parametrize("chunk", [1, 7, 16_384])
def test_phase0_rows_equal_normalize_records(chunk):
    """Phase 0 on "cpu" (phase0_skip, then phase0_gather and phase0_rows
    over chunks of `chunk` records) gives normalize_records' rows (the
    port's host copy and the JAX package's), for all records and for an
    index subset of them, clipped to a part and not."""
    pairs, reads = synthetic_records(chunk)
    k = 5
    every = np.arange(pairs.n)
    some = np.sort(np.random.default_rng(chunk).choice(
        pairs.n, pairs.n * 2 // 3, replace=False))
    jreads = JReads(reads.n_pairs, reads.max_len, reads.data, reads.lengths)
    for rows in (every, some):
        sub = driver._subset_pairs(pairs, rows)
        jsub = JPairs(**{f.name: getattr(sub, f.name)
                         for f in dataclasses.fields(sub)})
        for off, plen in ((1000, 5000), (0, None)):
            want = normalize_records(sub, reads, k, off, plen)
            jwant = j_normalize(jsub, jreads, k, off, plen)
            got = streamed_phase0(pairs, rows, reads, k, chunk, off, plen)
            for i, name in enumerate(("p1", "p2", "s1", "lens", "keep")):
                np.testing.assert_array_equal(got[i], want[i], err_msg=name)
                np.testing.assert_array_equal(got[i], jwant[i],
                                              err_msg=name)
            assert 0 < want[4].sum() < len(rows)      # some dropped
    assert (~kj.phase0_skip(pairs, every, device="cpu")).any()  # it fires


def skip_loop(pairs, off, plen):
    """The reference's duplicate-placement skip record by record
    (AlignGraph.cpp:1650-1655): a record is dropped when any earlier
    record of its pair has |int32(b - pb)| < len, b the first base's
    part-local position, 0xFFFFFFFF when unaligned or outside the part."""
    def base(i):
        b = int(pairs.pos_map[i, 0, 0])
        b = b - off if b >= 0 else -1
        ok = b >= 0 and (plen is None or b < plen)
        return b if ok else 0xFFFFFFFF

    keep, seen = [], {}
    for i in range(pairs.n):
        b, ln = base(i), int(pairs.source_size[i, 0])
        prev = seen.setdefault(int(pairs.pair_id[i]), [])
        d = [((b - pb) & 0xFFFFFFFF) for pb in prev]
        keep.append(not any(abs(x - 2**32 if x >= 2**31 else x) < ln
                            for x in d))
        prev.append(b)
    return np.array(keep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase0_skip_equals_normalize_records(seed):
    """phase0_skip on "cpu" with up to 8 records a pair, unaligned first
    bases (0xFFFFFFFF: a record just inside the part after one of them is
    within len of it once wrapped) and positions on both sides of the
    part: equal to the reference's record-by-record skip, and with the
    orientation and part tests to JAX's normalize_records keep mask."""
    pairs, reads = synthetic_records(100 + seed, n_pairs=60, per_max=8)
    rng = np.random.default_rng(seed)
    off, plen = 1000, 5000
    later = np.nonzero(pairs.pair_id[1:] == pairs.pair_id[:-1])[0] + 1
    unal = later[rng.random(len(later)) < 0.3]
    pairs.pos_map[unal - 1, 0, 0] = -1
    # the base wraps: 0xFFFFFFFF then part-local 0..3, within len
    pairs.pos_map[unal, 0, 0] = off + rng.integers(0, 4, len(unal))
    pairs.pos_map[unal[::2], 0, 0] = -1         # both unaligned: d = 0
    jpairs = JPairs(**{f.name: getattr(pairs, f.name)
                       for f in dataclasses.fields(pairs)})
    jreads = JReads(reads.n_pairs, reads.max_len, reads.data, reads.lengths)
    every = np.arange(pairs.n)
    for o, pl in ((off, plen), (0, None)):
        skip = kj.phase0_skip(pairs, every, o, pl, device="cpu")
        assert skip.dtype == torch.bool and skip.shape == (pairs.n,)
        want = skip_loop(pairs, o, pl)
        np.testing.assert_array_equal(skip.numpy(), want)
        p = np.where(pairs.pos_map >= 0, pairs.pos_map - o, -1)
        if pl is not None:
            p = np.where((p >= 0) & (p < pl), p, -1)
        jkeep = j_normalize(jpairs, jreads, 5, o, pl)[4]
        np.testing.assert_array_equal(
            skip.numpy() & (pairs.fr[:, 0] != pairs.fr[:, 1])
            & (p[:, 0] >= 0).any(1) & (p[:, 1] >= 0).any(1), jkeep)
        assert (~want[unal]).sum() >= len(unal) // 2    # the wrap drops
    assert np.bincount(pairs.pair_id).max() > 4


def test_phase0_rows_take_chunk_update_dtypes():
    """phase0_gather and phase0_rows give, on the device they were given,
    exactly what _chunk_update takes: int32 p1, p2 [c, L], int8 s1
    [c, L], int32 lens [c], bool keep [c]; with reads narrower than L
    padded with code 4 past them, and an empty chunk as empty tensors."""
    pairs, reads = synthetic_records(3)
    L, dev = pairs.pos_map.shape[2], torch.device("cpu")
    rows = np.arange(pairs.n)
    skip = kj.phase0_skip(pairs, rows, 1000, 5000, device=dev)
    for s, e in ((0, 9), (5, 5)):
        got = kj.phase0_gather(pairs, rows, reads, s, e, device=dev)
        assert [t.shape for t in got] == [(e - s, 2, L), (e - s,),
                                          (e - s, 2), (e - s, 2, 20)]
        out = kj.phase0_rows(*got, skip[s:e], 5, 1000, 5000)
        want = [(torch.int32, (e - s, L)), (torch.int32, (e - s, L)),
                (torch.int8, (e - s, L)), (torch.int32, (e - s,)),
                (torch.bool, (e - s,))]
        assert [(t.dtype, tuple(t.shape)) for t in out] == want
        assert all(t.device == dev for t in out)
    # forward mates carry the read as it is, then code 4 past it
    p1, p2, s1, lens, keep = kj.phase0_rows(
        *kj.phase0_gather(pairs, rows, reads, 0, pairs.n, device=dev),
        skip, 5, 1000, 5000)
    fwd = (pairs.fr[:, 0] == 0) & (pairs.fr[:, 1] == 0)
    assert fwd.any()
    assert (s1.numpy()[fwd][:, 20:] == 4).all()


@pytest.fixture(scope="module")
def aligned():
    """A 20 kb sim's records from the port's CPU read aligner, all of them
    (the C13 filter as indices, as run_pipeline keeps them)."""
    sim = make_simdata(seed=31, genome_len=20_000, n_pairs=900,
                       read_len=100, insert=500, n_contigs=8,
                       snp_rate=0.01, err_rate=0.003)
    data = np.empty((2 * 900, 100), np.int8)
    data[0::2] = np.stack(sim.reads1)
    data[1::2] = np.stack(sim.reads2)
    reads = Reads(900, 100, data, np.full(900, 100, np.int32))
    rali = ReadAligner.build(sim.reference, CFG, batch_pairs=1024,
                             device="cpu").align(reads)
    return sim.reference, rali, reads


def part_graph(ref, lo, hi, anchors: bool):
    g = GraphTensors.create(ref[lo:hi])
    if anchors:       # 0-3 seeded ContiMers a position, two contig ids
        rng = np.random.default_rng(lo)
        P, S = g.cm_contig.shape
        cnt = np.minimum(rng.choice(4, P, p=[0.3, 0.3, 0.3, 0.1]), S)
        live = np.arange(S)[None, :] < cnt[:, None]
        off = np.arange(P)[:, None] + rng.choice([0, 30, -30, 130], (P, S))
        g.cm_cnt[:] = cnt
        g.cm_contig[:] = np.where(live, rng.integers(0, 2, (P, S)), NONE32)
        g.cm_coff[:] = np.where(live, off.clip(0), NONE32)
    return g


@pytest.mark.parametrize("part,chunk,anchors", [(0, 16_384, False),
                                                (1, 97, True)])
def test_device_build_from_rows_equals_oracle(aligned, part, chunk,
                                              anchors):
    """build_kmer_layer_device fed the part's accepted records as indices
    into all records (rows=) equals the host oracle fed their copy
    (_subset_pairs): all 13 arrays and the stats."""
    ref, rali, reads = aligned
    lo, hi = (0, 10_000) if part == 0 else (10_000, len(ref))
    acc = np.flatnonzero(rali.ratio_ok(THRESHOLD))
    ts = rali.target_start[acc]
    rows = acc[(ts[:, 0] >= lo) & (ts[:, 0] < hi)
               & (ts[:, 1] >= lo) & (ts[:, 1] < hi)]
    assert 0 < len(rows) < rali.n
    g_host, g_dev = part_graph(ref, lo, hi, anchors), \
        part_graph(ref, lo, hi, anchors)
    st_host = build_kmer_layer(g_host, driver._subset_pairs(rali, rows),
                               reads, CFG.k_mer, CFG.insert_variation,
                               part_offset=lo, chunk_records=chunk)
    st_dev = kj.build_kmer_layer_device(
        g_dev, rali, reads, CFG.k_mer, CFG.insert_variation,
        part_offset=lo, chunk_records=chunk, device="cpu", rows=rows)
    for f in KM_FIELDS:
        a, b = getattr(g_dev, f), getattr(g_host, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert dataclasses.asdict(st_dev) == dataclasses.asdict(st_host)
    assert st_dev.tuples > 1000


def test_device_build_marks_in_order(aligned):
    """build_kmer_layer_device(..., device="cpu", rows=) over part 1's
    accepted records in chunks of 150 equals the host oracle, all 13
    arrays and the stats, and calls its marks in order: the skip, the
    state, then each chunk's gather, phase 0 rows and update phases, then
    the state back."""
    ref, rali, reads = aligned
    lo, hi = 10_000, len(ref)
    acc = np.flatnonzero(rali.ratio_ok(THRESHOLD))
    ts = rali.target_start[acc]
    rows = acc[(ts[:, 0] >= lo) & (ts[:, 0] < hi)
               & (ts[:, 1] >= lo) & (ts[:, 1] < hi)]
    g_host, g_dev = part_graph(ref, lo, hi, True), part_graph(ref, lo, hi,
                                                               True)
    st_host = build_kmer_layer(g_host, driver._subset_pairs(rali, rows),
                               reads, CFG.k_mer, CFG.insert_variation,
                               part_offset=lo, chunk_records=150)
    marks = []
    st_dev = kj.build_kmer_layer_device(
        g_dev, rali, reads, CFG.k_mer, CFG.insert_variation,
        part_offset=lo, chunk_records=150, device="cpu", rows=rows,
        mark=marks.append)
    for f in KM_FIELDS:
        np.testing.assert_array_equal(getattr(g_dev, f), getattr(g_host, f),
                                      err_msg=f)
    assert dataclasses.asdict(st_dev) == dataclasses.asdict(st_host)
    n = -(-len(rows) // 150)
    assert n > 1
    assert marks == ["normalize", "h2d"] + [
        "gather", "phase0", "emit", "group", "rounds", "edges"] * n + ["d2h"]


def test_state_to_graph_in_place():
    """_state_to_graph writes every field into g's own array (the same
    object) with the values the state holds, wrapped to the field's
    dtype as a conversion would."""
    g = GraphTensors.create(np.zeros(3_000, np.int8))
    arrays = {f: getattr(g, f) for f in kj.STATE_FIELDS}
    state = kj._state_from_graph(g, "cpu")
    rng = np.random.default_rng(0)
    for t in state.values():
        t.copy_(torch.from_numpy(rng.integers(
            -2**31, 2**31, t.shape, dtype=np.int64).astype(np.int32)))
    kj._state_to_graph(state, g)
    for f, a in arrays.items():
        assert getattr(g, f) is a, f
        want = state[f][:a.shape[0]].numpy()
        want = want.view(np.uint32) if a.dtype == np.uint32 else \
            want.astype(a.dtype)
        np.testing.assert_array_equal(a, want, err_msg=f)


def test_cmpack_equals_anchor_conversion():
    """_cmpack's int32 views give the anchors of the int64 conversion:
    NONE32 to -1, anchors of 2**31 and above wrapped."""
    g = GraphTensors.create(np.zeros(500, np.int8))
    rng = np.random.default_rng(1)
    g.cm_cnt[:] = rng.integers(0, 5, g.cm_cnt.shape)
    for a in (g.cm_contig, g.cm_coff):
        a[:] = rng.choice([0, 7, 2**31 - 1, 2**31, 2**32 - 2, NONE32],
                          a.shape)
    got = kj._cmpack(g, "cpu").numpy()

    def anchors(a):
        return np.where(a[:, :2] == NONE32, -1,
                        a[:, :2].astype(np.int64)).astype(np.int32)

    want = np.concatenate([g.cm_cnt[:, None].astype(np.int32),
                           anchors(g.cm_contig), anchors(g.cm_coff)], 1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_host_bytes_counts_each_array_once():
    a = np.zeros((100, 10), np.int32)
    t = torch.zeros(50, dtype=torch.int64)
    obj = {"x": a, "y": (a[3:], "text"), "z": [a.T, {"t": t, "u": t[1:]}]}
    assert heap.host_bytes(obj) == a.nbytes + t.nbytes
    assert heap.host_bytes(None) == 0
    assert heap.rss_bytes() > 0
    assert heap.heap_in_use_bytes() is None or heap.heap_in_use_bytes() > 0


def test_pipeline_frees_each_stage(tmp_path, monkeypatch):
    """run_pipeline at 0.3 Mb, --part 2 (bigscale.run on the CPU): the
    seed index and the aligners are collected before part 1's graph is
    made, part 1's graph before part 2's; each stage records its RSS, the
    live heap and the named arrays, phase 0's bytes the larger of the
    skip's gathers and one chunk's gathered rows, and the records are gone
    before refinement."""
    refs = {"graph": [], "aligner": []}
    seen = []

    def watch(kind, obj):
        refs[kind].append(weakref.ref(obj))
        return obj

    def create(*args, **kw):
        seen.append({k: [r() is None for r in v] for k, v in refs.items()})
        return watch("graph", GraphTensors.create(*args, **kw))

    index_from = ReadAligner.from_index
    monkeypatch.setattr(driver, "GraphTensors",
                        types.SimpleNamespace(create=create))
    monkeypatch.setattr(driver, "ReadAligner", types.SimpleNamespace(
        from_index=lambda *a, **kw: watch("aligner", index_from(*a, **kw))))
    build_index, ctg = driver.build_index, driver.ContigAligner
    monkeypatch.setattr(driver, "build_index", lambda *a, **kw: watch(
        "aligner", build_index(*a, **kw)))
    monkeypatch.setattr(driver, "ContigAligner", lambda *a, **kw: watch(
        "aligner", ctg(*a, **kw)))
    line1, _, ctx = bigscale.run(0.3, 5, 2, device="cpu",
                                 work_dir=str(tmp_path))
    del ctx
    # index, read aligner, one contig aligner a part; two graphs
    assert len(refs["aligner"]) == 4 and len(refs["graph"]) == 2
    assert seen == [{"graph": [], "aligner": [True] * 4},
                    {"graph": [True], "aligner": [True] * 4}]
    mem = line1["stage_memory"]
    for stage, m in mem.items():
        assert m["host_rss_bytes"] > 0 and m["arrays"]["reads"] > 0, stage
        assert m["host_heap_bytes"] is None or m["host_heap_bytes"] > 0
    assert "index" not in mem["alignment"]["arrays"]
    assert set(mem["kmer_build.1"]["arrays"]) == {
        "reads", "rali", "rali_pos_map", "cali", "graph", "part_rows",
        "phase0"}
    n = mem["kmer_build.1"]["arrays"]["part_rows"] // 8
    assert mem["kmer_build.1"]["arrays"]["phase0"] == max(
        12 * n, min(n, 16_384) * (2 * 4 * 100 + 2 * 100 + 4 + 4 + 2))
    assert "rali_pos_map" not in mem["refinement"]["arrays"]



def test_contig_placements_agree(capsys):
    """scripts/contig_placements.py on bigscale's 0.3 Mb workload, --part
    2: the JAX package's per-part contig alignment and the port's give the
    same placements, and every named contig is placed."""
    import importlib.util
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "contig_placements.py"
    spec = importlib.util.spec_from_file_location("contig_placements", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["0.3", "5", "2", "c3", "c60"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {p: [{k: v for k, v in x.items() if k != "package"}
              for x in lines if x["package"] == p] for p in ("jax", "torch")}
    assert by["jax"] == by["torch"]
    assert {x["contig"] for x in by["jax"]} == {"c3", "c60"}
    assert all(x["aligned"] > 0 for x in by["jax"])
