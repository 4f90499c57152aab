"""Each cell's run on the CPU at a tiny size, the port on its plain
kernels: its check passes as the program runs, and fails when the timed
path is broken underneath (in the reassembly: the read and contig
aligners, the k-mer layer and the traversal), and the control fails
it."""

import dataclasses
import time

import numpy as np
import pytest

from agbench import control, harness
from conftest import bench_with_read_cell

CELLS = ("ecoli_k12.reassemble", "athaliana_chr1.align_reads",
         "athaliana_chr1.align_contigs")


def run_cell(name, tiny, seed=12345, tracing=False, cell=None):
    bench = bench_with_read_cell()
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    return harness.execute(name, seed, 0.0, tracing, time.perf_counter(),
                           bench=bench, config=tiny(wl["config"]),
                           cell=cell, device="cpu")[0]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name, tiny):
    res = run_cell(name, tiny)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    wanted = harness.metrics_for(bench_with_read_cell()["end_to_end"], name)
    # peak_device_gib needs the card
    assert {m["name"] for m in wanted} - set(res["metrics"]) == \
        {"peak_device_gib"}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_the_program_spans(tiny):
    name = "athaliana_chr1.align_reads"
    res = run_cell(name, tiny, tracing=True,
                   cell=dict(harness.load_json("cells", name),
                             trace_steps=1))
    assert res["correct"] is True
    # the device metrics need the card; the program's spans do not
    assert set(res["metrics"]) == {"read_host_s.align_reads"}
    assert res["metrics"]["read_host_s.align_reads"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, tiny):
    bench = bench_with_read_cell()
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    got = control.readings(name, 4242, bench=bench,
                           config=tiny(wl["config"]), device="cpu")
    assert any(v > lim for v, lim in got.values()), got


# --- faults planted in the program's timed path ------------------------

def _empty_records(recs):
    return dataclasses.replace(recs, **{
        f.name: getattr(recs, f.name)[:0]
        for f in dataclasses.fields(recs)})


def _alter_record(recs):
    pm = recs.pos_map.copy()
    pm[len(pm) // 2, 0, 10] += 1
    return dataclasses.replace(recs, pos_map=pm)


def _alter_placement(pa):
    maps = [m.copy() for m in pa.pos_map]
    maps[len(maps) // 2][5] += 1
    return dataclasses.replace(pa, pos_map=maps)


def _empty_placements(pa):
    return dataclasses.replace(pa, **{
        f.name: (getattr(pa, f.name)[:0] if f.name != "pos_map" else [])
        for f in dataclasses.fields(pa)})


def _read_fault(kind):
    from aligngraph_tpu_torch.align.read_aligner import ReadAligner
    from aligngraph_tpu_torch.io.formalize import Reads

    align = ReadAligner.align

    def broken(self, reads):
        if kind == "half":
            # half of every batch left out: only its first half aligned
            keep = np.concatenate([
                np.arange(s, s + min(self.batch_pairs, reads.n_pairs - s)
                          // 2) for s in range(0, reads.n_pairs,
                                               self.batch_pairs)])
            rows = np.stack([2 * keep, 2 * keep + 1], 1).reshape(-1)
            sub = Reads(len(keep), reads.max_len, reads.data[rows],
                        reads.lengths[keep])
            out = align(self, sub)
            out.pair_id[:] = keep[out.pair_id]
            return out
        out = align(self, reads)
        return _empty_records(out) if kind == "unchanged" else \
            _alter_record(out)
    return ReadAligner, "align", broken


def _contig_fault(kind):
    from aligngraph_tpu_torch.align.contig_aligner import ContigAligner

    align = ContigAligner.align

    def broken(self, contigs):
        out = align(self, contigs)
        if kind == "unchanged":
            return _empty_placements(out)
        if kind == "half":
            keep = np.flatnonzero(out.chunk_id % 2 == 0)
            return dataclasses.replace(out, **{
                f.name: ([out.pos_map[i] for i in keep] if f.name == "pos_map"
                         else getattr(out, f.name)[keep])
                for f in dataclasses.fields(out)})
        return _alter_placement(out)
    return ContigAligner, "align", broken


def _kmer_fault(kind):
    """The k-mer layer's build broken: on the CPU run_pipeline takes the
    host build (graph_build_for), which writes the device build's graph
    bit for bit."""
    from aligngraph_tpu_torch.pipeline import driver

    build = driver.build_kmer_layer

    def broken(g, pairs, *args, **kwargs):
        if kind == "unchanged":
            return None
        if kind == "half":
            pairs = dataclasses.replace(pairs, **{
                f.name: getattr(pairs, f.name)[:pairs.n // 2]
                for f in dataclasses.fields(pairs)})
        out = build(g, pairs, *args, **kwargs)
        if kind == "altered":
            p = int(np.flatnonzero(g.km_cnt > 0)[0])
            g.km_cov[p, 0] += 1
        return out
    return driver, "build_kmer_layer", broken


def _walk_fault(kind):
    from aligngraph_tpu_torch.pipeline import driver

    walk = driver.extend_and_scaffold

    def broken(g, *args, **kwargs):
        scaffolds, pre = walk(g, *args, **kwargs)
        if kind == "unchanged":
            return [], pre
        if kind == "half":
            return scaffolds[::2], pre
        scaffolds[0] = scaffolds[0].copy()
        scaffolds[0][len(scaffolds[0]) // 2] ^= 1
        return scaffolds, pre
    return driver, "extend_and_scaffold", broken


FAULTS = [(cell, fault, kind)
          for cell, faults in (
              ("ecoli_k12.reassemble", (_read_fault, _contig_fault,
                                        _kmer_fault, _walk_fault)),
              ("athaliana_chr1.align_reads", (_read_fault,)),
              ("athaliana_chr1.align_contigs", (_contig_fault,)))
          for fault in faults
          for kind in ("unchanged", "half", "altered")]


@pytest.mark.parametrize(
    "name, fault, kind", FAULTS,
    ids=[f"{c}-{f.__name__[1:]}-{k}" for c, f, k in FAULTS])
def test_fault_in_the_timed_path_is_not_correct(name, fault, kind, tiny,
                                                monkeypatch):
    cls, attr, broken = fault(kind)
    monkeypatch.setattr(cls, attr, broken)
    res = run_cell(name, tiny)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
