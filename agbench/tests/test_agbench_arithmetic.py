"""The window's arithmetic, the trace's idle arithmetic and the banded
SW's work count."""

import types

import pytest
import torch

from agbench import readers, roofline, trace


def fake_run(steps, **kw):
    from agbench import harness

    run = harness.Run("x", {}, {}, 0, 0.0, False, torch.device("cpu"))
    run.steps = [dict(s, traced=s.get("traced", False)) for s in steps]
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_rate_and_time_per_unit_take_every_step():
    run = fake_run([dict(seconds=2.0, units={"pairs": 10}, stats={}),
                    dict(seconds=3.0, units={"pairs": 20}, stats={})])
    assert readers.rate(run, "pairs") == pytest.approx(30 / 5.0)
    assert readers.per_step(run, "pairs") == pytest.approx(5.0 / 30)
    assert readers.rate(run, "samples") is None


def test_stat_mean_prefers_untraced_steps():
    run = fake_run([dict(seconds=1, units={}, stats={"a": {"b": 9.0}},
                         traced=True),
                    dict(seconds=1, units={}, stats={"a": {"b": 1.0}}),
                    dict(seconds=1, units={}, stats={"a": {"b": 3.0}})])
    assert readers.stat_mean(run, "a", "b") == pytest.approx(2.0)
    assert readers.stat_mean(run, "a", "c") is None


@pytest.mark.parametrize("spans, union", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),
    ([(0, 10), (2, 3)], 10.0),
])
def test_union_of_intervals(spans, union):
    assert trace.union_length(spans) == pytest.approx(union)
    assert sum(e - s for s, e in trace.merged(spans)) == pytest.approx(union)


def test_gaps_cover_what_busy_leaves():
    busy = trace.merged([(1, 2), (4, 5)])
    assert trace.gaps(busy, 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert trace.gaps(busy, 1, 5) == [(2, 4)]


def _ev(name, start, end, cuda=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU))


def test_read_trace_idle_share_and_named_gaps():
    evs = [_ev("k1", 0, 200_000, cuda=True),
           _ev("k2", 100_000, 300_000, cuda=True),
           _ev("k1", 600_000, 700_000, cuda=True),
           _ev("agbench.sw", 0, 350_000),
           _ev("agbench._copy_out", 350_000, 650_000)]
    r = trace.read_trace(evs, 1.0, 0, 1_000_000)
    assert r["busy_s"] == pytest.approx(0.4)
    assert r["idle"] == pytest.approx(0.6)
    assert dict(r["device_ops"]) == pytest.approx({"k1": 0.3, "k2": 0.2})
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"agbench.sw": 0.05, "agbench._copy_out": 0.25, "host": 0.3})


def test_bookkeeping_after_a_step_is_no_part_of_the_traced_window():
    evs = [_ev("k1", 0, 200_000, cuda=True),
           _ev("k1", 600_000, 700_000, cuda=True),
           _ev("agbench.sw", 0, 350_000),
           _ev(trace.KEEP, 300_000, 500_000)]
    r = trace.read_trace(evs, 1.0, 0, 1_000_000)
    assert r["window_s"] == pytest.approx(0.8)
    assert r["idle"] == pytest.approx(1 - 0.3 / 0.8)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"agbench.sw": 0.1, "host": 0.4})


def _lanes(seed, B, L):
    g = torch.Generator().manual_seed(seed)
    rl = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    rl[::7] = 0
    return rl


@pytest.mark.parametrize("cuts", [[0, 50, 200], [0, 1, 2, 3, 200],
                                  [0, 137, 200]])
def test_sw_work_does_not_depend_on_the_launches(cuts):
    rl = _lanes(3, 200, 100)
    whole = roofline.SwWork()
    whole.add(rl, 100, 16, torch.zeros(200, dtype=torch.int32))
    split = roofline.SwWork()
    for a, b in zip(cuts, cuts[1:]):
        split.add(rl[a:b], 100, 16, torch.zeros(b - a, dtype=torch.int32))
    assert split.totals() == whole.totals()


def test_sw_work_counts_the_inputs_not_the_launch_shape():
    rl = torch.tensor([100, 0, 40], dtype=torch.int32)
    w = roofline.SwWork()
    w.add(rl, 100, 16, None)
    ops, nbytes = w.totals()
    assert ops == (100 + 40) * 32 * roofline.OPS_PER_CELL
    # bases, window bases, length and g0, score, pos_map words
    assert nbytes == (100 + 132 + 8 + 4 + 400) + (40 + 72 + 8 + 4 + 160)
    padded = roofline.SwWork()
    padded.add(torch.cat([rl, torch.zeros(500, dtype=torch.int32)]), 512,
               16, None)
    assert padded.totals() == (ops, nbytes)


def test_bound_takes_the_slower_of_operations_and_bytes():
    card = {"int32_ops_per_s": 1e12, "bytes_per_s": 1e11}
    b = roofline.bound(card, 2e12, 1e11)
    assert b["bound_s"] == pytest.approx(2.0)
    assert b["bound_by"] == "operations"
    assert roofline.bound(card, 1e9, 5e11)["bound_by"] == "bytes"


@pytest.mark.parametrize("lo, hi", [(0, 10), (1.5, 4.5), (2.2, 2.8),
                                    (3.1, 3.9), (-5, 1.5), (4.5, 20)])
def test_busy_inside_a_range(lo, hi):
    spans = trace.merged([(1, 2), (2.5, 3), (4, 6)])
    want = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in spans)
    assert trace.Busy(spans).inside(lo, hi) == pytest.approx(want)


def test_span_time_is_the_busy_time_of_its_mirrored_range():
    evs = [_ev("k1", 0, 100, cuda=True), _ev("k2", 150, 250, cuda=True),
           _ev("k3", 400, 500, cuda=True),
           _ev("agbench.sw", 0, 250, cuda=True),
           _ev("agbench.sw", 380, 520, cuda=True)]
    evs[3].is_user_annotation = evs[4].is_user_annotation = True
    r = trace.read_trace(evs, 1e-3, 0, 1000)
    assert r["span_device_s"]["agbench.sw"] == pytest.approx(300e-6)
    assert r["busy_s"] == pytest.approx(300e-6)
    assert "agbench.sw" not in dict(r["device_ops"])


def test_an_idle_gap_is_split_between_the_spans_it_crosses():
    evs = [_ev("k", 0, 100, cuda=True), _ev("k", 900, 1000, cuda=True),
           _ev("agbench.outer", 50, 950), _ev("agbench.a", 200, 400),
           _ev("agbench.b", 600, 700)]
    r = trace.read_trace(evs, 1e-3, 0, 1000)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"agbench.outer": 500e-6, "agbench.a": 200e-6, "agbench.b": 100e-6})
