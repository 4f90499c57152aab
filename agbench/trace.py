"""What a traced run reads from torch.profiler's trace.

The union of the device operations' intervals is the device's busy time
(the arithmetic of aligngraph_tpu_torch/profile_align.device_profile at
commit 5fa5dc4, copied); idle = 1 - busy / traced wall.  The device time
of a span is the busy time of the device operations inside the ranges
that the profiler mirrors on the device for it, whatever the kernels
are called.  Each piece of an idle gap is named by the innermost
benchmark span ("agbench." names) that covers it on the host, else
"host" (the NAMED_GAPS longest gaps; the rest are "short gaps").  The
benchmark's own bookkeeping after a step's clock has stopped (keeping()
spans: the answers kept for the check, the step's files removed) is no
part of the traced window: its time leaves the window and its gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

SPAN_PREFIX = "agbench."
ROOT = SPAN_PREFIX + "traced"
KEEP = SPAN_PREFIX + "keep"
# the longest gaps named by their span; the rest are summed as one
NAMED_GAPS = 2000


def union_length(spans) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(spans) -> list:
    """(start, end) intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no merged busy
    interval covers."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _is_device(ev) -> bool:
    return ev.device_type == torch.autograd.DeviceType.CUDA


def _is_annotation(ev) -> bool:
    return bool(getattr(ev, "is_user_annotation", False)) or \
        ev.name.startswith(SPAN_PREFIX)


class Busy:
    """Merged busy intervals, and their length inside any range."""

    def __init__(self, merged_spans: list):
        self.starts = [s for s, _ in merged_spans]
        self.ends = [e for _, e in merged_spans]
        self.cum = [0.0]
        for s, e in merged_spans:
            self.cum.append(self.cum[-1] + e - s)

    def inside(self, lo: float, hi: float) -> float:
        a = bisect.bisect_right(self.ends, lo)       # first ending past lo
        b = bisect.bisect_left(self.starts, hi)      # first starting at hi
        if a >= b:
            return 0.0
        total = self.cum[b] - self.cum[a]
        total -= max(0.0, lo - self.starts[a])
        total -= max(0.0, self.ends[b - 1] - hi)
        return total


def name_stretch(host: list, lo: float, hi: float) -> list:
    """[(name, seconds)] of an idle stretch [lo, hi]: each piece of it
    named by the innermost host span that covers the piece, "host"
    where none does."""
    inside = [ev for ev in host
              if ev.time_range.start < hi and ev.time_range.end > lo]
    cuts = sorted({lo, hi} | {t for ev in inside for t in
                              (ev.time_range.start, ev.time_range.end)
                              if lo < t < hi})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        cover = [ev for ev in inside
                 if ev.time_range.start <= mid <= ev.time_range.end]
        name = min(cover, key=lambda ev: ev.time_range.end
                   - ev.time_range.start).name if cover else "host"
        out.append((name, (b - a) / 1e6))
    return out


def keeping():
    """The span of a step's bookkeeping after its clock has stopped, which
    read_trace leaves out of the traced window (a context manager)."""
    from torch.profiler import record_function

    return record_function(KEEP)


def read_trace(events, wall_s: float, t0_us: float, t1_us: float) -> dict:
    """The profiler's events of one traced stretch (host clock wall_s,
    profiler clock [t0_us, t1_us]) -> dict(busy_s, window_s, idle,
    span_device_s {span name: device seconds}, device_ops [[name, s]],
    idle_gaps [[name, s]]).

    The device operations are the device events but the annotations
    that the profiler mirrors on the device's timeline for each host span
    (first to last operation launched inside it).  A span's device
    seconds are the device operations' busy time inside its mirrored
    ranges, which on one stream and one launching thread are the
    operations launched under it.  The profiler's own tree
    (FunctionEvent.device_time_total) reads less: it does not count
    every kernel that the port launches through ctypes.  The keeping()
    spans' host time is taken off wall_s, and their gaps are not named."""
    keep_s = union_length([(ev.time_range.start, ev.time_range.end)
                           for ev in events
                           if not _is_device(ev) and ev.name == KEEP]) / 1e6
    wall_s -= keep_s
    dev = [ev for ev in events if _is_device(ev) and not _is_annotation(ev)]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in dev]
    busy = merged(spans)
    busy_s = union_length(spans) / 1e6
    by_op: dict = {}
    for ev in dev:
        by_op[ev.name] = by_op.get(ev.name, 0.0) + (
            ev.time_range.end - ev.time_range.start) / 1e6
    span_dev: dict = {}
    inside = Busy(busy).inside
    for ev in events:
        if _is_device(ev) and ev.name.startswith(SPAN_PREFIX) \
                and ev.name not in (ROOT, KEEP):
            span_dev[ev.name] = span_dev.get(ev.name, 0.0) + \
                inside(ev.time_range.start, ev.time_range.end) / 1e6
    host = [ev for ev in events if not _is_device(ev)
            and ev.name.startswith(SPAN_PREFIX) and ev.name != ROOT]
    named: dict = {}
    stretches = sorted(gaps(busy, t0_us, t1_us), key=lambda g: g[0] - g[1])
    for s, e in stretches[NAMED_GAPS:]:
        named["short gaps"] = named.get("short gaps", 0.0) + (e - s) / 1e6
    for s, e in stretches[:NAMED_GAPS]:
        for name, sec in name_stretch(host, s, e):
            named[name] = named.get(name, 0.0) + sec
    named.pop(KEEP, None)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=wall_s,
                idle=1.0 - busy_s / wall_s if wall_s > 0 else None,
                span_device_s=span_dev,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in idle])


@contextlib.contextmanager
def traced(device, out: dict):
    """Profile the block (host and device activity); on exit out gets
    read_trace's reading of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda d: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(ROOT):
            t0 = time.perf_counter()
            yield
            sync(device)
            wall = time.perf_counter() - t0
    events = prof.events()
    root = [ev for ev in events if ev.name == ROOT]
    t0_us = root[0].time_range.start if root else min(
        ev.time_range.start for ev in events)
    t1_us = root[0].time_range.end if root else max(
        ev.time_range.end for ev in events)
    out.update(read_trace(events, wall, t0_us, t1_us))
