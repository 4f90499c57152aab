"""The program's spans: one recorder under every timer of the port.

A span is one stretch of a layer's work: its name (the layer, e.g.
"align.reads.wait"), an id, the id of the span it ran under (its
parent), the sample's id (the id of the root span, the one with no
parent: a run_pipeline call, or an aligner's call made outside one), the
thread, its start and end on time.perf_counter_ns, and the counts of the
work done in it.

Off, the default, a span keeps nothing.  A timed one (timed=True: its
caller reads its seconds) reads the host clock at its two ends, and its
caller adds them to the dict it has always kept (ReadAligner.split,
ContigAligner.layer_s, stage_seconds, ...); an untimed one costs one
check.  Steps, consecutive spans, read the clock once a boundary, and
record a CUDA event there only when asked (events=True).

On, while a torch.profiler profile runs or inside `recording()`, every
span also
  - keeps its record in a bounded store (STORE records, the oldest
    dropped first), which `records()` reads out;
  - enters torch.profiler.record_function(name), so the profiler's trace
    shows it on its own clock, nested as recorded, beside the kernels;
  - given a CUDA device, records a CUDA event at each end on the current
    stream.  Its device seconds are read when its root ends, if the
    device has passed its end by then, else by `records()`; nothing
    synchronises for them.  Given a CPU device, whose work the host runs,
    its device seconds are its host seconds.
A span opened under a recorded one is recorded too, so the threads that
a sample starts record their spans when each submitted callable runs in
a copy of the submitter's context (contextvars.copy_context().run).  A
profile records record_function ranges on other threads than its own
only when started with profile_all_threads=True.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

# the most span records kept; past it the oldest are dropped
STORE = 1 << 17

_now = time.perf_counter_ns
# the recorded span open in this context (thread or copied context)
_open: contextvars.ContextVar = contextvars.ContextVar(
    "aligngraph_span", default=None)


class _Recorder:
    """The store of kept records, the count of open recording() blocks,
    and the records of each open sample whose device seconds are still
    to be read."""

    def __init__(self):
        self.recording = 0
        self.kept: collections.deque = collections.deque(maxlen=STORE)
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.unread: Dict[int, list] = {}


_REC = _Recorder()


def on() -> bool:
    """Whether a span opened here now is recorded."""
    return (_REC.recording > 0
            or getattr(_profiler, "_is_profiler_enabled", False)
            or _open.get() is not None)


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block, without a profiler."""
    _REC.recording += 1
    try:
        yield
    finally:
        _REC.recording -= 1


class _Record:
    __slots__ = ("name", "id", "parent", "sample", "thread", "t0", "t1",
                 "counts", "ev0", "ev1", "device_s")

    def __init__(self, name: str, parent: Optional["_Record"]):
        self.name = name
        self.id = next(_REC.ids)
        self.parent = parent.id if parent is not None else None
        self.sample = parent.sample if parent is not None else self.id
        self.thread = threading.current_thread().name
        self.t0 = self.t1 = 0
        self.counts: Dict[str, float] = {}
        self.ev0 = self.ev1 = None
        self.device_s = None

    def read_device(self, wait: bool) -> bool:
        """Device seconds from the events once the device has passed the
        end one (waiting for it when `wait`); True when read."""
        if self.ev1 is None:
            return True
        if not (wait or self.ev1.query()):
            return False
        self.ev1.synchronize()
        self.device_s = self.ev0.elapsed_time(self.ev1) / 1e3
        self.ev0 = self.ev1 = None
        return True

    def as_dict(self) -> dict:
        return dict(name=self.name, id=self.id, parent=self.parent,
                    sample=self.sample, thread=self.thread,
                    start_ns=self.t0, end_ns=self.t1,
                    host_s=(self.t1 - self.t0) / 1e9,
                    device_s=self.device_s, counts=dict(self.counts))


def _cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _keep(rec: _Record) -> None:
    with _REC.lock:
        _REC.kept.append(rec)
        if rec.ev1 is not None:
            _REC.unread.setdefault(rec.sample, []).append(rec)
        if rec.parent is None:
            late = [r for r in _REC.unread.pop(rec.sample, ())
                    if not r.read_device(wait=False)]
            if late:
                _REC.unread[rec.sample] = late


class Span:
    """One span (a context manager); `seconds` after it ends, `add` its
    counts.  span() makes it."""

    __slots__ = ("name", "device", "rec", "t0", "t1", "_token", "_rf")

    def __init__(self, name: str, device, record: bool):
        self.name, self.device = name, device
        self.rec = _Record(name, _open.get()) if record else None
        self.t0 = self.t1 = 0

    def _start(self, t: Optional[int] = None, ev=None) -> None:
        rec = self.rec
        if rec is not None:
            self._token = _open.set(rec)
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if _cuda(self.device):
                rec.ev0 = ev if ev is not None else _event(self.device)
        self.t0 = _now() if t is None else t
        if rec is not None:
            rec.t0 = self.t0

    def _stop(self, t: Optional[int] = None, ev=None) -> None:
        self.t1 = _now() if t is None else t
        rec = self.rec
        if rec is None:
            return
        rec.t1 = self.t1
        if rec.ev0 is not None:
            rec.ev1 = ev if ev is not None else _event(self.device)
        elif self.device is not None:
            rec.device_s = (rec.t1 - rec.t0) / 1e9
        self._rf.__exit__(None, None, None)
        _open.reset(self._token)
        _keep(rec)

    def __enter__(self) -> "Span":
        self._start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop()

    @property
    def seconds(self) -> float:
        """Host seconds from its start to its end."""
        return (self.t1 - self.t0) / 1e9

    def elapsed(self) -> float:
        """Host seconds from its start to now."""
        return (_now() - self.t0) / 1e9

    def add(self, **counts) -> None:
        """Add counts of the work done in the span to its record (when
        recorded; also after it has ended)."""
        if self.rec is not None:
            c = self.rec.counts
            for k, v in counts.items():
                c[k] = c.get(k, 0) + v


class _Null:
    """An untimed span while off: nothing to do."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def add(self, **counts) -> None:
        pass


_NULL = _Null()


def span(name: str, *, device=None, timed: bool = False):
    """A span named `name` (a context manager).  device: where its work
    runs, for a span that launches device work (CUDA events when on);
    timed: its seconds are read, so it reads the clock when off too."""
    if on():
        return Span(name, device, True)
    if timed:
        return Span(name, device, False)
    return _NULL


def spanned(name: str):
    """Decorator: every call of the function is an untimed span `name`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not on():
                return fn(*args, **kwargs)
            with Span(name, None, True):
                return fn(*args, **kwargs)
        return call
    return wrap


class Steps:
    """Consecutive spans prefix.<name> under the span open where the
    steps are made, each starting where the last ended (a context
    manager: the last step ends with the block).  A boundary reads the
    clock once, and records one CUDA event on a CUDA device when on or
    when `events`.  seconds: a dict that each step's host seconds are
    added to, by name; mark: called with each step's name as it ends."""

    def __init__(self, prefix: str, *, device=None,
                 seconds: Optional[Dict[str, float]] = None,
                 events: bool = False,
                 mark: Optional[Callable[[str], None]] = None):
        self.prefix, self.device = prefix, device
        self.seconds, self.mark = seconds, mark
        self.cuda = _cuda(device)
        self.events = events and self.cuda
        self.current: Optional[str] = None
        self.span: Optional[Span] = None
        self.t = 0
        self.ev = None
        # (name, start event, end event) of each step, with `events`
        self.timeline: List[tuple] = []

    def step(self, name: str) -> None:
        """End the open step, if any, and open step `name`."""
        record = on()
        ev = _event(self.device) if self.cuda and (
            self.events or record) else None
        t = _now()
        self._end(t, ev)
        self.current, self.t, self.ev = name, t, ev
        if record:
            self.span = Span(f"{self.prefix}.{name}", self.device, True)
            self.span._start(t, ev)

    def _end(self, t: int, ev) -> None:
        name = self.current
        if name is None:
            return
        if self.span is not None:
            self.span._stop(t, ev)
            self.span = None
        if self.seconds is not None:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                (t - self.t) / 1e9
        if self.events:
            self.timeline.append((name, self.ev, ev))
        self.current = None
        if self.mark is not None:
            self.mark(name)

    def close(self) -> None:
        """End the open step."""
        if self.current is None:
            return
        ev = _event(self.device) if self.cuda and (
            self.events or self.span is not None) else None
        self._end(_now(), ev)

    def __enter__(self) -> "Steps":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def device_ms(self) -> Dict[str, float]:
        """With `events`, after the steps: each step name's device ms
        between its events, summed over its steps (waits for the last
        event)."""
        out: Dict[str, float] = {}
        if self.timeline:
            self.timeline[-1][2].synchronize()
        for name, a, b in self.timeline:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def records(clear: bool = False) -> List[dict]:
    """The kept span records as dicts, oldest first (name, id, parent,
    sample, thread, start_ns, end_ns, host_s, device_s, counts); the
    device seconds not read yet are read first.  clear: empty the store
    afterwards."""
    with _REC.lock:
        for recs in _REC.unread.values():
            for r in recs:
                r.read_device(wait=True)
        _REC.unread.clear()
        out = [r.as_dict() for r in _REC.kept]
        if clear:
            _REC.kept.clear()
    return out
