"""One run of one benchmark cell: load, warm up, measure, check, report.

Everything is found by name.  BENCHMARK.json, at the checkout's root,
names the cell's configuration and its metrics; cells/<cell>.json holds
the cell's driver and parameters, configs/<config>.json the deployment,
drivers/<driver>.py the entry the window drives, and metrics/<metric>.py
the reader of each metric.  A driver module has:

  setup(run) -> state     make the sample from run.seed, build what the
                          window drives and run cell["warm_steps"] steps
                          (1 by default) to warm every shape up;
                          run.setup_split gets its parts' seconds
  step(state) -> dict     one unit of work ending in a device synchronise:
                          {"seconds": its wall, "units": {name: count},
                           "stats": the program's own numbers for it}
  finish(state) -> kept   what the check needs once the program is freed
  check(run, kept, control=False) -> (checks, failed_steps)
  SPANS                   (module, function) pairs of the program that a
                          traced run wraps in benchmark spans (a method
                          as "Class.method")

The window runs steps back to back until --seconds have passed; the step
in flight then finishes and counts.  A traced run profiles the first
cell["trace_steps"] steps of the window and wraps the program's banded
SW entries to count their work (roofline.SwWork).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from agbench import roofline, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's banded SW entries, as the aligners look them up
SW_ENTRIES = (("aligngraph_tpu_torch.align.read_aligner",
               "banded_sw_posmap_auto"),
              ("aligngraph_tpu_torch.align.contig_aligner",
               "banded_sw_posmap_auto"))
SW_SPAN = trace.SPAN_PREFIX + "sw"
# top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "aligngraph_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """agbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"agbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_for(entries: list, cell: str) -> list:
    """The entries of a metric list that this cell reports."""
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """What a driver and a metric reader see of one run."""

    def __init__(self, name, cell, config, seed, seconds, tracing, device):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.tracing = seed, seconds, tracing
        self.device = device
        self.setup_split: dict = {}
        self.steps: list = []          # step dicts, "traced" added
        self.trace: dict = {}          # trace.read_trace of the traced steps
        self.sw = roofline.SwWork()
        self.card: dict = {}
        self.peak_window_bytes = 0

    def units(self, key: str) -> float:
        return sum(s["units"].get(key, 0) for s in self.steps)

    def step_seconds(self) -> float:
        return sum(s["seconds"] for s in self.steps)

    def measured_steps(self) -> list:
        """The untraced steps where there are any, else all."""
        plain = [s for s in self.steps if not s["traced"]]
        return plain or self.steps


class MemoryWatch:
    """Peak allocated device bytes over the process and over the window,
    although the program resets the allocator's peak at each stage: while
    installed, every reset first folds the peak so far in."""

    def __init__(self, device):
        self.device = device
        self.process = 0
        self.window = None
        self._reset = torch.cuda.reset_peak_memory_stats

    def fold(self) -> None:
        m = torch.cuda.max_memory_allocated(self.device)
        self.process = max(self.process, m)
        if self.window is not None:
            self.window = max(self.window, m)

    def _wrapped(self, *args, **kwargs):
        self.fold()
        return self._reset(*args, **kwargs)

    def __enter__(self):
        torch.cuda.reset_peak_memory_stats = self._wrapped
        return self

    def __exit__(self, *exc):
        self.fold()
        torch.cuda.reset_peak_memory_stats = self._reset

    def start_window(self) -> None:
        torch.cuda.synchronize(self.device)
        self.fold()
        self.window = 0
        self._reset(self.device)

    def end_window(self) -> int:
        torch.cuda.synchronize(self.device)
        self.fold()
        w, self.window = self.window, None
        return w


def resolve(mod_name: str, attr: str) -> tuple:
    """(owner, name, value) of a module's attribute, "Class.method" too."""
    owner = importlib.import_module(mod_name)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, name, getattr(owner, name)


@contextlib.contextmanager
def patched(pairs):
    """Replace module attributes (or a class's in the module: "Class.f"),
    (module name, attribute, new value) each, for the block."""
    saved = []
    try:
        for mod_name, attr, new in pairs:
            owner, name, old = resolve(mod_name, attr)
            saved.append((owner, name, old))
            setattr(owner, name, new)
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def _span(fn, name: str):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _sw_entry(fn, work: roofline.SwWork):
    from torch.profiler import record_function

    def wrapped(reads, rlens, windows, g0, pad, smin=None):
        work.add(rlens, reads.shape[1], pad, smin)
        with record_function(SW_SPAN):
            return fn(reads, rlens, windows, g0, pad=pad, smin=smin)
    return wrapped


def trace_patches(driver, run: Run) -> list:
    """The benchmark spans of a traced stretch: the driver's SPANS, and
    the SW entries with their work counted into run.sw."""
    out = []
    for mod_name, attr in getattr(driver, "SPANS", ()):
        fn = resolve(mod_name, attr)[2]
        out.append((mod_name, attr, _span(fn, f"{trace.SPAN_PREFIX}{attr}")))
    for mod_name, attr in SW_ENTRIES:
        fn = resolve(mod_name, attr)[2]
        out.append((mod_name, attr, _sw_entry(fn, run.sw)))
    return out


def window(driver, state, run: Run, watch: MemoryWatch) -> None:
    """Steps back to back until run.seconds have passed; the first
    trace_steps of them profiled in a traced run."""
    n_trace = int(run.cell.get("trace_steps", 1)) if run.tracing else 0
    watch.start_window()
    t0 = time.perf_counter()
    if n_trace:
        with patched(trace_patches(driver, run)), \
                trace.traced(run.device, run.trace):
            while len(run.steps) < n_trace:
                run.steps.append(dict(driver.step(state), traced=True))
    while not run.steps or time.perf_counter() - t0 < run.seconds:
        run.steps.append(dict(driver.step(state), traced=False))
        # the step's garbage goes now, not inside a later step
        gc.collect()
    run.peak_window_bytes = watch.end_window()
    for s in run.steps:
        print(f"# step {s['seconds']} traced={s['traced']} "
              f"{json.dumps(s['stats'])}", file=sys.stderr, flush=True)
    if run.trace:
        print(f"# traced: busy {run.trace['busy_s']} s of "
              f"{run.trace['window_s']} s; span device s "
              f"{json.dumps(run.trace['span_device_s'])}; "
              f"sw work {run.sw.totals()}", file=sys.stderr, flush=True)


def read_metrics(entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def fail(msg: str, code: int = 2) -> int:
    print(f"agbench: {msg}", file=sys.stderr, flush=True)
    return code


def caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".agbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def execute(name: str, seed: int, seconds: float, tracing: bool,
            t_start: float, *, bench=None, config=None, cell=None,
            device=None):
    """The run -> (result dict, checks); bench, config, cell and device
    stand in for the files and the card in the tests."""
    bench = bench or benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cell or load_json("cells", name)
    config = config or load_json("configs", wl["config"])
    device = torch.device("cpu") if device == "cpu" \
        else torch.device("cuda", 0)
    cuda = device.type == "cuda"
    run = Run(name, cell, config, seed, seconds, tracing, device)
    driver = load_module("drivers", cell["driver"])
    if cuda:
        run.card = roofline.card_figures(device)
        print(f"# card {run.card['kind']}, power limit "
              f"{run.card['power_limit_w']} W", file=sys.stderr, flush=True)
    with MemoryWatch(device) if cuda else _CpuWatch() as watch:
        state = driver.setup(run)
        setup_s = time.perf_counter() - t_start
        print(f"# setup_s {setup_s} split {json.dumps(run.setup_split)}",
              file=sys.stderr, flush=True)
        window(driver, state, run, watch)
    memory_peak = watch.process
    kept = driver.finish(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = driver.check(run, kept)
    del kept
    gc.collect()
    entries = bench["per_layer"] if tracing else bench["end_to_end"]
    run.setup_s = setup_s
    metrics = read_metrics(metrics_for(entries, name), run)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": run.card.get("kind", "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    if tracing and run.trace:
        device_info.update(busy_s=run.trace["busy_s"],
                           window_s=run.trace["window_s"])
    result = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": len(run.steps), "failed": failed,
              "metrics": metrics, "device": device_info}
    if tracing and run.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result, checks


class _CpuWatch(contextlib.nullcontext):
    """MemoryWatch for a CPU run: no device memory to watch."""
    process = 0

    def __enter__(self):
        return self

    def start_window(self):
        pass

    def end_window(self):
        return 0


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="agbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = benchmark()
        wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    except (OSError, ValueError, StopIteration) as e:
        return fail(f"cannot find workload {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < int(wl["chips"]):
        return fail(f"{wl['chips']} cards asked, "
                    f"{torch.cuda.device_count()} present")
    caches()
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        return fail(f"loaded in the process: {', '.join(bad)}", 3)
    for c in checks:
        print(f"check {c['name']} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
