"""The benchmark's CPU tests: tiny samples of each configuration, and
the marker of the tests that need the card.

    python3 -m pytest agbench/tests -q

Tests marked `card` decide inside the test whether a CUDA device is
there and skip without one; on the card they run the cells at their own
size (python3 -m pytest agbench/tests -q -m card)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def tiny_config(name: str) -> dict:
    """The configuration at a size the CPU runs in seconds: a 120 kb
    genome at 5x, chimeras' halves 20 kb apart; the read aligner cells
    in batches of 1,024 pairs (run_pipeline's read aligner keeps its
    own batch size, so ecoli_k12 keeps the configuration's)."""
    from agbench import harness

    c = copy.deepcopy(harness.load_json("configs", name))
    c["sample"].update(genome_len=120_000, depth=5, min_apart=20_000)
    if name != "ecoli_k12":
        c["aligner"]["batch_pairs"] = 1024
    return c


# The read aligner's cell and the metrics only it reports.  Two sets of
# its runs on the card spread by more than half of a bound (PERF.md), so
# BENCHMARK.json leaves them out; its driver, cell file and readers stay,
# and the tests hold them as a benchmark that lists them would.
READ_CELL = {"name": "athaliana_chr1.align_reads", "config": "athaliana_chr1",
             "traffic": "align_reads", "chips": 1,
             "why": "ReadAligner.align over the whole library a call"}
READ_METRICS = dict(
    end_to_end=[{"name": "read_pairs_per_s", "unit": "pairs/s",
                 "better": "higher", "bound": 0.25, "source": "host_clock",
                 "workloads": [READ_CELL["name"]]}],
    per_layer=[{"name": name, "unit": unit, "better": better,
                "source": source, "layer": layer,
                "moves": "read_pairs_per_s",
                "workloads": [READ_CELL["name"]]}
               for name, unit, better, source, layer in (
                   ("read_host_s.align_reads", "s/Mpairs", "lower",
                    "program_span", "read aligner, host side"),
                   ("sw_roofline.align_reads", "%", "higher",
                    "device_trace", "kernels"),
                   ("device_idle.align_reads", "share", "lower",
                    "device_trace", "device"))])


def bench_with_read_cell() -> dict:
    """BENCHMARK.json with the read aligner's cell and metrics added."""
    from agbench import harness

    b = harness.benchmark()
    b["workloads"].append(dict(READ_CELL))
    for kind, entries in READ_METRICS.items():
        b[kind].extend(copy.deepcopy(entries))
    return b


@pytest.fixture
def tiny():
    return tiny_config
