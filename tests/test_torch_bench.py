"""The port's benchmark entry points against the JAX system's scripts, on
the CPU at a small size (tolerance 0 on every count and byte):
aligngraph_tpu_torch.bench against bench.py, .bench_pipeline against
bench_pipeline.py and .ecoli_scale against scripts/ecoli_scale_run.py.
Each JAX script runs in a subprocess with JAX_PLATFORMS=cpu; the two that
write to a fixed directory under /tmp run with that directory replaced by
one under the test's tmp_path (the literal must occur once)."""

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from aligngraph_tpu_torch import bench, bench_pipeline, ecoli_scale

REPO = Path(__file__).resolve().parent.parent

BENCH_ENV = {"BENCH_GENOME": "200000", "BENCH_PAIRS": "2000",
             "BENCH_BATCH": "1024"}
PIPE_ENV = {"BENCH_PIPE_GENOME": "120000", "BENCH_PIPE_DEPTH": "10"}
ECOLI_ARGS = ["5000", "150000"]

# run a script's source with one literal replaced, as the script itself
RUN_REPLACED = """
import sys
path, old, new = sys.argv[1:4]
sys.argv = [path] + sys.argv[4:]
src = open(path).read()
assert src.count(old) == 1, (path, old)
src = src.replace(old, new)
exec(compile(src, path, "exec"), {"__name__": "__main__", "__file__": path})
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_jax(args, env=None):
    """A JAX script in a subprocess on the CPU -> (stdout, stderr)."""
    proc = subprocess.run(
        [sys.executable, *args], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu",
                              **(env or {})))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout, proc.stderr


def run_jax_in(script: str, fixed_dir: str, work: Path, args=(), env=None):
    """run_jax on script with its fixed work directory replaced by work."""
    return run_jax(["-c", RUN_REPLACED, script, json.dumps(fixed_dir),
                    json.dumps(str(work)), *args], env)


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def hash_fields(text: str) -> dict:
    """The key=number fields of the "#" line that bench.py and the port
    both print."""
    line = next(ln for ln in text.splitlines() if ln.startswith("# total"))
    return {k: int(re.search(rf"\b{k}=(\d+)", line).group(1))
            for k in ("total_reads", "aligned", "records")}


def test_bench_equals_jax(capsys, monkeypatch):
    out, err = run_jax(["bench.py"], BENCH_ENV)
    for k, v in BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    assert bench.main(device="cpu") == 0
    got = capsys.readouterr()
    (want_line,), (got_line,) = json_lines(out), json_lines(got.out)
    assert list(got_line) == list(want_line) == [
        "metric", "value", "unit", "vs_baseline"]
    assert got_line["metric"] == want_line["metric"]
    assert got_line["unit"] == want_line["unit"]
    assert hash_fields(got.err) == hash_fields(err)
    assert hash_fields(got.err)["aligned"] > 0.9 * 4000
    # the median and its rate; no kernel launched on the CPU
    assert re.search(r"median=[\d.]+s rps_median=[\d.]+ ", got.err)
    assert "launches_by_L={}" in got.err and "device=cpu" in got.err


def test_bench_run_checks_its_repeats(monkeypatch):
    """run() raises when a timed align's records differ from the
    first's."""
    calls = []
    align = bench.ReadAligner.align

    def drifting(self, reads):
        res = align(self, reads)
        calls.append(1)
        if len(calls) == 4:             # two warm-up aligns, then timed
            res.score[0] += 1
        return res

    monkeypatch.setattr(bench.ReadAligner, "align", drifting)
    with pytest.raises(AssertionError, match="not deterministic"):
        bench.run(1500, 50_000, 1024, repeats=3, device="cpu")


def test_bench_pipeline_equals_jax(tmp_path, capsys, monkeypatch):
    out, _ = run_jax_in("bench_pipeline.py", "/tmp/bench_pipeline",
                        tmp_path / "jax", env=PIPE_ENV)
    for k, v in PIPE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert bench_pipeline.main(device="cpu") == 0
    got = capsys.readouterr()
    (want,), (line,) = json_lines(out), json_lines(got.out)
    assert list(line) == list(want)
    assert set(line["stages"]) == set(want["stages"])
    for k in want:
        if k not in ("value", "stages"):
            assert line[k] == want[k], k
    assert line["extended"] >= 1 and line["eval"]["n_true_contigs"] >= 1
    assert "# graph_build=host " in got.err
    work = tmp_path / bench_pipeline.WORK_DIR_NAME
    assert (work / "extended.fa").read_bytes() == \
        (tmp_path / "jax" / "extended.fa").read_bytes()


def test_ecoli_scale_equals_script(tmp_path, capsys, monkeypatch):
    out, err = run_jax_in("scripts/ecoli_scale_run.py", "/tmp/ecoli_scale",
                          tmp_path / "jax", ECOLI_ARGS)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert ecoli_scale.main(ECOLI_ARGS, device="cpu") == 0
    got = capsys.readouterr()
    want, lines = json_lines(out), json_lines(got.out)
    assert len(lines) == len(want) == 2
    walls = {"wall_s", "align_s", "eval_s"}
    for g, w in zip(lines, want):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k not in walls} == \
            {k: v for k, v in w.items() if k not in walls}
    assert lines[0]["extended"] >= 1
    setup = [ln for ln in got.err.splitlines() if ln.startswith("setup:")]
    assert setup and setup[0].split(" [")[0] == next(
        ln for ln in err.splitlines() if ln.startswith("setup:")
    ).split(" [")[0]
    assert "# graph_build=host " in got.err
    work = tmp_path / ecoli_scale.WORK_DIR_NAME
    for name in ("extended.fa", "remaining.fa", "stats.txt"):
        assert (work / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_entry_points_without_gpu_raise(tmp_path, monkeypatch):
    """The default device is CUDA; with none each entry point raises
    before it makes any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for fn in (bench.main, bench_pipeline.main,
               lambda: ecoli_scale.main(ECOLI_ARGS)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn()
    assert not list(tmp_path.iterdir())
