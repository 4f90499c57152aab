"""The cells at their own size on the card: a short run of each is
correct, and the control fails each on a seed of its own.  They skip
without a CUDA device (python3 -m pytest agbench/tests -q -m card)."""

import time

import pytest
import torch

from agbench import control, harness

CELLS = tuple(w["name"] for w in harness.benchmark()["workloads"])


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark runs on the card)")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct_on_the_card(name):
    need_card()
    res, _ = harness.execute(name, 8080, 1.0, False, time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    need_card()
    got = control.readings(name, 9090)
    assert any(v > lim for v, lim in got.values()), got
