"""The lower-precision control on the card: the program's own int8 path
in place of bf16, at each cell's own traffic, must come out not correct,
and the program as configured correct. A short window (3 s) at the
cell's sizes; run with ``python -m pytest -m gpu benchmark/tests``."""

import json
import os

import pytest

from benchmark import harness
from benchmark.tests.conftest import BENCH, ROOT


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return [w["name"] for w in json.load(fp)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("mode,correct", [("int8", False), (None, True)],
                         ids=["int8-control", "as-configured"])
def test_control_fails_and_the_program_passes(cell, mode, correct):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.run import _cache_dirs

    _cache_dirs()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    result, numbers = harness.run_cell(bench, BENCH, ROOT, cell,
                                       2 ** 31 + 4242, 3.0, False,
                                       device="cuda:0", mode=mode)
    assert result["correct"] is correct, numbers
