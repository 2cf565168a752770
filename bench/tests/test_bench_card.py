"""On the card only: the control at each cell's own size fails its limits on
three seeds.  Run there with ``python -m pytest -m cuda bench/tests``."""
from __future__ import annotations

import json

import pytest
import torch

from bench.control import control_readings

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (11, 12, 13):
        out = control_readings(workload, seed)
        assert out["fails"], out
