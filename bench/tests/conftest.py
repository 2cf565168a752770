"""A tiny checkout for the harness's CPU tests: the repository's
``BENCHMARK.json`` with its configurations and cells swapped for small
ones, the real metric readers, and mixes cut from the real ones."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

TINY_ROWS, TINY_DIM = 3000, 32


def tiny_config(name: str = "arxiv-2m") -> dict:
    cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text())
    cfg.update(rows=TINY_ROWS, dim=TINY_DIM, engine={"n_lists": 32})
    cfg["planner_training"] = {"queries": 16, "kinds": ["mixed", "label", "range"],
                               "pass_fraction": [0.01, 0.25], "multi_range_prob": 0.2,
                               "noise": 0.05}
    return cfg


def make_root(base: Path) -> Path:
    """A checkout holding a tiny arxiv configuration ``tiny`` with two
    cells: ``tiny.mixed`` (fresh mixed filters) and ``tiny.pool`` (a
    label pool), both a few thousand queries a second on the CPU."""
    root = base / "root"
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir()
    shutil.copytree(REPO / "bench" / "metrics", root / "bench" / "metrics")
    (root / "bench" / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for src, dst, b in (("fresh-mixed", "mixed", 16), ("popular-labels", "pool", 32)):
        mix = json.loads((REPO / "bench" / "traffic" / f"{src}.json").read_text())
        mix.update(batch=b, max_qps=50_000, warmup_batches=2)
        (root / "bench" / "traffic" / f"{dst}.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                         "reduced": ["rows", "dim"], "why": "tests"}]
    bench["workloads"] = [
        {"name": "tiny.mixed", "config": "tiny", "traffic": "mixed", "chips": 1, "why": "tests"},
        {"name": "tiny.pool", "config": "tiny", "traffic": "pool", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
