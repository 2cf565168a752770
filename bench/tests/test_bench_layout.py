"""BENCHMARK.json's form, cells and metrics found by name, and the import check."""
from __future__ import annotations

import json
import re
import subprocess
import sys

from bench import guard, harness

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_form():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in b["paths"])
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cfg_names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert (REPO / c["file"]).is_file() and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg_names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfg_names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == cfg_names
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"]) and m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:          # every cell reports setup_s, another e2e and a per-layer metric
        e = [m["name"] for m in harness.metrics_of(b, cell, False)]
        assert "setup_s" in e and len(e) >= 2 and harness.metrics_of(b, cell, True)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_and_a_metric_added_as_files_only(tiny_root):
    (tiny_root / "bench" / "traffic" / "wide.json").write_text(json.dumps(
        {"batch": 8, "k": 10, "noise": 0.05, "max_qps": 50_000, "warmup_batches": 1,
         "predicates": {"mode": "fresh", "kinds": ["range"], "pass_fraction": [0.3, 0.6],
                        "multi_range_prob": 0.0, "unique": True}}))
    (tiny_root / "bench" / "metrics" / "answered.py").write_text(
        "def read(ctx):\n    return float(ctx.queries)\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.wide", "config": "tiny", "traffic": "wide",
                           "chips": 1, "why": "added by files"})
    b["per_layer"].append({"name": "answered", "unit": "queries", "better": "higher",
                           "source": "program_counter", "layer": "entry", "moves": "qps",
                           "workloads": ["tiny.wide"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    r = harness.run_cell("tiny.wide", 77, 0.3, True, root=tiny_root, device="cpu",
                         log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["answered"]["value"] == r["attempted"] > 0
    assert "answered" not in harness.run_cell("tiny.mixed", 77, 0.2, True, root=tiny_root,
                                              device="cpu", log=lambda *a: None)["metrics"]


def test_import_check():
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro",
                                    "repro.core.engine"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro", "repro.core.engine"])
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping",
                                    "numpy"]) == []


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = (f"import sys; sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
            "from bench import guard, harness\n"
            f"harness.run_cell('tiny.pool', 5, 0.2, True, root={str(tiny_root)!r}, "
            "device='cpu', log=lambda *a: None)\n"
            "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    r = subprocess.run([sys.executable, str(REPO / "bench" / "run.py"), "--workload",
                        "arxiv-2m.popular-labels", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    # a directory holding only BENCHMARK.json and the files under paths
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run([sys.executable, str(tmp_path / "bench" / "run.py"), "--workload",
                        "arxiv-2m.popular-labels", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
