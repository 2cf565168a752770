"""The check's control: the reference, computed in TF32, put in the program's place.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, draws the cell's inputs as a run does (``harness.draw_inputs``
at the benchmark's ``run_seconds``) and answers the rows a run's check
would compare (``harness.check_sample``) with the plain reference computed
in the precision below the configuration's (TF32 products in place of
float32), then compares those answers as a run compares the program's.
The control has no window, so its sample is drawn over the whole window
stream, as a run draws it over the queries it answered.
Prints one JSON line per seed with the numbers compared and the
configuration's limits; the control has to exceed at least one limit.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def control_readings(workload: str, seed: int, root: Path = ROOT, device: str = "cuda") -> dict:
    """The control's numbers for one seed, beside the configuration's limits."""
    import torch

    from bench import check, harness

    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, workload)
    cfg = harness.load_config(root, bench, cell["config"])
    mix = harness.load_traffic(root, cell["traffic"])
    inp = harness.draw_inputs(cfg, mix, seed, bench["run_seconds"], torch.device(device))
    sample = harness.check_sample(cfg, seed, len(inp.preds) - inp.n_warm)
    r = harness.compare_sample(inp, sample, mix["k"], control=True)
    numbers = r.numbers()
    return {"workload": workload, "seed": seed, "rows": r.rows, "numbers": numbers,
            "limits": cfg["limits"], "fails": not check.verdict(numbers, cfg["limits"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps(control_readings(args.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
