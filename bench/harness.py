"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file (its ``file`` entry), the traffic mix's file
``bench/traffic/<traffic>.json``, and a reader ``bench/metrics/<metric>.py``
for every metric, end-to-end or per layer.  A reader is a module with
``read(ctx) -> float | None`` over a :class:`Context`; ``None`` means
there was nothing to read, and the metric is left out of the line.

The run:

1. draws the configuration's corpus on the device from the seed
   (:mod:`bench.corpus`), the planner's training queries and the cell's
   whole query stream (:mod:`bench.traffic.generator`) by
   :func:`draw_inputs`, which the check's control shares, and hands the
   program host numpy arrays, as its constructor asks;
2. builds ``FilteredANNEngine``, fits its planner where the configuration
   names ``planner_training``, sends the mix's warm-up batches (same
   traffic, before the window);
3. runs a closed loop for ``seconds``: one client sends the next
   ``batch_query`` call when the last one returns, synchronised;
4. frees the program, draws the corpus again and compares a sample of the
   answers (:func:`check_sample`) with the plain reference (:mod:`bench.check`);
5. returns the result: correct, attempted, failed, metrics, device and the checks.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check
from .corpus import Corpus, derive_seed, generate, query_vectors
from .traffic.generator import make_predicates, to_program

__all__ = ["Context", "Inputs", "StreamExhausted", "load_benchmark", "find_cell", "load_config",
           "load_traffic", "load_reader", "metrics_of", "draw_inputs", "check_sample",
           "compare_sample", "run_cell"]

ROOT = Path(__file__).resolve().parents[1]


class StreamExhausted(RuntimeError):
    """The window outran the query stream sized before it."""


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def load_config(root: Path, bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((Path(root) / entry["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_traffic(root: Path, mix: str) -> dict:
    return json.loads((Path(root) / "bench" / "traffic" / f"{mix}.json").read_text())


def load_reader(root: Path, metric: str) -> Callable:
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + "".join(c if c.isalnum() else "_" for c in metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it, or that list no cells and move an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


@dataclasses.dataclass
class Context:
    """What a metric reader sees of one run."""
    setup_s: float
    window_s: float
    queries: int                       # answered in the window
    batch: int
    latencies: np.ndarray              # seconds of each batch_query call
    strategies: List[str]              # each answered query's plan strategy
    launches: Dict[str, int]           # kernel launches in the window
    readings: check.Readings           # the check's comparison
    rows: int                          # corpus rows
    dim: int
    k: int
    device_kind: str
    spans: list = dataclasses.field(default_factory=list)   # program spans (trace runs)
    profile: Optional[object] = None   # devtrace.DeviceProfile (trace runs)

    def query_latencies_ms(self) -> np.ndarray:
        """Each query's latency: the wall of the call that carried it."""
        return np.repeat(self.latencies * 1e3, self.batch)


def _log(*a) -> None:
    import sys

    print(*a, file=sys.stderr, flush=True)


def _take(out, row0: int, batch: int, k: int, ids: np.ndarray, dist: np.ndarray,
          strategies: List[str]) -> int:
    """Copy one call's answers into rows ``row0..``; returns how many of the
    batch's queries got no well-formed answer."""
    failed = batch - len(out)
    for j, r in enumerate(out[:batch]):
        got_i, got_d = np.asarray(r.result.ids), np.asarray(r.result.dists)
        if got_i.shape == (1, k) and got_d.shape == (1, k):
            ids[row0 + j], dist[row0 + j] = got_i[0], got_d[0]
        else:
            failed += 1
        strategies.append(r.plan.strategy)
    strategies.extend(["none"] * (batch - min(len(out), batch)))
    return failed


@dataclasses.dataclass
class Inputs:
    """What one seed makes of a cell before its program is built."""
    corpus: Optional[Corpus]           # on the device
    cat: np.ndarray                    # the corpus's metadata, host copies
    num: np.ndarray
    preds: List                        # warm-up then window, neutral form
    queries: np.ndarray                # one vector per predicate
    n_warm: int                        # the warm-up's queries, first in the stream
    train: Optional[tuple]             # (vectors, predicates) to fit the planner on

    def window(self, rows: np.ndarray):
        """The window's queries and predicates at ``rows``."""
        return self.queries[self.n_warm + rows], [self.preds[self.n_warm + i] for i in rows]


def draw_inputs(cfg: dict, mix: dict, seed: int, seconds: float, dev) -> Inputs:
    """The configuration's corpus on ``dev`` and the cell's whole query
    stream (warm-up, then a window of ``max_qps * seconds`` queries), all
    from the seed; the planner's training queries where the configuration
    names ``planner_training``."""
    import torch

    off, batch = cfg["seed_offset"], mix["batch"]
    corpus = generate(cfg, seed, dev)
    sorted_num = [c.cpu().numpy() for c in torch.sort(corpus.num, dim=0).values.T]
    cat_h, num_h = corpus.cat.cpu().numpy(), corpus.num.cpu().numpy()
    train = None
    tr = cfg.get("planner_training")
    if tr:
        train = (query_vectors(corpus, tr["queries"], tr["noise"], derive_seed(seed, off, "train")),
                 make_predicates(dict(tr, mode="fresh"), cat_h, num_h, sorted_num, tr["queries"],
                                 derive_seed(seed, off, "train")))
    n_warm = mix["warmup_batches"] * batch
    n_window = int(math.ceil(mix["max_qps"] * seconds / batch)) * batch
    preds = make_predicates(mix["predicates"], cat_h, num_h, sorted_num, n_warm + n_window,
                            derive_seed(seed, off, "traffic"))
    queries = query_vectors(corpus, n_warm + n_window, mix["noise"],
                            derive_seed(seed, off, "vectors"))
    return Inputs(corpus, cat_h, num_h, preds, queries, n_warm, train)


def check_sample(cfg: dict, seed: int, n_answered: int) -> np.ndarray:
    """The window rows the check compares: ``CHECK_QUERIES`` of the
    ``n_answered``, drawn from the seed, in order."""
    rng = np.random.default_rng(derive_seed(seed, cfg["seed_offset"], "sample"))
    return np.sort(rng.permutation(n_answered)[:check.CHECK_QUERIES])


def compare_sample(inp: Inputs, sample: np.ndarray, k: int, ids=None, dist=None, exact=None,
                   control: bool = False) -> check.Readings:
    """The check's readings over the window rows ``sample``: the program's
    answers there (``ids``, ``dist``, ``exact``, one row each), or with
    ``control`` the reference in the precision below in their place."""
    qs, preds = inp.window(sample)
    c = inp.corpus
    return check.compare(c.vectors, c.cat, c.num, qs, preds, ids, dist, exact, k, control=control)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
             device: str = "cuda", t_start: Optional[float] = None,
             fault: Optional[Callable] = None, log: Callable = _log) -> dict:
    """One run; returns its result line as a dict.  ``fault(engine)``, given,
    breaks the timed path underneath after the warm-up (tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core import EngineConfig, FilteredANNEngine
    from repro_torch.kernels import ops

    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    cfg = load_config(root, bench, cell["config"])
    mix = load_traffic(root, cell["traffic"])
    dev = torch.device(device)
    k, batch = mix["k"], mix["batch"]

    stages = {"start": time.perf_counter() - t_start}

    def stage(name: str) -> None:
        stages[name] = time.perf_counter() - t_start

    # 1. inputs from the seed
    inp = draw_inputs(cfg, mix, seed, seconds, dev)
    stage("traffic")
    vectors_h = inp.corpus.vectors.cpu().numpy()
    queries, preds, n_warm = inp.queries, inp.preds, inp.n_warm
    prog_preds = to_program(preds)
    inp.corpus = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # 2. the program: build, fit, warm up
    eng_seed = derive_seed(seed, cfg["seed_offset"], "engine") % (1 << 31)
    eng = FilteredANNEngine(vectors_h, inp.cat, inp.num,
                            EngineConfig(device=device, seed=eng_seed, **cfg["engine"])).build()
    stage("build")
    if inp.train is not None:
        eng.fit(inp.train[0], to_program(inp.train[1]), k=k)
        stage("fit")
    for s in range(0, n_warm, batch):
        eng.batch_query(queries[s:s + batch], prog_preds[s:s + batch], k)
    stage("warmup")
    if fault is not None:
        fault(eng)
    log("[setup] s since start: " + ", ".join(f"{n} {v:.2f}" for n, v in stages.items())
        + f"; engine {eng.build_time_}")

    # 3. the window
    # what set-up made lives on: keep it out of the collector's full passes,
    # so the harness's own stream does not pace the window
    gc.collect()
    gc.freeze()
    prof = tracer = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .devtrace import WINDOW_LABEL, ProfiledTracer

        tracer = ProfiledTracer()
        eng.set_tracer(tracer)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        window_range = record_function(WINDOW_LABEL)
        window_range.__enter__()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    launches0 = ops.kernel_launches()
    n_cap = len(preds) - n_warm
    ids = np.full((n_cap, k), -1, np.int64)
    dist = np.full((n_cap, k), np.inf, np.float64)
    strategies: List[str] = []
    lat: List[float] = []
    failed = 0
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    s, t1 = n_warm, t0
    while t1 - t0 < seconds:
        if s + batch > len(preds):
            raise StreamExhausted(f"{(s - n_warm)} queries sent in {t1 - t0:.3f} s: the "
                                  f"stream of {n_cap} is too short; raise max_qps")
        a = time.perf_counter()
        out = eng.batch_query(queries[s:s + batch], prog_preds[s:s + batch], k)
        sync()
        t1 = time.perf_counter()
        lat.append(t1 - a)
        failed += _take(out, s - n_warm, batch, k, ids, dist, strategies)
        s += batch
    window_s = t1 - t0
    dprof = None
    if trace:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        eng.set_tracer(None)
        from .devtrace import read_profile

        dprof = read_profile(prof)
        del prof
    launches = {name: n - launches0[name] for name, n in ops.kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    gc.unfreeze()
    n_sent = s - n_warm
    ids, dist = ids[:n_sent], dist[:n_sent]
    spans = list(tracer.spans()) if tracer is not None else []
    del eng, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the check, against the reference on a sample drawn from the seed
    sample = check_sample(cfg, seed, n_sent)
    inp.corpus = generate(cfg, seed, dev)
    readings = compare_sample(inp, sample, k, ids[sample], dist[sample],
                              np.asarray([strategies[i] in check.EXACT_PLANS for i in sample]))
    inp.corpus = None
    log(f"[check] {time.perf_counter() - t_start - setup_s - window_s:.2f} s after the window")
    numbers = readings.numbers()
    limits = cfg["limits"]
    correct = check.verdict(numbers, limits) and failed == 0

    # 5. metrics
    ctx = Context(setup_s=setup_s, window_s=window_s, queries=n_sent, batch=batch,
                  latencies=np.asarray(lat), strategies=strategies, launches=launches,
                  readings=readings, rows=cfg["rows"], dim=cfg["dim"], k=k,
                  device_kind=kind, spans=spans, profile=dprof)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = load_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_sent, "failed": failed,
              "metrics": metrics, "device": device}
    if dprof is not None:
        device.update(busy_s=dprof.busy_s, window_s=dprof.window_s)
        result["breakdown"] = {
            "device_ops": [[name[:120], sec] for name, sec in dprof.device_ops[:10]],
            "idle_gaps": [[name, sec] for name, sec in dprof.idle_gaps[:10]]}
    thirds = np.array_split(np.asarray(lat), 3)
    log("[window] qps by thirds of the calls: "
        + ", ".join(f"{batch * t.size / t.sum():.1f}" for t in thirds if t.size))
    log(f"[window] {n_sent} queries in {window_s:.3f} s over {len(lat)} calls; plans "
        + ", ".join(f"{p} {strategies.count(p)}" for p in sorted(set(strategies)))
        + f"; launches {launches}; compared {readings.rows} rows ({readings.exact_rows} exact), "
        f"recall {readings.recall}")
    result["checks"] = {name: {"value": numbers[name], "limit": limits[name]} for name in numbers}
    return result
