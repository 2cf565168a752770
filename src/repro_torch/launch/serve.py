"""Serving from the command line: LM generation and the trace-driven ANN runtime.

Port of ``repro/launch/serve.py`` with the same flags and defaults, plus
``--device`` (default ``cuda``; pass ``cpu`` to run without a card):

    # batched LM generation with a reduced model
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch gemma2-2b \\
        --requests 8 --new-tokens 16

    # deadline-aware filtered-ANN serving: replay an arrival trace through
    # the continuous micro-batcher (vs a naive per-request loop) and print
    # the telemetry snapshot
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann-trace \\
        --corpus 20000 --requests 400 --rate 2000 --trace poisson --shards 4
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.model import Model
from ..serve.engine import Request, ServeEngine


def run_lm(args) -> dict:
    """Serve ``--requests`` random prompts of ``--prompt-len`` tokens with
    ``get_config(arch).reduced()`` (``--reduced`` cannot be turned off, as in
    the reference) and random weights from ``manual_seed(0)``.  A model
    with a frontend (encdec, vlm) raises ``NotImplementedError`` (from
    ``ServeEngine``): its requests need frames or patches."""
    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=args.device).init(
        torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for i in range(args.requests)
    ]
    eng = ServeEngine(model, batch_slots=args.slots,
                      max_len=args.prompt_len + args.new_tokens + 8)
    t0 = time.time()
    results = eng.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s)")
    for uid in sorted(results)[:3]:
        print(f"  req {uid}: {results[uid][:8]}...")
    return results


def run_ann_trace(args) -> dict:
    """Build a fixture corpus + engine, replay a seeded arrival trace through
    the runtime (optionally sharded, optionally with the planner feedback
    loop), and compare against the naive per-request loop."""
    from ..core import EngineConfig, FilteredANNEngine
    from ..core.trainer import gen_queries
    from ..data import make_dataset
    from ..obs import (
        RecallProbe, Tracer, publish_kernel_budget, publish_kernel_dispatch,
        span_summary,
    )
    from ..runtime import (
        FeedbackConfig, OnlineFeedback, OnlineRuntime, SchedulerConfig, make_trace,
    )
    from ..serve import ShardedANNEngine

    ds = make_dataset(args.dataset, scale=str(args.corpus), seed=args.seed)
    print(f"corpus: {args.dataset} n={ds.vectors.shape[0]} d={ds.vectors.shape[1]}")
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                            EngineConfig(seed=args.seed, device=args.device)).build()
    tq, tp, _ = gen_queries(ds.vectors, ds.cat, ds.num, args.fit_queries,
                            kinds=ds.filter_kinds, seed=args.seed + 1)
    eng.fit(tq, tp, k=args.k)
    qs, preds, _ = gen_queries(ds.vectors, ds.cat, ds.num, args.pool,
                               kinds=ds.filter_kinds, sel_range=(0.01, 0.4),
                               seed=args.seed + 2)
    if args.explain:
        # print ExecutionPlan trees for sample pool predicates (plus one
        # synthetic DNF so the per-disjunct shape shows) and exit
        from ..core import Or

        samples = list(preds[:3])
        if len(preds) >= 2:
            samples.append(Or((preds[0], preds[1])))
        for p in samples:
            print(f"\n{p}")
            print(eng.explain(p, k=args.k))
        return {}
    trace = make_trace(args.trace, qs, list(preds), args.requests, args.rate,
                       k=args.k, seed=args.seed + 3)

    backend = ShardedANNEngine(eng, n_shards=args.shards) if args.shards > 1 else eng
    feedback = None
    if args.feedback:
        feedback = OnlineFeedback(eng, FeedbackConfig(
            sample_rate=args.sample_rate, seed=args.seed))
    tracer = Tracer()
    probe = RecallProbe(rate=args.probe_rate, seed=args.seed) \
        if args.probe_rate > 0 else None
    runtime = OnlineRuntime(
        backend,
        SchedulerConfig(max_batch=args.max_batch, max_wait=args.max_wait),
        feedback=feedback,
        tracer=tracer,
        probe=probe,
    )
    report = runtime.run_trace(trace)
    snap = report.telemetry.snapshot(backend)

    # naive per-request loop on the same requests, for the throughput frame
    t0 = time.perf_counter()
    for r in trace:
        backend.query(r.query, r.pred, r.k)
    naive_wall = time.perf_counter() - t0

    wall = snap["wall"]["exec_s"]
    print(f"\ntrace: {trace.kind} rate={trace.rate:.0f}qps "
          f"requests={len(trace)} shards={args.shards}")
    print(f"runtime exec wall {wall:.2f}s ({len(trace)/wall:.0f} qps)  |  "
          f"naive loop {naive_wall:.2f}s ({len(trace)/naive_wall:.0f} qps)  |  "
          f"speedup {naive_wall/max(wall, 1e-9):.2f}x")
    if feedback is not None:
        snap["feedback"] = feedback.stats()
        feedback.publish(report.telemetry.registry)
    if probe is not None:
        snap["probe"] = probe.estimates()
        probe.publish(report.telemetry.registry)
    # kernel-side observability rides the same registry the runtime
    # counters live in: one export surface for the whole serving stack
    publish_kernel_dispatch(report.telemetry.registry)
    publish_kernel_budget(report.telemetry.registry)
    snap["span_summary"] = span_summary(tracer)
    if args.trace_out:
        tracer.write_jsonl(args.trace_out)
        print(f"wrote {sum(1 for _ in tracer.spans())} spans to {args.trace_out}")
    print(json.dumps(snap, indent=2, default=float))
    return snap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "ann-trace"), default="lm")
    ap.add_argument("--device", default="cuda",
                    help="where the model or the engine runs (cuda or cpu)")
    # lm mode
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    # shared / ann-trace mode
    ap.add_argument("--requests", type=int, default=None,
                    help="lm: 8, ann-trace: 400")
    ap.add_argument("--dataset", default="arxiv")
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--trace", choices=("poisson", "bursty"), default="poisson")
    ap.add_argument("--rate", type=float, default=2000.0, help="virtual qps")
    ap.add_argument("--pool", type=int, default=24, help="distinct predicates")
    ap.add_argument("--fit-queries", type=int, default=40)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait", type=float, default=0.005)
    ap.add_argument("--feedback", action="store_true",
                    help="enable the online planner feedback loop")
    ap.add_argument("--sample-rate", type=float, default=0.1)
    ap.add_argument("--probe-rate", type=float, default=0.0,
                    help="live recall-probe sampling rate (0 disables)")
    ap.add_argument("--explain", action="store_true",
                    help="print ExecutionPlan trees for sample pool "
                         "predicates (incl. a DNF) and exit, no trace replay")
    ap.add_argument("--trace-out", default=None,
                    help="write the span tree as JSONL to this path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 8 if args.mode == "lm" else 400
    if args.mode == "lm":
        return run_lm(args)
    return run_ann_trace(args)


if __name__ == "__main__":
    main()
