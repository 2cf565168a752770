"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--rows N] [--train Q] [--serve Q]

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from the sources in this
     checkout (one nvcc per source, started together);
  3. the masked L2 top-k against its plain PyTorch version on the card at
     the ANN path's shapes (B from 1 to 256), with its path (streaming or
     tiled), query tile and splits, its time, the plain version's, the
     library yardstick's and the bound; a row alone (streaming) equals the
     same row in a tiled batch of 64 or 256 bitwise, and repeated calls
     are bitwise equal;
  3b. the flash-decode attention kernel likewise, at qwen3-14b's heads over
     B in {1, 8, 32} x S in {2088, 32768} x {bf16, f32} with ragged lengths,
     and at the reference tests' shapes, with the chunk size at each S; one
     CUDA kernel per call (torch.profiler), repeated calls bitwise equal,
     row independence (bitwise) and never reading past a row's length (NaN
     there);
  4. the filtered-ANN main path through its public entry points on the
     arxiv dataset at the paper's full size (2.14M x 384): build -> fit ->
     query / batch_query -> ground_truth; then 256 queries under one shared
     predicate through the exact executors in one call, each row equal to
     its query alone;
  4b. DNF: 64 Ors of 2-3 of phase 4's served predicates (overlapping, one
     with a repeated term, one a permutation of another) through query()
     and through batch_query() mixed with conjunctions, on the phase-4
     engine; every id passes its union once, batch rows equal query rows,
     all-exact unions equal ground truth up to ties, the permuted Or hits
     the plan cache; the clause plan mix, latency per union size, and how
     many all-exact unions equal one fused_masked_topk over the union mask
     bitwise;
  4c. a routed engine at the same size, backends flat, ivf, ivfpq and
     acorn (the ivf backend shares the engine's IVF): first the flat
     backend below TINY_N rows on the card (the kernel against the numpy
     scan); build seconds and memory per backend, fit on the first 16 of
     phase 4's training queries (8 routing classes raced per query; ACORN's
     host search makes a query cost seconds), phase 4's 200 served
     queries and 32 unions served;
     every id passes its predicate once, flat:exact rows and all-exact
     unions equal ground truth up to ties, batch rows equal query rows; the
     served (decision, backend, knob) mix with latencies, each class's
     recall@10 over 32 fixed queries beside its floor (printed, not gated:
     the floors were set on a 5,000-row corpus) with every id passing its
     mask once (gated, every class), and ACORN's device search against its
     host search; then a routing head spanning all 8 classes serves 2 rows
     per class through query() and batch_query() (every backend's routed
     groups, the same row checks); then the routed engine takes 2 % deletes
     and 0.5 % upserts and serves those rows again (no tombstoned id, every
     id passes its predicate once, flat:exact rows equal the live ground
     truth); the engine is freed;
  4d. the live corpus and sharded serving at the same size: a plain engine
     with phase 4's planner, GBM and IVF layout carried, and a 4-shard
     ShardedANNEngine over it on the one card (shards are views of its
     device corpus); a 2 % segment (fresh rows, ids= replacements, exact
     copies of base rows) and tombstones at 2, 5 and 10 % of the base rows
     applied through the sharded engine; at each level phase 4's served
     queries through query() and batch_query() on both engines: no
     tombstoned id, every id passes its predicate once, exact rows equal the
     live ground truth (bitwise) and an independent l2_topk truth (up to
     ties), sharded exact rows equal the central ones bitwise, batch rows
     equal query rows, each copy right after its base row; latency per plan
     against phase 4's, plan mix, post recall and batch QPS printed; shard 2
     stops beating, replan_mesh(3), reshard(3), exact rows again; both
     engines compacted, exact rows equal the live ones through id_map and a
     fresh build's, bitwise; upsert and delete rows/s, compaction s, peak
     memory; everything is freed before phase 6;
  4e. the serving runtime, checkpoints, observability and the fleet at the
     same size, on a plain engine with phase 4's planner, GBM and IVF
     layout carried (phase 4's engine takes no writes): (a) runtime_bench's
     Poisson and bursty traces of 400 reads at 0.5, 2 and 8 x the
     single-request virtual capacity (a pool of 16 of phase 4's served
     predicates, zipf 1.2, k = 10) through OnlineRuntime(max_batch=64,
     max_wait=0.005), each replayed twice: every request answered once,
     equal batches, counters and ids, every id passing its predicate,
     exact rows equal to an l2_topk truth up to ties; measured QPS beside a
     per-request query() loop, VIRTUAL latencies and deadline hit rates,
     the plan mix, the device's idle share over one replay; (b) a trace
     with write_frac 0.1, every batch checked on the spot after its
     launches are counted (no tombstoned id, exact rows equal the live
     ground truth bitwise and an l2_topk live truth up to ties), then
     mutation_state() through the Checkpointer (save, save_async) onto a
     fresh engine: its rows equal the live engine's bitwise; (c) Tracer,
     RecallProbe and OnlineFeedback on one runtime: two cold replays give
     equal span trees, the execute spans' kernel_* attrs add up to how
     far stats()' kernel_dispatch moved, prometheus_text() parses;
     span_summary beside the
     profiler's device-busy time, probe recall, feedback stats, the smem
     budget gauges; (d) fleet_bench's headline: three tenants over an even
     split of the rows, each fitted on 64 of phase 4's training queries,
     FleetRuntime (DRR, admission, autoscale) twice against the shared
     queue: equal replays, exact rows equal each tenant's truth up to ties
     through the reshards, Fleet.save/restore onto fresh collections
     bitwise; quiet tenants' SLO hit rates (virtual) beside fleet_bench's
     targets, scale events, build, fit and reshard seconds; everything is
     freed before phase 6;
  6. LM serving: qwen3-14b at full width and depth in bf16 (random weights
     from a seed), 16 requests through ServeEngine in 8 slots; decode
     launches equal 40 x steps, the kernel equals its plain version on the
     model's own cache, the device's idle share of a decode step;
  7. RAG: RetrievalAugmentedServer over the phase-6 model and the phase-4
     engine; every id passes its predicate, exact plans equal ground truth;
  8. fp32 exactness at full width and depth 4: batch tokens equal solo
     tokens, and served tokens equal the teacher-forced argmax except at
     near-ties;
  5. one JSON line listing every kernel, then the card line, then the
     result line {"ok": true, "device": {...}}.

Each path's kernel launch counts are set to 0 just before it and read
just after it (phases 4, 4b, 4c, 4d, 4e, 6, 7; 4c's routed serving, its
spanning-head serving and its live serving each; 4d and 4e each as a
whole, ground truth and rebuilds included, and their serving runs alone:
in 4e the runtime's own batch_query calls, never the checks of them);
masked_l2_topk's launches in the kernels line are the sum over phases 4,
4b, 4c, 4d and 4e (serving runs).  Any failed check raises, so the script
exits non-zero and prints no result.  It needs a CUDA card and the repo's
``src/`` beside it, and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 2e-4        # distance band of the reference's kernel tests
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12   # fp32 outside the tensor cores, dense
QWEN = "qwen3-14b"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int, expect=None):
    """(device ms per call, CUDA kernels per call): the kernels' self time
    and count under torch.profiler over reps warm calls.  Back-to-back event
    timing of a call whose device work is shorter than its host-side enqueue
    measures the enqueue; this does not.  The profiler now and then drops
    kernel records, which only lowers the count (and the time): a window
    that saw fewer than `expect` kernels per call (by default, none at
    all) is profiled again, up to five times, and the window that saw the
    most kernels is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        per_call = sum(e.count for e in ka) / reps
        busy = sum(e.self_device_time_total for e in ka)
        if best is None or per_call > best[1]:
            best = (busy / 1e3 / reps, per_call)
        if per_call >= (expect if expect is not None else 1 / reps):
            break
    return best


def distance_band(q, d):
    """How far two fp32 evaluations of max(|q|^2 + |x|^2 - 2 q.x, 0) may
    differ for a query q and a distance d: the reference's 2e-4 band plus
    the cancellation of the expansion form, ~sqrt(dim) roundings of terms
    the size of |q|^2 + |x|^2 (about 2|q|^2 near the query)."""
    import numpy as np

    q2 = float(np.dot(q, q))
    return ATOL + RTOL * np.abs(d) + 4.0 * np.sqrt(q.size) * 2.0 ** -24 * 2.0 * q2


def same_up_to_ties(q, ids_a, d_a, ids_b, d_b) -> bool:
    """Two (1, k) top-k answers for query q agree: distances within the
    band, and any id in one but not the other sits at the k-th distance (a
    tie there, up to the band)."""
    import numpy as np

    fin = np.isfinite(d_b)
    if not np.array_equal(fin, np.isfinite(d_a)):
        return False
    if not np.all(np.abs(d_a[fin] - d_b[fin]) <= distance_band(q, d_b[fin])):
        return False
    diff = set(ids_a[0][ids_a[0] >= 0]) ^ set(ids_b[0][ids_b[0] >= 0])
    if not diff:
        return True
    kth = d_b[fin].max()
    near = np.concatenate([d_a[0][np.isin(ids_a[0], list(diff))],
                           d_b[0][np.isin(ids_b[0], list(diff))]])
    return bool(np.all(np.abs(near - kth) <= distance_band(q, kth)))


# ----------------------------------------------------------------------
# phase 2: build every kernel
# ----------------------------------------------------------------------
def build_kernels() -> dict:
    from repro_torch.kernels import masked_l2
    from repro_torch.kernels.decode_attention import build_library as decode_build

    builders = {"masked_l2_topk": masked_l2.build_library, "decode_attention": decode_build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {name: pool.submit(fn) for name, fn in builders.items()}
        libs = {name: f.result() for name, f in futs.items()}
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        print(f"[build] {name}: {lib.relative_to(ROOT)}")
    print(f"[build] {len(libs)} kernel(s) built in {secs:.2f} s", flush=True)
    return libs


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------
def kernel_checks(n_full: int, d: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import masked_l2
    from repro_torch.kernels.masked_l2 import BIG, masked_l2_topk_cuda
    from repro_torch.kernels.ref import masked_l2_topk_ref

    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = masked_l2.load_library()
    for qt in (1, 8) + masked_l2.TILED_QT:      # the wrapper's plan mirrors the .cu
        for k in (1, 10, 128):
            check(lib.masked_l2_topk_smem(qt, d, k) == masked_l2.smem_bytes(qt, d, k),
                  f"masked_l2_topk shared memory qt={qt} k={k}: .cu and plan differ")
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n_full, d), generator=g, device=dev)
    rows = {}
    max_err = 0.0
    for n in (n_full, 1 << 19, 16):
        x = corpus[:n]
        # the main path hands the kernel a ~half-passing mask over the full
        # corpus and an all-passing one over a gathered subset
        mask = (torch.rand(n, generator=g, device=dev) < 0.5) if n == n_full \
            else torch.ones(n, dtype=torch.bool, device=dev)
        n_pass = int(mask.sum())
        for b in ((1, 8, 16, 32, 64, 128, 256) if n == n_full else (1, 8, 64, 256)):
            q = torch.randn((b, d), generator=g, device=dev)
            pd, pi = masked_l2_topk_ref(q, x, mask, 128)
            for k in (1, 10, 128):
                plan = masked_l2.plan(b, n, d, k, n_sms)
                kd, ki = masked_l2_topk_cuda(q, x, mask, k)
                torch.cuda.synchronize()
                rd, ri = pd[:, :k], pi[:, :k]
                err = float((kd - rd).abs().max())
                close = torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
                agree = float((ki == ri).float().mean())
                check(close and agree > 0.95,
                      f"masked_l2_topk B={b} N={n} k={k} ({plan.path}): err {err} agree {agree}")
                max_err = max(max_err, err)
                if k != 10 and not (k == 128 and n == 16):
                    continue
                kk = min(k, n)
                reps = 3 if n == n_full and b >= 128 else 10
                ms = cuda_ms(lambda: masked_l2_topk_cuda(q, x, mask, k), reps)
                plain = cuda_ms(lambda: masked_l2_topk_ref(q, x, mask, k), 2 if n == n_full else 5)
                lib_ms = cuda_ms(lambda: l2_topk(q, x, kk, mask), 2 if n == n_full else 5)
                bytes_ = 4 * b * d + n + 4 * n_pass * d + 8 * b * k
                flops = 2 * b * n_pass * d + 2 * n_pass * d
                bound = 1e3 * max(bytes_ / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)
                by = "bytes" if bytes_ / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS else "operations"
                rows[(b, n, k)] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound,
                                       bound_by=by, max_abs_err=err, agree=agree, path=plan.path,
                                       qt=plan.qt, splits=plan.splits)
                print(f"[kernel] masked_l2_topk B={b} N={n} d={d} k={k} pass={n_pass}: "
                      f"{plan.path} path (QT {plan.qt}, {plan.splits} splits): "
                      f"kernel {ms:.4f} ms, plain {plain:.4f} ms, l2_topk {lib_ms:.4f} ms, "
                      f"bound {bound:.6g} ms ({by}), kernel / bound {ms / bound:.3f}, "
                      f"kernel / l2_topk {ms / lib_ms:.3f}, max_abs_err {err:.3g}, "
                      f"id agreement {agree:.4f}", flush=True)
    # all masked, a ragged last tile, padding never returned, lowest-id ties,
    # splits with no passing row: on the streaming path (B=8, a few
    # thousand rows) and on the tiled one (B=256, more than TILED_MIN_N)
    for b, n_e, n_r in ((8, 4096, 513), (256, 1 << 15, masked_l2.TILED_MIN_N + 129)):
        x = corpus[:n_e]
        q = torch.randn((b, d), generator=g, device=dev)
        path = masked_l2.plan(b, n_e, d, 10, n_sms).path
        check(path == ("streaming" if b == 8 else "tiled"), f"B={b} N={n_e} took the {path} path")
        kd, ki = masked_l2_topk_cuda(q, x, torch.zeros(n_e, dtype=torch.bool, device=dev), 10)
        check(bool((ki == -1).all()) and bool((kd == BIG).all()), f"all-masked case B={b}")
        kd, ki = masked_l2_topk_cuda(q, x[:n_r], torch.ones(n_r, dtype=torch.bool, device=dev), 128)
        rd, ri = masked_l2_topk_ref(q, x[:n_r], torch.ones(n_r, dtype=torch.bool, device=dev), 128)
        check(bool((ki < n_r).all()) and bool((ki >= 0).all())
              and float((ki == ri).float().mean()) > 0.95
              and torch.allclose(kd, rd, rtol=RTOL, atol=ATOL), f"ragged tail rows B={b} N={n_r}")
        half = n_e // 2
        dup = torch.cat([x[:half], x[:half]])            # row i and i + half tie
        ones = torch.ones(n_e, dtype=torch.bool, device=dev)
        kd, ki = masked_l2_topk_cuda(q, dup, ones, 10)
        rd, ri = masked_l2_topk_ref(q, dup, ones, 10)
        check(torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
              and bool((ki[:, 0::2] < half).all())
              and torch.equal(ki[:, 1::2], ki[:, 0::2] + half)
              and torch.equal(kd[:, 1::2], kd[:, 0::2]), f"ties go to the lowest id B={b}")
        sparse = torch.zeros(n_e, dtype=torch.bool, device=dev)
        sparse[n_e // 3: n_e // 3 + 300] = True           # most splits pass no row
        kd, ki = masked_l2_topk_cuda(q, x, sparse, 10)
        rd, ri = masked_l2_topk_ref(q, x, sparse, 10)
        check(float((ki == ri).float().mean()) > 0.95 and bool((ki >= n_e // 3).all())
              and bool((ki < n_e // 3 + 300).all()) and torch.allclose(kd, rd, rtol=RTOL, atol=ATOL),
              f"sparse mask B={b}: splits with no passing row")
    # row independence: a row alone (B=1, streaming) equals, bitwise, the
    # same row in a batch of 64 or 256 (tiled); repeated calls are bitwise equal
    for n, batch, picks in ((n_full, 64, (0, 9, 37, 63)), (n_full, 256, (0, 1, 100, 255)),
                            (1 << 19, 256, (0, 1, 100, 255))):
        mask = (torch.rand(n, generator=g, device=dev) < 0.5) if n == n_full \
            else torch.ones(n, dtype=torch.bool, device=dev)
        qb = torch.randn((batch, d), generator=g, device=dev)
        bd, bi = masked_l2_topk_cuda(qb, corpus[:n], mask, 10)
        path = masked_l2.plan(batch, n, d, 10, n_sms).path
        for r in picks:
            sd, si = masked_l2_topk_cuda(qb[r:r + 1].clone(), corpus[:n], mask, 10)
            check(torch.equal(sd[0], bd[r]) and torch.equal(si[0], bi[r]),
                  f"N={n}: row {r} alone differs from the same row in a batch of {batch} ({path})")
        if batch == 256:
            for _ in range(2):
                ad, ai = masked_l2_topk_cuda(qb, corpus[:n], mask, 10)
                check(torch.equal(ad, bd) and torch.equal(ai, bi),
                      f"N={n}: a repeated B=256 call differs")
    print("[kernel] all-masked, ragged tail, lowest-id ties, empty splits (streaming B=8 and "
          "tiled B=256); row independence "
          "(bitwise, B=1 against B=64 and 256 at N=2.14M, B=256 at N=2^19); repeated B=256 "
          "calls bitwise equal: ok", flush=True)
    del corpus
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": max_err}


# ----------------------------------------------------------------------
# phase 4: the main path
# ----------------------------------------------------------------------
def main_path(n_rows: int, n_train: int, n_serve: int, batch: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, FilteredANNEngine, gen_queries, recall_at_k
    from repro_torch.data import make_dataset
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ds = make_dataset("arxiv", "full" if n_rows == 2_140_000 else str(n_rows), seed=0)
    q_all, preds, _ = gen_queries(ds.vectors, ds.cat, ds.num, n_train + n_serve,
                                  kinds=ds.filter_kinds, seed=1)
    print(f"[main] arxiv {ds.vectors.shape} and {len(preds)} queries made in "
          f"{time.perf_counter() - t0:.1f} s (host set-up)", flush=True)

    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num, EngineConfig(device="cuda")).build()
    print(f"[main] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in eng.build_time_.items()), flush=True)

    qt, pt = q_all[:n_train], preds[:n_train]
    qs, ps = q_all[n_train:], preds[n_train:]
    eng.fit(qt, pt, k=10)
    mix = np.bincount(eng.labels_, minlength=2)
    print(f"[main] fit {eng.build_time_['fit']:.2f} s on {n_train} queries: labels "
          f"pre {mix[0]} / post {mix[1]}, planner CV AUC {eng.planner.val_auc_:.4f}, "
          f"chosen L2 {eng.planner.best_l2_}", flush=True)

    k = 10
    l0 = ops.kernel_launches()["masked_l2_topk"]
    served = [eng.query(qs[i], ps[i], k) for i in range(n_serve)]
    l1 = ops.kernel_launches()["masked_l2_topk"]
    t0 = time.perf_counter()
    batched = []
    for s in range(0, n_serve, batch):
        batched += eng.batch_query(qs[s : s + batch], ps[s : s + batch], k)
    batch_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    dispatch = ops.dispatch_counts()
    n_exact = sum(r.plan.strategy in ("pre", "ipre") for r in served)
    n_batches = -(-n_serve // batch)
    print(f"[main] masked_l2_topk launches: {l1 - l0} over {n_serve} query() calls "
          f"({n_exact} exact plans), {launches['masked_l2_topk'] - l1} over {n_batches} "
          f"batch_query() calls of {batch}", flush=True)

    # truth with distances, for the up-to-ties comparison
    vd = eng.vectors_dev
    def truth(i):
        m = torch.as_tensor(ps[i].eval(eng.cat, eng.num), device=vd.device)
        d, t = l2_topk(torch.as_tensor(qs[i:i + 1], device=vd.device), vd, k, m)
        return d.cpu().numpy(), t.cpu().numpy()

    by_plan: dict = {}
    recalls = []
    for i, (r, br) in enumerate(zip(served, batched)):
        check(r.result.ids.shape == (1, k) and np.isfinite(r.result.dists[r.result.ids >= 0]).all(),
              f"query {i}: malformed result")
        check(np.array_equal(r.result.ids, br.result.ids),
              f"query {i}: batch_query ids differ from query ids")
        check(np.array_equal(eng.ground_truth(qs[i], ps[i], k).shape, (1, k)), "ground_truth shape")
        td, ti = truth(i)
        s = r.plan.strategy
        by_plan.setdefault(s, []).append(r.result.elapsed)
        if s in ("pre", "ipre"):
            check(same_up_to_ties(qs[i], r.result.ids, r.result.dists, ti, td),
                  f"query {i} ({s}): exact plan {r.result.ids} {r.result.dists} differs "
                  f"from ground truth {ti} {td}")
        else:
            recalls.append(recall_at_k(r.result.ids, ti))
    print(f"[main] served {n_serve} queries: plans "
          + ", ".join(f"{s} {len(v)}" for s, v in sorted(by_plan.items())), flush=True)

    # every executor directly, whatever the planner chose
    direct = {}
    mask_s, pre_s = [], []
    for name, ex in (("pre", eng.pre_exec), ("ipre", eng.ipre_exec), ("post", eng.post_exec)):
        rec = []
        for i in range(8):
            if name == "post":
                res = ex.search(qs[i:i + 1], ps[i], k, est_selectivity=served[i].plan.est)
            else:
                res = ex.search(qs[i:i + 1], ps[i], k)
            td, ti = truth(i)
            if name == "post":
                rec.append(recall_at_k(res.ids, ti))
            else:
                check(same_up_to_ties(qs[i], res.ids, res.dists, ti, td),
                      f"{name}_exec query {i}: {res.ids} {res.dists} differs from "
                      f"ground truth {ti} {td}")
            if name == "pre":
                t1 = time.perf_counter()
                ps[i].eval(eng.cat, eng.num)
                mask_s.append(time.perf_counter() - t1)
                pre_s.append(res.elapsed)
        direct[name] = rec
    recalls += direct["post"]
    check(launches["masked_l2_topk"] > 0, "the main path launched masked_l2_topk no time")
    post_recall = float(np.mean(recalls)) if recalls else float("nan")
    mask_share = float(np.median(mask_s) / np.median(pre_s))
    print(f"[main] post recall@10 {post_recall:.4f} over {len(recalls)} queries; "
          f"exact plans equal ground truth up to ties; batch ids equal per-query ids", flush=True)
    for s, v in sorted(by_plan.items()):
        v = np.asarray(v) * 1e3
        print(f"[main] {s}: {len(v)} queries, p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms")
    print(f"[main] batch_query (batch {batch}): {n_serve / batch_s:.1f} QPS")
    print(f"[main] host columnar mask: median {np.median(mask_s) * 1e3:.3f} ms of a pre "
          f"query's median {np.median(pre_s) * 1e3:.3f} ms (share {mask_share:.3f})")
    print(f"[main] kernel launches {launches}; dispatches {dispatch}", flush=True)
    shared = shared_predicate_batch(eng, q_all, preds, k)
    where_time_goes(eng, qs, ps, served, k)
    return {"launches": launches, "post_recall": post_recall, "engine": eng, "ds": ds,
            "preds": ps, "qs": qs, "train": (qt, pt), "served": served, "shared": shared,
            "pre_ms": float(np.median(pre_s) * 1e3)}


def shared_predicate_batch(eng, q_all, preds, k: int, n: int = 256) -> dict:
    """Many queries under one predicate (a tenant or category filter over a
    batch) through the exact executors: 256 of phase 4's query vectors in
    one search() call, under the gen_queries predicate that passes the most
    rows (over 25 %: the full-corpus branch) and one that passes about 10 %
    (the gathered branch).  Each row must equal that query's B=1 search()
    bitwise, and ground truth up to ties."""
    import numpy as np
    import torch

    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    frac = np.array([p.eval(eng.cat, eng.num).mean() for p in preds])
    full, below = int(np.argmax(frac)), np.flatnonzero(frac < eng.pre_exec.FULL_SCAN_FRAC)
    gathered = int(below[np.argmin(np.abs(frac[below] - 0.1))])
    check(frac[full] > eng.pre_exec.FULL_SCAN_FRAC,
          f"no gen_queries predicate passes more than 25 % of the rows ({frac.max():.3f})")
    qb = np.ascontiguousarray(q_all[:n])
    vd = eng.vectors_dev
    out = {}
    for branch, i in (("full", full), ("gathered", gathered)):
        mask = preds[i].eval(eng.cat, eng.num)
        td, ti = l2_topk(torch.as_tensor(qb, device=vd.device), vd, k,
                         torch.as_tensor(mask, device=vd.device))
        td, ti = td.cpu().numpy(), ti.cpu().numpy()
        for name, ex in (("pre", eng.pre_exec), ("ipre", eng.ipre_exec)):
            ex.search(qb, preds[i], k)                      # warm: caches, allocator
            ops.reset_kernel_launches()
            t0 = time.perf_counter()
            res = ex.search(qb, preds[i], k)
            batch_s = time.perf_counter() - t0
            l_batch = ops.kernel_launches()["masked_l2_topk"]
            t0 = time.perf_counter()
            solo = [ex.search(qb[j:j + 1], preds[i], k) for j in range(n)]
            solo_s = time.perf_counter() - t0
            l_solo = ops.kernel_launches()["masked_l2_topk"] - l_batch
            check(l_batch == 1 and l_solo == n,
                  f"{name}_exec {branch}: {l_batch} launches for the batch, {l_solo} for {n} queries")
            for j in range(n):
                check(np.array_equal(res.ids[j], solo[j].ids[0]),
                      f"{name}_exec {branch} batch row {j}: {res.ids[j]} differs from the same "
                      f"query alone {solo[j].ids[0]}")
                check(same_up_to_ties(qb[j], res.ids[j:j + 1], res.dists[j:j + 1],
                                      ti[j:j + 1], td[j:j + 1]),
                      f"{name}_exec {branch} batch row {j} differs from ground truth")
            out[(name, branch)] = dict(batch_ms=batch_s * 1e3 / n, solo_ms=solo_s * 1e3 / n,
                                       pass_frac=float(frac[i]), launches=l_batch)
            print(f"[main] shared predicate ({branch} branch: gen_queries[{i}] passes "
                  f"{frac[i]:.4f}), {name}_exec, {n} queries: batched {batch_s * 1e3 / n:.4f} ms "
                  f"per query ({l_batch} masked_l2_topk launch), one at a time "
                  f"{solo_s * 1e3 / n:.4f} ms per query ({l_solo} launches); speedup "
                  f"{solo_s / batch_s:.1f}x; every row equals its query alone (ids, bitwise) and "
                  f"ground truth up to ties", flush=True)
    return out


def where_time_goes(eng, qs, ps, served, k: int, n: int = 40) -> None:
    """Device busy time against host wall time for each plan's executor,
    over n warm queries under torch.profiler, and the top device kernels."""
    profile_runs({
        "pre": lambda i: eng.pre_exec.search(qs[i:i + 1], ps[i], k),
        "ipre": lambda i: eng.ipre_exec.search(qs[i:i + 1], ps[i], k),
        "post": lambda i: eng.post_exec.search(qs[i:i + 1], ps[i], k,
                                               est_selectivity=served[i].plan.est),
    }, n)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_busy(dev, fn):
    """(fn(), host wall s, device busy s, device-side profiler rows) of one
    call under torch.profiler; busy is None off the card or when the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0, None, []
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        _sync(dev)
    wall = time.perf_counter() - t0
    # device-side events only: a CPU op's row repeats its kernels' time
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ka) / 1e6
    return out, wall, (busy if busy > 0 else None), ka


def profile_runs(runs: dict, n: int, tag: str = "time") -> None:
    """For each ``runs[name](i)``, i < n: device busy against host wall per
    call under torch.profiler (after a warm pass), the idle share, and the
    top device kernels."""
    import torch

    for name, run in runs.items():
        for i in range(n):          # warm: predicate cache, allocator
            run(i)
        _, wall, busy, ka = _device_busy(torch.device("cuda"),
                                         lambda: [run(i) for i in range(n)])
        if busy is None:
            print(f"[{tag}] {name}: device time not measured (profiler saw none)")
            continue
        wall, busy = wall * 1e3, busy * 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[{tag}] {name}: {n} queries, wall {wall / n:.3f} ms/query, device busy "
              f"{busy / n:.3f} ms/query, device idle share {1 - busy / wall:.3f}; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                          for e in top), flush=True)


# ----------------------------------------------------------------------
# phase 4b: DNF unions on the phase-4 engine
# ----------------------------------------------------------------------
def make_unions(ps, n: int = 64, pool: int = 24, seed: int = 4):
    """n Ors of 2-3 of phase 4's served predicates, drawn from the first
    `pool` of them so terms recur across unions; union 1 is union 0
    permuted and union 2 repeats a term."""
    import numpy as np

    from repro_torch.core import Or

    rng = np.random.default_rng(seed)
    terms = [[int(t) for t in rng.choice(pool, size=int(rng.integers(2, 4)), replace=False)]
             for _ in range(n)]
    terms[1] = terms[0][::-1]
    terms[2] = terms[2][:2] + terms[2][:1]
    return [Or(tuple(ps[t] for t in ts)) for ts in terms]


def exact_plan(plan) -> bool:
    from repro_torch.core import INDEXED_PRE, PRE_FILTER

    return all(c.decision in (PRE_FILTER, INDEXED_PRE) for c in plan.clauses)


class TruthMemo:
    """Exact top-k with distances over a clean engine's device corpus
    (``l2_topk``, independent of the serving path), one per (query, pred)."""

    def __init__(self, eng, k: int):
        self.eng, self.k, self.memo = eng, k, {}

    def __call__(self, q, pred):
        import numpy as np
        import torch

        from repro_torch.index.flat import l2_topk

        key = (np.asarray(q, np.float32).tobytes(), id(pred))
        if key not in self.memo:
            vd = self.eng.vectors_dev
            m = torch.as_tensor(pred.eval(self.eng.cat, self.eng.num), device=vd.device)
            d, i = l2_topk(torch.as_tensor(np.atleast_2d(q), device=vd.device), vd, self.k, m)
            self.memo[key] = (d.cpu().numpy(), i.cpu().numpy())
        return self.memo[key]


def check_rows(eng, qs, preds, served, batched, k: int, tag: str, truth_of=None) -> dict:
    """Every id passes its predicate, once; batch_query rows equal query
    rows; rows that `truth_of` selects equal ground truth up to ties.
    Returns per-row recall@10 against ground truth."""
    import numpy as np

    from repro_torch.core import recall_at_k

    truth = TruthMemo(eng, k)
    recalls = []
    for i, (r, br) in enumerate(zip(served, batched)):
        mask = preds[i].eval(eng.cat, eng.num)
        ids = r.result.ids[0][r.result.ids[0] >= 0]
        check(r.result.ids.shape == (1, k) and bool(mask[ids].all()),
              f"{tag} {i}: an id fails its predicate {preds[i]}")
        check(len(set(ids.tolist())) == ids.size, f"{tag} {i}: an id came back twice: {ids}")
        check(np.array_equal(r.result.ids, br.result.ids),
              f"{tag} {i}: batch_query ids {br.result.ids} differ from query ids {r.result.ids}")
        td, ti = truth(qs[i], preds[i])
        check(np.array_equal(eng.ground_truth(qs[i], preds[i], k).shape, (1, k)), "ground_truth shape")
        if truth_of is not None and truth_of(r):
            check(same_up_to_ties(qs[i], r.result.ids, r.result.dists, ti, td),
                  f"{tag} {i} ({r.plan.strategy}): {r.result.ids} {r.result.dists} differs from "
                  f"ground truth {ti} {td}")
        recalls.append(recall_at_k(r.result.ids, ti))
    return {"recall": recalls}


def dnf_phase(mp: dict, k: int = 10, batch: int = 64) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import STRATEGY_NAMES
    from repro_torch.kernels import ops

    eng, qs, ps, served4 = mp["engine"], mp["qs"], mp["preds"], mp["served"]
    unions = make_unions(ps)
    n = len(unions)
    uq = np.ascontiguousarray(qs[:n])
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(uq[j], unions[j], k) for j in range(n)]
    l_query = ops.kernel_launches()["masked_l2_topk"]
    # unions interleaved with phase 4's conjunctions, in batches of 64
    mixed_q = np.stack([x for j in range(n) for x in (uq[j], qs[n + j])])
    mixed_p = [x for j in range(n) for x in (unions[j], ps[n + j])]
    batched = []
    for s in range(0, len(mixed_p), batch):
        batched += eng.batch_query(mixed_q[s:s + batch], mixed_p[s:s + batch], k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the DNF path launched masked_l2_topk no time")
    check(served[1].plan is served[0].plan and served[0].plan.is_dnf,
          "the permuted Or did not hit union 0's plan-cache entry")
    check(served[2].plan.n_clauses == 2, "the Or with a repeated term did not collapse it")
    for j in range(n):
        conj = batched[2 * j + 1]
        check(np.array_equal(conj.result.ids, served4[n + j].result.ids),
              f"conjunction {n + j} in a mixed batch differs from its phase-4 query")
    rows = check_rows(eng, uq, unions, served, batched[0::2], k, "union", truth_of=lambda r:
                      exact_plan(r.plan))
    # all-exact unions against ONE fused masked top-k over the union mask
    # (comparison launches, after the counts were read)
    vd = eng.vectors_dev
    n_exact = n_bitwise = 0
    for j, r in enumerate(served):
        if not exact_plan(r.plan):
            continue
        n_exact += 1
        m = torch.as_tensor(unions[j].eval(eng.cat, eng.num), device=vd.device)
        d, i = ops.fused_masked_topk(torch.as_tensor(uq[j:j + 1], device=vd.device), vd, m, k)
        n_bitwise += int(np.array_equal(i.cpu().numpy(), r.result.ids)
                         and np.array_equal(d.cpu().numpy(), r.result.dists))
    clause_mix: dict = {}
    by_size: dict = {}
    for r in served:
        for c in r.plan.clauses:
            key = STRATEGY_NAMES[c.decision]
            clause_mix[key] = clause_mix.get(key, 0) + 1
        by_size.setdefault(r.plan.n_clauses, []).append(r.result.elapsed * 1e3)
    approx = [x for x, r in zip(rows["recall"], served) if not exact_plan(r.plan)]
    print(f"[dnf] {n} unions of 2-3 phase-4 predicates: clause plans "
          + ", ".join(f"{s} {c}" for s, c in sorted(clause_mix.items()))
          + f"; {n_exact} all-exact unions equal ground truth up to ties, {n_bitwise} of them equal "
          f"one fused_masked_topk over the union mask bitwise; unions with a post clause: "
          f"{len(approx)}, recall@10 {np.mean(approx) if approx else float('nan'):.4f}", flush=True)
    for size, v in sorted(by_size.items()):
        print(f"[dnf] {size} clause(s): {len(v)} unions, query() p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms", flush=True)
    print(f"[dnf] masked_l2_topk launches {l_query} over {n} query() calls "
          f"({l_query / n:.2f} per union), {launches['masked_l2_topk'] - l_query} over "
          f"{-(-len(mixed_p) // batch)} mixed batch_query() calls; every id passes its union once; "
          f"batch rows equal query rows; the permuted Or hit the plan cache", flush=True)
    return {"launches": launches, "unions": unions, "n_exact": n_exact, "n_bitwise": n_bitwise,
            "clause_mix": clause_mix}


# ----------------------------------------------------------------------
# phase 4c: a routed engine (flat, ivf, ivfpq, acorn) at full size
# ----------------------------------------------------------------------
BACKENDS = ("flat", "ivf", "ivfpq", "acorn")
# phase 4c fits on the first 16 of phase 4's training queries: each one
# races both ACORN tiers with the host beam search, which took 3.6-13.2 s a
# training query at 2.14M rows on an H100; at 32 the fit reached 357 s and
# the script 1,034 s of its 1,200 s (PERF.md section 4)
ROUTED_TRAIN = 16


def threshold_head(sel_cut: float) -> dict:
    """Planner state (the reference's format) whose plan head says post iff
    the estimated selectivity exceeds ``sel_cut``."""
    import numpy as np

    from repro_torch.core import PlannerFeatures

    f = PlannerFeatures.N_FEATURES - 1
    p = {"w1": np.zeros((f, 64), np.float32), "b1": np.zeros(64, np.float32),
         "w2": np.zeros((64, 32), np.float32), "b2": np.zeros(32, np.float32),
         "w3": np.zeros((32, 2), np.float32), "b3": np.zeros(2, np.float32)}
    p["w1"][PlannerFeatures.SEL_COL, 0] = 1.0
    p["w2"][0, 0] = 1.0
    p["w3"][0, 1] = 1.0
    p["b3"][0] = 1.0
    mu, sigma = np.zeros(f, np.float32), np.ones(f, np.float32)
    mu[PlannerFeatures.SEL_COL], sigma[PlannerFeatures.SEL_COL] = sel_cut - 0.01, 0.01
    return {"params": p, "mu": mu, "sigma": sigma,
            "meta": np.asarray([PlannerFeatures.N_FEATURES, 0], np.int32)}


def spanning_routes(eng, qs, ps, k: int, per_class: int = 2) -> dict:
    """Serve through a routing head that spans every class: a plan head
    that sends every row post, and a routing head fitted on the served
    predicates' features with labels cycled over the classes in order of
    estimated selectivity (as the CPU tests' routed engine).  Then up to
    ``per_class`` rows routed to each class go through query() and one
    batch_query(), so the routed groups of every backend run on the card."""
    import numpy as np

    from repro_torch.kernels import ops

    names = eng.backend_set.class_names()
    eng.planner.load_state(threshold_head(-1.0))
    ests = [eng.estimator.estimate(p) for p in ps]
    feats = np.stack([eng.feat.vector(p, se.sel, k, se.is_exact) for p, se in zip(ps, ests)])
    order = np.argsort([se.sel for se in ests], kind="stable")
    labels = np.empty(len(ps), np.int64)
    labels[order] = np.arange(len(ps)) * len(names) // len(ps)
    eng.planner.fit_routing(feats, labels, names)
    plans = eng.make_plan_batch(ps, k)[0]
    rows: dict = {}
    for i, plan in enumerate(plans):
        rows.setdefault(plan.clauses[0].route, []).append(i)
    pick = sorted(i for r, v in rows.items() if r >= 0 for i in v[:per_class])
    sq = np.ascontiguousarray(qs[pick])
    sp = [ps[i] for i in pick]
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(sq[j], sp[j], k) for j in range(len(sp))]
    batched = eng.batch_query(sq, sp, k)
    launches = ops.kernel_launches()
    dispatches = ops.dispatch_counts()
    check_rows(eng, sq, sp, served, batched, k, "spanning", truth_of=lambda r: (
        r.result.backend, r.result.knob) == ("flat", "exact"))
    got = {r.result.backend for r in served}
    check(got == set(eng.backend_set.backends),
          f"the spanning routing head served backends {sorted(got)} only")
    for nm in eng.backend_set.backends:
        check(dispatches.get(f"backend_{nm}", 0) > 0, f"no routed group ran on backend {nm}")
    mix: dict = {}
    for r in served:
        key = f"{r.result.backend}:{r.result.knob}"
        mix[key] = mix.get(key, 0) + 1
    print(f"[routed] spanning routing head: {len(sp)} rows routed "
          + ", ".join(f"{key} {c}" for key, c in sorted(mix.items()))
          + f" ({len([r for r in rows if r >= 0])} of {len(names)} classes routed over "
          f"{len(ps)} predicates) through query() and one batch_query(): every id passes its "
          f"predicate once, flat:exact rows equal ground truth up to ties, batch rows equal "
          f"query rows; kernel launches {launches}; dispatches {dispatches}", flush=True)
    return {"launches": launches, "mix": mix, "qs": sq, "preds": sp}


def tiny_flat_check(k: int = 10) -> None:
    """Below TINY_N rows on the card the flat backend runs the kernel,
    equal to the reference's numpy scan up to exact ties (comparison
    launches, outside every counted path)."""
    import numpy as np

    from repro_torch.index.registry import TINY_N, _exact_masked, make_backend
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    for n in (1, 9, TINY_N - 1):
        x = rng.normal(0, 1, (n, 384)).astype(np.float32)
        q = rng.normal(0, 1, (4, 384)).astype(np.float32)
        mask = rng.random(n) < 0.7
        before = ops.kernel_launches()["masked_l2_topk"]
        d, i = make_backend("flat", x, device="cuda").search_masked(q, mask, k)
        check(ops.kernel_launches()["masked_l2_topk"] == before + 1,
              f"the flat backend at {n} rows did not launch masked_l2_topk")
        want_d, want_i = _exact_masked(x, q, mask, k)
        for j in range(len(q)):
            check(same_up_to_ties(q[j], i[j:j + 1], d[j:j + 1], want_i[j:j + 1], want_d[j:j + 1]),
                  f"flat backend at {n} rows, query {j}: {i[j]} {d[j]} differ from the numpy "
                  f"scan {want_i[j]} {want_d[j]}")
    print(f"[routed] flat backend below TINY_N ({TINY_N}) rows on the card: the kernel equals "
          f"the numpy scan up to ties at 1, 9 and {TINY_N - 1} rows", flush=True)


def routed_phase(mp: dict, unions: list, k: int = 10, n_train: int = ROUTED_TRAIN,
                 n_unions: int = 32, n_fixed: int = 32, batch: int = 64) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import EngineConfig, FilteredANNEngine, recall_at_k
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops

    ds, qs, ps = mp["ds"], mp["qs"], mp["preds"]
    qt, pt = mp["train"]
    tiny_flat_check(k)
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = FilteredANNEngine(ds.vectors, ds.cat, ds.num,
                            EngineConfig(device="cuda", backends=BACKENDS)).build()
    torch.cuda.synchronize()
    bs = eng.backend_set
    print(f"[routed] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k_} {v:.3f} s" for k_, v in eng.build_time_.items())
          + "; memory_bytes " + ", ".join(f"{nm} {b / 1e9:.3f} GB" for nm, b in bs.memory_bytes().items())
          + f" (ivfpq re-rank vectors {bs.backends['ivfpq'].rerank_bytes / 1e9:.3f} GB apart; "
          f"ivf shares the engine's IVF: {bs.backends['ivf'].index is eng.ivf}); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card", flush=True)
    eng.fit(qt[:n_train], pt[:n_train], k=k)
    names = bs.class_names()
    rl = np.bincount(eng.route_labels_, minlength=len(names))
    pl = np.bincount(eng.labels_, minlength=2)
    print(f"[routed] fit {eng.build_time_['fit']:.2f} s on {n_train} queries: labels pre {pl[0]} / "
          f"post {pl[1]}; route labels " + ", ".join(f"{nm} {c}" for nm, c in zip(names, rl)),
          flush=True)
    uq = np.ascontiguousarray(qs[:n_unions])
    all_q = np.concatenate([qs, uq])
    all_p = list(ps) + list(unions[:n_unions])
    served = [eng.query(all_q[i], all_p[i], k) for i in range(len(all_p))]
    batched = []
    for s in range(0, len(all_p), batch):
        batched += eng.batch_query(all_q[s:s + batch], all_p[s:s + batch], k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the routed engine launched masked_l2_topk no time")

    def flat_exact(r):
        return r.plan.is_dnf and exact_plan(r.plan) or (r.result.backend, r.result.knob) == ("flat", "exact")

    check_rows(eng, all_q, all_p, served, batched, k, "routed", truth_of=flat_exact)
    mix: dict = {}
    for r in served:
        for c in r.plan.clauses:
            key = f"{('pre', 'post', 'ipre')[c.decision]}/{c.backend}:{c.knob}"
            mix.setdefault(key, []).append(r.result.elapsed * 1e3 if not r.plan.is_dnf else None)
    print(f"[routed] served {len(ps)} queries + {n_unions} unions: every id passes its predicate "
          f"once; flat:exact rows and all-exact unions equal ground truth up to ties; batch rows "
          f"equal query rows; clause mix (decision/backend:knob) "
          + ", ".join(f"{key} {len(v)}" for key, v in sorted(mix.items())), flush=True)
    for key, v in sorted(mix.items()):
        v = np.asarray([x for x in v if x is not None])
        if v.size:
            print(f"[routed] {key}: {v.size} conjunctions, query() p50 {np.percentile(v, 50):.3f} ms, "
                  f"p99 {np.percentile(v, 99):.3f} ms", flush=True)
    dnf_ms = [r.result.elapsed * 1e3 for r in served if r.plan.is_dnf]
    print(f"[routed] unions: query() p50 {np.percentile(dnf_ms, 50):.3f} ms, p99 "
          f"{np.percentile(dnf_ms, 99):.3f} ms", flush=True)
    # every class directly on n_fixed fixed queries, against ground truth
    vd = eng.vectors_dev
    masks = [ps[i].eval(eng.cat, eng.num) for i in range(n_fixed)]
    truth = [l2_topk(torch.as_tensor(qs[i:i + 1], device=vd.device), vd, k,
                     torch.as_tensor(masks[i], device=vd.device))[1].cpu().numpy()
             for i in range(n_fixed)]
    recalls, host_ids = {}, {}
    for ci, nm in enumerate(names):
        rec, ms, out = [], [], []
        for i in range(n_fixed):
            t1 = time.perf_counter()
            _, ids = bs.search_class(ci, qs[i:i + 1], masks[i], k)
            ms.append((time.perf_counter() - t1) * 1e3)
            valid = ids[ids >= 0]
            check(bool(masks[i][valid].all()), f"{nm} query {i}: an id fails its predicate")
            check(len(set(valid.tolist())) == valid.size, f"{nm} query {i}: an id came back twice")
            rec.append(recall_at_k(ids, truth[i]))
            out.append(ids)
        recalls[nm], host_ids[nm] = float(np.mean(rec)), (out, ms)
        floor = bs.recall_floor(ci)
        print(f"[routed] {nm}: every id passes its mask once; recall@10 {recalls[nm]:.4f} over "
              f"{n_fixed} queries (floor {floor}"
              f"{'' if recalls[nm] >= floor else ', BELOW'}), search_class p50 "
              f"{np.median(ms):.3f} ms, mean {np.mean(ms):.3f} ms", flush=True)
    # ACORN's device search against its host search (acorn:fast is ef 64)
    acorn = bs.backends["acorn"].index
    hi, host_ms = host_ids["acorn:fast"]
    agree, rt, t_torch = [], [], 0.0
    for i in range(n_fixed):
        t1 = time.perf_counter()
        _, ti_ = acorn.search_torch(qs[i:i + 1], k, ef=64, mask=masks[i])
        ti_ = ti_.cpu().numpy()
        t_torch += time.perf_counter() - t1
        agree.append(recall_at_k(ti_, hi[i]))
        rt.append(recall_at_k(ti_, truth[i]))
    print(f"[routed] acorn search_torch (ef 64) against search: recall of search's ids "
          f"{np.mean(agree):.4f}; against ground truth {np.mean(rt):.4f} vs search "
          f"{recalls['acorn:fast']:.4f}; {t_torch * 1e3 / n_fixed:.1f} vs {np.mean(host_ms):.1f} ms "
          f"per query (mean)", flush=True)
    print(f"[routed] kernel launches {launches}; dispatches {ops.dispatch_counts()}", flush=True)
    span = spanning_routes(eng, qs, ps, k)
    live = routed_live(eng, span["qs"], span["preds"], k)
    total = {nm: launches[nm] + span["launches"][nm] + live["launches"][nm] for nm in launches}
    return {"launches": total, "recalls": recalls, "engine": eng, "live_launches": live["launches"]}


# ----------------------------------------------------------------------
# phase 4d: the live corpus and sharded serving at full size
# ----------------------------------------------------------------------
TOMBSTONE_FRACS = (0.02, 0.05, 0.10)   # benchmarks/mutation_bench.py's churn mix
SEG_FRAC = 0.02


def live_truth(eng, q, pred, k: int):
    """Exact top-k over the LIVE rows, independent of the serving path:
    ``l2_topk`` over the base rows (tombstones masked out) and over the
    segment's device rows, merged base part first, with distances."""
    import numpy as np
    import torch

    from repro_torch.dist import merge_topk
    from repro_torch.index.flat import l2_topk

    live, vd = eng.live, eng.vectors_dev
    alive = live.alive_mask()
    qt = torch.as_tensor(np.atleast_2d(q), device=vd.device)
    m = torch.as_tensor(pred.eval(eng.cat, eng.num) & alive[:live.base_n], device=vd.device)
    d, i = (t.cpu().numpy() for t in l2_topk(qt, vd, k, m))
    sm = pred.eval(live.seg_cat(), live.seg_num()) & alive[live.base_n:]
    if sm.any():
        sd, si = (t.cpu().numpy() for t in l2_topk(qt, live.seg_vectors_dev(), min(k, live.seg_n),
                                                    torch.as_tensor(sm, device=vd.device)))
        si = np.where(si >= 0, si + live.base_n, -1).astype(np.int32)
        d, i = merge_topk(np.stack([d, np.pad(sd, ((0, 0), (0, k - sd.shape[1])),
                                               constant_values=np.inf)]),
                          np.stack([i, np.pad(si, ((0, 0), (0, k - si.shape[1])),
                                              constant_values=-1)]), k)
    return d, i


def check_live_row(eng, q, pred, r, k: int, tag: str, exact: bool = False) -> None:
    """One row served over a mutated corpus: no tombstoned id, every id
    passes its predicate once; an ``exact`` row equals the live
    ground_truth bitwise and the independent live truth up to ties."""
    import numpy as np

    live = eng.live
    ids = r.result.ids[0][r.result.ids[0] >= 0]
    check(not live.is_deleted(ids).any(), f"{tag}: a tombstoned id came back: {ids}")
    c, m = live.row_attrs(ids)
    check(r.result.ids.shape == (1, k) and bool(pred.eval(c, m).all()),
          f"{tag}: an id fails its predicate {pred}")
    check(len(set(ids.tolist())) == ids.size, f"{tag}: an id came back twice: {ids}")
    if not exact:
        return
    gt = eng.ground_truth(q, pred, k)
    check(np.array_equal(r.result.ids, gt),
          f"{tag} ({r.plan.strategy}): {r.result.ids} differs from the live ground_truth {gt}")
    td, ti = live_truth(eng, q, pred, k)
    check(same_up_to_ties(np.asarray(q, np.float32), r.result.ids, r.result.dists, ti, td),
          f"{tag} ({r.plan.strategy}): {r.result.ids} {r.result.dists} differs from the live "
          f"truth {ti} {td}")


def check_live_rows(eng, qs, preds, served, batched, k: int, tag: str, exact_of=None) -> dict:
    """Rows served over a mutated corpus (``check_live_row``, exact where
    ``exact_of`` says), and batch rows equal query rows bitwise.  With
    ``exact_of``, returns recall@10 of the other rows against the live
    truth."""
    import numpy as np

    from repro_torch.core import recall_at_k

    recalls, n_exact = [], 0
    for i, (r, br) in enumerate(zip(served, batched)):
        check(np.array_equal(r.result.ids, br.result.ids),
              f"{tag} {i}: batch_query ids {br.result.ids} differ from query ids {r.result.ids}")
        exact = exact_of is not None and bool(exact_of(r))
        check_live_row(eng, qs[i], preds[i], r, k, f"{tag} {i}", exact)
        n_exact += exact
        if exact_of is not None and not exact:
            recalls.append(recall_at_k(r.result.ids, live_truth(eng, qs[i], preds[i], k)[1]))
    return {"recall": recalls, "n_exact": n_exact}


def routed_live(eng, qs, ps, k: int) -> dict:
    """Phase 4c's routed engine after churn: 2 % of the base rows deleted,
    0.5 % new rows upserted, then the spanning head's rows (2 per class)
    through query() and batch_query()."""
    import numpy as np

    from repro_torch.kernels import ops

    n = eng.live.base_n
    rng = np.random.default_rng(23)
    eng.delete(rng.choice(n, int(0.02 * n), replace=False))
    rows = rng.choice(n, int(0.005 * n), replace=False)
    noise = (0.01 * rng.standard_normal((rows.size, eng.vectors.shape[1]))).astype(np.float32)
    eng.upsert(eng.vectors[rows] + noise, eng.cat[rows], eng.num[rows])
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    served = [eng.query(qs[j], ps[j], k) for j in range(len(ps))]
    batched = eng.batch_query(qs, ps, k)
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "the live routed path launched masked_l2_topk no time")
    out = check_live_rows(eng, qs, ps, served, batched, k, "routed live", exact_of=lambda r: (
        r.result.backend, r.result.knob) == ("flat", "exact"))
    got = {r.result.backend for r in served}
    print(f"[live] routed engine after deleting {eng.live.n_deleted} base rows and upserting "
          f"{eng.live.seg_n}: the spanning head's {len(ps)} rows on backends {sorted(got)} through "
          f"query() and batch_query(): no tombstoned id, every id passes its predicate once, "
          f"{out['n_exact']} flat:exact rows equal the live ground truth; kernel launches "
          f"{launches}; dispatches {ops.dispatch_counts()}", flush=True)
    return {"launches": launches}


def _pct(v):
    import numpy as np

    v = np.asarray(v) * 1e3
    return np.percentile(v, 50), np.percentile(v, 99)


def serve_level(eng, sh, qs, ps, k: int, batch: int, tag: str, base_p50: dict) -> dict:
    """Phase 4's served queries through query() and batch_query() on the
    central and the sharded engine, with the gated row checks; prints the
    latency per plan against phase 4's, the plan mix and post recall."""
    import numpy as np

    qps, plan_qps = {}, {}

    def run(e, name):
        served = [e.query(qs[i], ps[i], k) for i in range(len(ps))]
        batched = []
        t0 = time.perf_counter()
        for s in range(0, len(ps), batch):
            batched += e.batch_query(qs[s:s + batch], ps[s:s + batch], k)
        qps[name] = len(ps) / (time.perf_counter() - t0)
        # batch_query QPS over the rows of each plan alone, beside query()'s
        # serial QPS on the same rows
        by: dict = {}
        for i, r in enumerate(served):
            by.setdefault(r.plan.strategy, []).append(i)
        for plan, rows in sorted(by.items()):
            t0 = time.perf_counter()
            for s in range(0, len(rows), batch):
                idx = rows[s:s + batch]
                e.batch_query(qs[idx], [ps[j] for j in idx], k)
            serial = len(rows) / sum(served[j].result.elapsed for j in rows)
            plan_qps[name, plan] = (len(rows) / (time.perf_counter() - t0), serial)
        return served, batched

    def exact(r):
        return r.plan.strategy in ("pre", "ipre")

    from repro_torch.kernels import ops

    l0 = ops.kernel_launches()["masked_l2_topk"]
    c_served, c_batched = run(eng, "central")
    l1 = ops.kernel_launches()["masked_l2_topk"]
    s_served, s_batched = run(sh, "sharded")
    l2 = ops.kernel_launches()["masked_l2_topk"]
    rows = check_live_rows(eng, qs, ps, c_served, c_batched, k, f"{tag} central", exact)
    check_live_rows(eng, qs, ps, s_served, s_batched, k, f"{tag} sharded")
    for i, (c, s_) in enumerate(zip(c_served, s_served)):
        check(c.plan.strategy == s_.plan.strategy, f"{tag} {i}: plans differ")
        if exact(c):
            check(np.array_equal(c.result.ids, s_.result.ids)
                  and np.array_equal(c.result.dists, s_.result.dists),
                  f"{tag} {i}: sharded exact row {s_.result.ids} differs from the central "
                  f"{c.result.ids}")
    mix: dict = {}
    for name, served in (("central", c_served), ("sharded", s_served)):
        by: dict = {}
        for r in served:
            by.setdefault(r.plan.strategy, []).append(r.result.elapsed)
        for plan, v in sorted(by.items()):
            p50, p99 = _pct(v)
            print(f"[live] {tag} {name} {plan}: {len(v)} queries, query() p50 {p50:.3f} ms "
                  f"(x{p50 / base_p50[plan]:.2f} phase 4's), p99 {p99:.3f} ms", flush=True)
        mix[name] = {p: len(v) for p, v in by.items()}
    rec = float(np.mean(rows["recall"])) if rows["recall"] else float("nan")
    print(f"[live] {tag}: plan mix {mix['central']}; post recall@10 against the live truth "
          f"{rec:.4f} over {len(rows['recall'])}; {rows['n_exact']} exact rows equal the live "
          f"ground truth (bitwise) and the independent truth (up to ties), the sharded exact rows "
          f"equal the central ones bitwise, batch rows equal query rows; batch_query (batch "
          f"{batch}) {qps['central']:.1f} QPS central, {qps['sharded']:.1f} sharded; masked_l2_topk "
          f"launches serving {l1 - l0} central, {l2 - l1} sharded", flush=True)
    print(f"[live] {tag}: batch_query QPS by plan (query() serial QPS on the same rows): "
          + "; ".join(f"{name} {plan} {b:.1f} ({q1:.1f})"
                      for (name, plan), (b, q1) in sorted(plan_qps.items())), flush=True)
    return {"exact": [(i, c.result.ids, c.result.dists) for i, c in enumerate(c_served)
                      if exact(c)], "launches": l2 - l0}


def live_index_check(eng, qs, ps, k: int, n: int = 16, n_plain: int = 8) -> int:
    """LiveIndex over the flat backend on the engine's device corpus and its
    live corpus (segment + tombstones), one predicate mask per query: equal
    bitwise to one kernel scan over base + segment under the same live mask,
    and on its first n_plain queries to the plain version over the same rows
    on the host (ids up to ties, distances within the band).  Returns the
    LiveIndex's own masked_l2_topk launches."""
    import numpy as np
    import torch

    from repro_torch.index import LiveIndex, make_backend
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import fused_masked_topk

    live = eng.live
    check(live.seg_n > 0 and live.n_deleted > 0, "LiveIndex check needs a segment and tombstones")
    li = LiveIndex(make_backend("flat", eng.vectors_dev, device="cuda"), live)
    cat = np.concatenate([live.base_cat, live.seg_cat()])
    num = np.concatenate([live.base_num, live.seg_num()])
    x_all = torch.cat([eng.vectors_dev, live.seg_vectors_dev()])
    x_host = x_all.cpu()
    alive = live.alive_mask()
    launches = 0
    for i in range(n):
        m = ps[i].eval(cat, num)
        l0 = ops.kernel_launches()["masked_l2_topk"]
        d, ids = li.search_masked(qs[i:i + 1], m, k)
        launches += ops.kernel_launches()["masked_l2_topk"] - l0
        mt = torch.as_tensor(m & alive)
        q = torch.as_tensor(qs[i:i + 1])
        wd, wi = fused_masked_topk(q.cuda(), x_all, mt.cuda(), k)
        wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
        check(np.array_equal(ids, wi) and np.array_equal(d, wd),
              f"LiveIndex row {i}: {ids} {d} differs from one scan of the live rows {wi} {wd}")
        check(not live.is_deleted(ids[ids >= 0]).any(), f"LiveIndex row {i}: a dead id")
        if i < n_plain:
            pd, pi = fused_masked_topk(q, x_host, mt, k)
            check(same_up_to_ties(qs[i], ids, d, pi.numpy(), pd.numpy()),
                  f"LiveIndex row {i}: {ids} {d} differs from the plain version "
                  f"{pi.numpy()} {pd.numpy()}")
    check(launches == 2 * n, f"LiveIndex launched masked_l2_topk {launches} times for {n} "
                             "searches, not one base and one segment scan each")
    print(f"[live] LiveIndex(flat) over {live.base_n} base rows, {live.seg_n} segment rows and "
          f"{live.n_deleted} tombstones: {n} searches equal one kernel scan of the live rows "
          f"bitwise and, on {n_plain}, the plain version up to ties; masked_l2_topk launches "
          f"{launches}", flush=True)
    del x_all, x_host, li
    torch.cuda.empty_cache()
    return launches


def live_phase(mp: dict, k: int = 10, batch: int = 64, n_shards: int = 4) -> dict:
    import gc

    import numpy as np
    import torch

    from repro_torch import carry
    from repro_torch.core import EngineConfig, FilteredANNEngine
    from repro_torch.dist import HeartbeatMonitor, replan_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve import ShardedANNEngine

    ds, qs, ps, eng4 = mp["ds"], mp["qs"], mp["preds"], mp["engine"]
    base_p50 = {}
    for r in mp["served"]:
        base_p50.setdefault(r.plan.strategy, []).append(r.result.elapsed)
    # phase 4's p50 per plan; pre, which its planner seldom picks, is the
    # pre executor's median over phase 4's direct runs
    base_p50 = {p: _pct(v)[0] for p, v in base_p50.items()}
    base_p50.setdefault("pre", mp["pre_ms"])
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    eng = carried_engine(eng4)
    t1 = time.perf_counter()
    sh = ShardedANNEngine(eng, n_shards=n_shards)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    views = all(s.pre_exec.vectors.data_ptr() == eng.vectors_dev[int(s.ids[0])].data_ptr()
                for s in sh.shards)
    check(views, "a shard's device rows are not a view of the engine's corpus")
    print(f"[live] plain engine {t1 - t0:.2f} s (build + carried planner, GBM and IVF layout), "
          f"{n_shards} shards {t2 - t1:.2f} s (views of the device corpus, an IVF each); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)

    # the segment: fresh rows, ids= replacements of live rows, and exact
    # copies of the base rows phase 4's exact plans returned first
    n, dim = eng.vectors.shape
    rng = np.random.default_rng(31)
    n_seg = int(SEG_FRAC * n)
    top = np.unique([r.result.ids[0, j] for r in mp["served"] if r.plan.strategy in ("pre", "ipre")
                     for j in range(3) if r.result.ids[0, j] >= 0])
    copies = top[:600]
    check(copies.size >= 64, f"only {copies.size} base rows to copy")
    protected = np.zeros(n, bool)
    protected[copies] = True
    pool = rng.permutation(np.flatnonzero(~protected))
    replace = pool[: n_seg // 50]
    pool = pool[replace.size:]
    src = rng.choice(n, max(0, n_seg - copies.size - replace.size))
    fresh_v = (eng.vectors[src] + 0.05 * rng.standard_normal((src.size, dim))).astype(np.float32)
    t0 = time.perf_counter()
    sh.upsert(eng.vectors[replace] + 0.01, eng.cat[replace], eng.num[replace], ids=replace)
    copy_h = sh.upsert(eng.vectors[copies], eng.cat[copies], eng.num[copies])
    for part in np.array_split(np.arange(src.size), 8):
        sh.upsert(fresh_v[part], eng.cat[src[part]], eng.num[src[part]])
    up_s = time.perf_counter() - t0
    n_up = eng.live.seg_n
    del_s, deleted = 0.0, replace.size
    exact_before = None
    serving = 0     # masked_l2_topk launches of the serving runs alone
    for frac in TOMBSTONE_FRACS:
        target = int(frac * n)
        kill = pool[: target - deleted]
        pool = pool[kill.size:]
        t0 = time.perf_counter()
        sh.delete(kill)
        del_s += time.perf_counter() - t0
        deleted = target
        print(f"[live] level {frac:.2f}: {eng.live.n_deleted} tombstones "
              f"({eng.live.tombstone_frac:.4f} of {eng.live.n_total} rows), segment "
              f"{eng.live.seg_n} rows ({eng.live.segment_frac:.4f})", flush=True)
        lvl = serve_level(eng, sh, qs, ps, k, batch, f"tomb {frac:.2f}", base_p50)
        exact_before = lvl["exact"]
        serving += lvl["launches"]
    serving += live_index_check(eng, qs, ps, k)
    profile_runs({"central query()": lambda i: eng.query(qs[i], ps[i], k),
                  "sharded query()": lambda i: sh.query(qs[i], ps[i], k)}, 40, tag="live")
    n_ties = 0
    for i, ids, _ in exact_before:
        row = ids[0].tolist()
        for b, c in zip(copies.tolist(), copy_h.tolist()):
            if b in row and c in row:
                check(row.index(c) == row.index(b) + 1,
                      f"query {i}: the copy {c} of base row {b} does not come right after it: {row}")
                n_ties += 1
    check(n_ties > 0, "no served exact row held a base row and its copy")
    print(f"[live] upsert {n_up} rows in {up_s:.2f} s ({n_up / up_s:.0f} rows/s; {replace.size} "
          f"ids= replacements, {copies.size} exact copies of base rows), delete "
          f"{eng.live.n_deleted} rows in {del_s:.2f} s ({eng.live.n_deleted / del_s:.0f} rows/s); "
          f"{n_ties} served exact rows hold a base row and its copy, the copy right after it",
          flush=True)

    # a shard stops beating: replan to 3 and reshard the live deployment
    hb = HeartbeatMonitor(n_hosts=n_shards, timeout=0.05)
    events, now = [], 0.0
    for step in range(12):
        now += 0.01
        for si in range(n_shards):
            if not (si == 2 and step >= 4):
                hb.beat(si, now)
        events += hb.check(step, now)
        sh.query(qs[step], ps[step], k)
    check([(e.kind, e.host) for e in events] == [("dead_host", 2)], f"fault events {events}")
    shape, _ = replan_mesh(len(hb.alive), model_parallel=1)
    t0 = time.perf_counter()
    sh.reshard(shape[0])
    reshard_s = time.perf_counter() - t0
    check(len(sh.shards) == 3, "reshard did not give 3 shards")
    for i, ids, dists in exact_before:
        r = sh.query(qs[i], ps[i], k)
        check(np.array_equal(r.result.ids, ids) and np.array_equal(r.result.dists, dists),
              f"query {i} after reshard: {r.result.ids} differs from {ids}")
    print(f"[live] shard 2 stopped beating: {events[0]}; replan_mesh -> {shape}; reshard(3) "
          f"{reshard_s:.2f} s; {len(exact_before)} exact rows equal the central engine's bitwise",
          flush=True)

    # compaction: exact rows map through id_map, and equal a fresh build
    t0 = time.perf_counter()
    id_map = sh.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    fresh = FilteredANNEngine(eng.vectors, eng.cat, eng.num, EngineConfig(device="cuda")).build()
    carry.install(fresh, gbm=carry.gbm_state(eng4.estimator.model),
                  planner=eng4.planner.state_dict())
    n_cmp = 0
    for i, ids, dists in exact_before:
        want = np.where(ids >= 0, id_map[np.maximum(ids, 0)], -1)
        for e in (eng, sh, fresh):
            r = e.query(qs[i], ps[i], k)
            if r.plan.strategy not in ("pre", "ipre"):
                continue
            n_cmp += 1
            check(np.array_equal(r.result.ids, want) and np.array_equal(r.result.dists, dists),
                  f"query {i} after compaction: {r.result.ids} differs from {want}")
    check(n_cmp > 0, "no exact row to compare after compaction")
    launches = ops.kernel_launches()
    check(serving > 0, "phase 4d's serving launched masked_l2_topk no time")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[live] compact (central + re-shard to 3) {compact_s:.2f} s (central rebuild "
          f"{eng.build_time_['compaction']:.2f} s) to {eng.vectors.shape[0]} rows; {n_cmp} exact "
          f"rows of the compacted central, sharded and a fresh build equal the live rows through "
          f"id_map bitwise; peak {peak:.2f} GB allocated in 4d", flush=True)
    print(f"[live] masked_l2_topk launches in 4d: {serving} serving (query() and batch_query() "
          f"at each level, LiveIndex), {launches['masked_l2_topk']} in the whole phase (builds, "
          f"checks, profiling, reshard and compaction included); kernel launches {launches}",
          flush=True)
    del fresh, sh, eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[live] phase 4d (plain engine, shards, churn, reshard, compaction) took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": {"masked_l2_topk": serving}, "upsert_rows_s": n_up / up_s, "delete_rows_s": deleted / del_s,
            "compact_s": compact_s, "peak_gb": peak}


# ----------------------------------------------------------------------
# phase 4e: the serving runtime, observability, checkpoints and the fleet
# ----------------------------------------------------------------------
RUNTIME_LOADS = (0.5, 2.0, 8.0)   # x 1 / ServiceModel().estimate(1), as runtime_bench.py
RUNTIME_READS = 400
POOL = 16                         # predicates drawn (zipf 1.2) by a trace
FLEET_TRAIN = 64                  # phase 4's training queries each tenant fits on
FLEET_TARGETS = (0.95, 0.60)      # fleet_bench.py: quiet SLO hit rate, fleet / shared
PROM_LINE = r'^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? \S+)$'


def _launches() -> int:
    from repro_torch.kernels import ops

    return ops.kernel_launches()["masked_l2_topk"]


def _idle(wall, busy) -> str:
    if busy is None:
        return "device time not measured"
    return f"device busy {busy:.3f} s of {wall:.3f} s wall, idle share {1 - busy / wall:.3f}"


def check_served(eng, req, res, truth, tag: str) -> bool:
    """A served read: k slots, every id passes its predicate once, and an
    exact plan equals ``truth`` up to ties.  Returns whether it was exact."""
    import numpy as np

    ids = res.result.ids[0][res.result.ids[0] >= 0]
    c, m = eng.live.row_attrs(ids)
    check(res.result.ids.shape == (1, req.k) and bool(req.pred.eval(c, m).all()),
          f"{tag} rid {req.rid}: an id fails its predicate")
    check(len(set(ids.tolist())) == ids.size, f"{tag} rid {req.rid}: an id came back twice")
    if not exact_plan(res.plan):
        return False
    td, ti = truth(req.query, req.pred)
    check(same_up_to_ties(np.asarray(req.query, np.float32), res.result.ids, res.result.dists,
                          ti, td),
          f"{tag} rid {req.rid} ({res.plan.strategy}): {res.result.ids} {res.result.dists} "
          f"differs from the truth {ti} {td}")
    return True


def carried_engine(src):
    """A plain engine over src's base rows, on src's device, with src's
    planner, GBM and IVF layout carried."""
    from repro_torch import carry
    from repro_torch.core import EngineConfig, FilteredANNEngine

    live = src.live
    eng = FilteredANNEngine(live.base_vectors, live.base_cat, live.base_num,
                            EngineConfig(device=src.device.type)).build()
    return carry.install(eng, centroids=src.ivf.centroids.cpu().numpy(),
                         assignment=carry.ivf_assignment(src.ivf),
                         gbm=carry.gbm_state(src.estimator.model),
                         planner=src.planner.state_dict())


def runtime_replays(eng, qs, pool, k: int) -> dict:
    """(a) runtime_bench.py's traffic: Poisson and bursty traces of 400
    reads at 0.5, 2 and 8 x the single-request virtual capacity through
    OnlineRuntime(max_batch=64, max_wait=0.005), each replayed twice."""
    import numpy as np

    from repro_torch.runtime import OnlineRuntime, SchedulerConfig, ServiceModel, make_trace

    cfg = SchedulerConfig(max_batch=64, max_wait=0.005)
    cap = 1.0 / ServiceModel().estimate(1)
    truth = TruthMemo(eng, k)
    serving, n_exact, out = 0, 0, {}
    for si, shape in enumerate(("poisson", "bursty")):
        for li, load in enumerate(RUNTIME_LOADS):
            tag = f"[runtime] {shape} x{load}"
            trace = make_trace(shape, qs, pool, RUNTIME_READS, load * cap, k=k,
                               seed=100 + 10 * si + li)
            l0 = _launches()
            rep = OnlineRuntime(eng, cfg).run_trace(trace)
            serving += _launches() - l0
            again = OnlineRuntime(eng, cfg).run_trace(trace)
            check(rep.batches == again.batches, f"{tag}: replay batches differ")
            check(rep.telemetry.counters() == again.telemetry.counters(),
                  f"{tag}: replay counters differ")
            rids = sorted(r for b in rep.batches for r in b)
            check(rids == list(range(len(trace))) and sorted(rep.results) == rids,
                  f"{tag}: not every request answered exactly once")
            for r in trace:
                check(np.array_equal(rep.ids(r.rid), again.ids(r.rid)),
                      f"{tag}: replay ids differ for rid {r.rid}")
                n_exact += check_served(eng, r, rep.results[r.rid], truth, tag)
            t0 = time.perf_counter()
            for r in trace:
                eng.query(r.query, r.pred, r.k)
            naive_qps = len(trace) / (time.perf_counter() - t0)
            c = snap = rep.telemetry.snapshot()
            hit = {t: c["deadline_met"].get(t, 0) / max(1, c["deadline_met"].get(t, 0)
                                                        + c["deadline_missed"].get(t, 0))
                   for t in sorted(set(c["deadline_met"]) | set(c["deadline_missed"]))}
            lat = snap["latency_virtual"]
            out[(shape, load)] = {"qps": snap["wall"]["throughput_qps"], "naive_qps": naive_qps}
            print(f"{tag}: {len(trace)} reads at {load * cap:.1f} virtual qps in "
                  f"{c['n_batches']} batches (mean {len(trace) / c['n_batches']:.1f}); measured "
                  f"{snap['wall']['throughput_qps']:.1f} QPS vs a per-request query() loop "
                  f"{naive_qps:.1f} ({snap['wall']['throughput_qps'] / naive_qps:.2f}x; "
                  f"runtime_bench's target 2x, not gated); virtual p50 {lat['p50'] * 1e3:.3f} / "
                  f"p99 {lat['p99'] * 1e3:.3f} ms (virtual); deadline hit rate (virtual) "
                  + ", ".join(f"{t} {v:.3f}" for t, v in hit.items())
                  + "; plans " + ", ".join(f"{p} {n}" for p, n in c["plan_counts"].items() if n),
                  flush=True)
    check(n_exact > 0, "no exact-plan row in the runtime replays")
    trace = make_trace("poisson", qs, pool, RUNTIME_READS, 2.0 * cap, k=k, seed=111)
    rep, wall, busy, _ = _device_busy(eng.device, lambda: OnlineRuntime(eng, cfg).run_trace(trace))
    print(f"[runtime] one replay (poisson x2.0) under torch.profiler: {_idle(wall, busy)}; "
          f"{n_exact} exact-plan rows equal an l2_topk truth up to ties; replays bitwise equal; "
          f"{serving} masked_l2_topk launches in the measured replays", flush=True)
    return {"launches": serving, "rows": out}


class LiveChecked:
    """A runtime backend that checks every served batch on the spot, before
    the next writes (``check_live_row``: exact rows against the live
    ground_truth bitwise and the independent live truth up to ties).
    ``launches`` counts the masked_l2_topk launches of the runtime's own
    batch_query calls, not those of the checks."""

    def __init__(self, eng):
        self.eng, self.n_exact, self.n_rows, self.launches = eng, 0, 0, 0

    def upsert(self, *a, **kw):
        return self.eng.upsert(*a, **kw)

    def delete(self, *a, **kw):
        return self.eng.delete(*a, **kw)

    def maybe_compact(self):
        return self.eng.maybe_compact()

    def batch_query(self, queries, preds, k):
        l0 = _launches()
        out = self.eng.batch_query(queries, preds, k)
        self.launches += _launches() - l0
        for j, res in enumerate(out):
            exact = exact_plan(res.plan)
            check_live_row(self.eng, queries[j], preds[j], res, k,
                           f"[writes] row {self.n_rows}", exact)
            self.n_rows += 1
            self.n_exact += exact
        return out


def writes_and_checkpoint(eng, ds, eng4, qs, pool, train_q, k: int) -> int:
    """(b) a Poisson trace with write_frac 0.1 (upserts of phase 4's
    training query vectors, held out of its served set; deletes from a pool
    of base handles), then a checkpoint of mutation_state() restored onto a
    fresh engine with the same carried state."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.ckpt import Checkpointer
    from repro_torch.runtime import OnlineRuntime, SchedulerConfig, ServiceModel, poisson_trace

    n = eng.vectors.shape[0]
    rng = np.random.default_rng(41)
    src = rng.choice(n, len(train_q), replace=False)
    wc = (np.asarray(train_q, np.float32), eng.cat[src], eng.num[src])
    cap = 1.0 / ServiceModel().estimate(1)
    trace = poisson_trace(qs, pool, RUNTIME_READS, 2.0 * cap, k=k, seed=7, write_frac=0.1,
                          write_corpus=wc, delete_pool=rng.choice(n, 4000, replace=False))
    backend = LiveChecked(eng)
    rep = OnlineRuntime(backend, SchedulerConfig(max_batch=64, max_wait=0.005)).run_trace(trace)
    serving = backend.launches
    c = rep.telemetry.counters()
    check(c["n_upserts"] > 0 and c["n_deletes"] > 0, f"[writes] no writes served: {c}")
    check(backend.n_exact > 0, "[writes] no exact row to check")
    print(f"[writes] {len(trace)} requests ({c['n_upserts']} upserted rows, {c['n_deletes']} "
          f"deleted, {c['n_compactions']} compactions) in {c['n_batches']} batches: no tombstoned "
          f"id in {backend.n_rows} reads, {backend.n_exact} exact rows equal the live ground "
          f"truth bitwise and an l2_topk live truth up to ties; {serving} masked_l2_topk "
          f"launches in the runtime's batch_query calls", flush=True)

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        t0 = time.perf_counter()
        ck.save(1, eng.mutation_state(), meta={"corpus_generation": eng.corpus_generation})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_async(2, eng.mutation_state(), meta={"corpus_generation": eng.corpus_generation})
        ck.wait()
        async_s = time.perf_counter() - t0
        step = os.path.join(d, "step_00000002")
        n_bytes = sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step))
        t0 = time.perf_counter()
        fresh = carried_engine(eng4)
        _sync(fresh.device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.load_mutation_state(ck.restore(ck.latest_step(), fresh.mutation_state()))
        restore_s = time.perf_counter() - t0
        check(ck.steps() == [1, 2] and ck.latest_meta()["corpus_generation"]
              == eng.corpus_generation, f"checkpoint steps {ck.steps()}")
    check((fresh.live.n_total, fresh.live.live_count) == (eng.live.n_total, eng.live.live_count),
          "the restored engine's live rows differ")
    # every served row (exact plans, and post rows over the same carried
    # IVF layout) and the exact live truth of every query, bitwise; writes
    # move n, which flips the carried planner (ROADMAP Queue 3), so the
    # exact truth is compared whatever the plan
    n_exact = 0
    for i in range(64):
        pred = pool[i % len(pool)]
        a, b = eng.query(qs[i], pred, k), fresh.query(qs[i], pred, k)
        n_exact += exact_plan(a.plan)
        check(a.plan.strategy == b.plan.strategy
              and np.array_equal(a.result.ids, b.result.ids)
              and np.array_equal(a.result.dists, b.result.dists),
              f"[ckpt] query {i}: restored {b.result.ids} differs from {a.result.ids}")
        check(np.array_equal(eng.ground_truth(qs[i], pred, k), fresh.ground_truth(qs[i], pred, k)),
              f"[ckpt] query {i}: the restored engine's exact live truth differs")
    print(f"[ckpt] mutation_state: save {save_s:.3f} s, save_async + wait {async_s:.3f} s, "
          f"{n_bytes} bytes on disk; fresh engine {build_s:.2f} s (build + carried state), "
          f"restore {restore_s:.3f} s; 64 served rows ({n_exact} exact plans) and 64 exact "
          f"live truths equal the live engine's bitwise", flush=True)
    del fresh
    return serving


def observability(eng, qs, pool, k: int) -> int:
    """(c) Tracer, RecallProbe and OnlineFeedback over one runtime."""
    import re

    from repro_torch.kernels.masked_l2 import SMEM_MAX
    from repro_torch.obs import (RecallProbe, Tracer, publish_kernel_budget,
                                 publish_kernel_dispatch, publish_stats, span_summary)
    from repro_torch.runtime import (FeedbackConfig, OnlineFeedback, OnlineRuntime,
                                     SchedulerConfig, ServiceModel, poisson_trace)

    cfg = SchedulerConfig(max_batch=64, max_wait=0.005)
    trace = poisson_trace(qs, pool, RUNTIME_READS, 2.0 / ServiceModel().estimate(1), k=k, seed=9)

    def cold(**kw):
        eng.plan_cache.clear()
        eng.pred_cache.clear()
        rep = OnlineRuntime(eng, cfg, **kw).run_trace(trace)
        eng.set_tracer(None)
        return rep

    # stats()'s kernel_dispatch moves over a traced replay by what its
    # execute spans' kernel_* attrs add up to, kernel by kernel
    d0 = eng.stats()["kernel_dispatch"]
    l0 = _launches()
    ta = Tracer()
    cold(tracer=ta)
    serving = _launches() - l0
    delta = {n: c - d0.get(n, 0) for n, c in eng.stats()["kernel_dispatch"].items()
             if c != d0.get(n, 0)}
    spans: dict = {}
    for s in ta.spans():
        if s.name == "execute":
            for key, v in s.attrs.items():
                if key.startswith("kernel_"):
                    spans[key[len("kernel_"):]] = spans.get(key[len("kernel_"):], 0) + v
    check(spans == delta and delta.get("fused_masked_topk", 0) > 0,
          f"execute spans hold dispatches {spans}, stats()' kernel_dispatch moved by {delta}")
    tb = Tracer()
    cold(tracer=tb)
    check(ta.deterministic_tree() == tb.deterministic_tree(),
          "two cold traced replays gave different span trees")
    tc = Tracer()
    _, wall, busy, _ = _device_busy(eng.device, lambda: cold(tracer=tc))
    rows = span_summary(tc)
    print(f"[obs] {sum(1 for _ in ta.spans())} spans a replay, equal across two cold replays; "
          f"execute spans' dispatches {spans} = stats()' kernel_dispatch delta; span_summary (kernel: rows "
          f"are enqueue walls, not device time) beside the profiler: {_idle(wall, busy)}", flush=True)
    for r in rows[:8]:
        print(f"[obs]   {r['stage']:<28} count {r['count']:>5}  wall {r['wall_s'] * 1e3:9.3f} ms  "
              f"self {r['self_s'] * 1e3:9.3f} ms")
    probe = RecallProbe(rate=0.05, seed=0)
    fb = OnlineFeedback(eng, FeedbackConfig(sample_rate=0.25, refit_every=32, min_examples=32,
                                            seed=0))
    t0 = time.perf_counter()
    rep = cold(tracer=Tracer(), probe=probe, feedback=fb)
    fb_s = time.perf_counter() - t0
    check(fb.n_refits >= 1, f"feedback attempted no refit: {fb.stats()}")
    check(probe.n_sampled > 0, "the probe sampled nothing")
    reg = rep.telemetry.registry
    publish_stats(reg, eng.stats())
    publish_kernel_dispatch(reg)
    publish_kernel_budget(reg)
    probe.publish(reg)
    fb.publish(reg)
    text = reg.prometheus_text()
    bad = [line for line in text.splitlines() if not re.match(PROM_LINE, line)]
    check(not bad, f"prometheus_text() lines that do not parse: {bad[:3]}")
    print(f"[obs] probe (rate 0.05, {probe.n_sampled} of {probe.n_seen} sampled) recall by "
          "class: " + ", ".join(f"{c} {v['recall']:.4f} (n={v['count']})"
                                for c, v in probe.estimates().items()), flush=True)
    print(f"[obs] feedback (wall-clock shadow labels, sample 0.25, refit every 32): "
          f"{fb.stats()} in {fb_s:.1f} s; prometheus_text() {len(text.splitlines())} lines parse",
          flush=True)
    print(f"[obs] smem budget (bytes per block; sm_90 allows {SMEM_MAX}): "
          + ", ".join(f"{lbl['kernel']} qt {lbl['qt']} {int(v)}"
                      f"{'' if reg.value('repro_kernel_smem_fits_sm90', **lbl) else ' (no)'}"
                      for lbl, v in reg.series("repro_kernel_smem_bytes")), flush=True)
    return serving


def fleet_phase(ds, qs, pool, train, k: int, device: str) -> int:
    """(d) fleet_bench.py's headline: three tenants over an even split of
    the rows, two quiet Poisson tenants at 0.3 of the fair load and one
    noisy bursty tenant at 8x, FleetRuntime (DRR, admission, autoscale)
    against the shared-queue baseline on one trace."""
    import tempfile

    import numpy as np

    from repro_torch.ckpt import Checkpointer
    from repro_torch.core import EngineConfig
    from repro_torch.fleet import (AdmissionController, AutoscaleConfig, CollectionSchema, Fleet,
                                   FleetConfig, FleetRuntime, FleetServiceModel, TenantCollection)
    from repro_torch.runtime import TenantTraceSpec, multi_tenant_trace

    batch = 64
    svc = FleetServiceModel()
    capacity = batch / (svc.dispatch + batch * min(svc.per_row.values()) / 2 + svc.fanout * 2)
    fair = capacity / 3
    quiet, noisy = {"standard": 0.9, "batch": 0.1}, {"standard": 1.0}
    tenants = [("checkout", quiet, "poisson", 0.3, 0.30), ("catalog", quiet, "poisson", 0.3, 0.30),
               ("analytics", noisy, "bursty", 8.0, 0.15)]
    n_each = ds.vectors.shape[0] // len(tenants)
    fleet = Fleet(total_shards=8)
    specs, times = [], []
    qt, pt = train
    for ti, (name, mix, kind, frac, duration) in enumerate(tenants):
        rows = slice(ti * n_each, (ti + 1) * n_each)
        is_noisy = kind == "bursty"
        schema = CollectionSchema(name=name, dim=ds.vectors.shape[1], n_shards=1 if is_noisy else 2,
                                  admit_rate=0.6 * fair if is_noisy else None,
                                  admit_burst=0.3 * fair if is_noisy else None)
        t0 = time.perf_counter()
        col = fleet.create(schema, ds.vectors[rows], ds.cat[rows], ds.num[rows],
                           config=EngineConfig(device=device),
                           train=(qt[:FLEET_TRAIN], pt[:FLEET_TRAIN]), k=k)
        _sync(col.engine.device)
        bt = col.engine.build_time_
        times.append(f"{name} {time.perf_counter() - t0:.2f} s (fit {bt['fit']:.2f}, ivf "
                     f"{bt['ivf']:.2f})")
        rate = frac * fair
        specs.append(TenantTraceSpec(name, qs, pool, int(rate * duration), rate, kind=kind, k=k,
                                     tier_mix=mix, burst_factor=8.0, burst_frac=0.25, cycle=0.05))
    trace = multi_tenant_trace(specs, seed=42)
    print(f"[fleet] {len(tenants)} tenants of {n_each} rows ({', '.join(times)}); fair share "
          f"{fair:.1f} virtual qps each; {len(trace)} requests", flush=True)

    def fleet_run():
        return FleetRuntime(fleet, FleetConfig(max_batch=batch, fair=True),
                            admission=AdmissionController.for_fleet(fleet),
                            autoscale=AutoscaleConfig(eval_every=0.05, min_window=24,
                                                      grow_miss_rate=0.15, shrink_miss_rate=0.02,
                                                      cooldown=0.05)).run_trace(trace)

    l0 = _launches()
    t0 = time.perf_counter()
    shared = FleetRuntime(fleet, FleetConfig(max_batch=batch, fair=False)).run_trace(trace)
    shared_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1 = fleet_run()
    fleet_s = time.perf_counter() - t0
    serving = _launches() - l0
    r2 = fleet_run()
    check(r1.batches == r2.batches and r1.rejected == r2.rejected, "fleet replay batches/rejects")
    check(r1.telemetry.counters() == r2.telemetry.counters(), "fleet replay counters differ")
    check([e.as_dict() for e in r1.scale_events] == [e.as_dict() for e in r2.scale_events],
          "fleet replay scale events differ")
    check(sorted(r1.results) == sorted(r2.results), "fleet replay answered other rids")
    for rid in r1.results:
        check(np.array_equal(r1.ids(rid), r2.ids(rid)), f"fleet replay ids differ for rid {rid}")
    truths = {n: TruthMemo(fleet[n].engine, k) for n in fleet.names()}
    n_exact = 0
    by_rid = {r.rid: r for r in trace}
    for tag, rep in (("[fleet]", r1), ("[fleet shared]", shared)):
        for rid, res in rep.results.items():
            req = by_rid[rid]
            n_exact += check_served(fleet[req.tenant].engine, req, res, truths[req.tenant], tag)
    check(n_exact > 0, "[fleet] no exact row to check")
    names = fleet.names()
    quiet_names = [t[0] for t in tenants if t[2] == "poisson"]
    hit = {n: (r1.slo_hit_rate(n), shared.slo_hit_rate(n)) for n in names}
    grows = [e for e in r1.scale_events if e.action == "grow"]
    shrinks = [e for e in r1.scale_events if e.action == "shrink"]
    print(f"[fleet] SLO hit rate (virtual) fleet / shared: "
          + ", ".join(f"{n} {a:.4f} / {b:.4f}" for n, (a, b) in hit.items())
          + f"; quiet min {min(hit[n][0] for n in quiet_names):.4f} (fleet_bench's target "
          f"{FLEET_TARGETS[0]}) / {min(hit[n][1] for n in quiet_names):.4f} (at most "
          f"{FLEET_TARGETS[1]}), not gated; rejected {len(r1.rejected)}", flush=True)
    print(f"[fleet] scale events: {len(grows)} grow, {len(shrinks)} shrink, "
          f"{len(r1.scale_events) - len(grows) - len(shrinks)} other: "
          + "; ".join(f"{e.t:.3f} {e.tenant} {e.action} {e.from_shards}->{e.to_shards}"
                      for e in r1.scale_events[:8]), flush=True)
    print(f"[fleet] shared run {shared_s:.2f} s, fleet run {fleet_s:.2f} s (reshards included); "
          f"two fleet runs equal (batches, rejects, ids, counters, scale events); {n_exact} exact "
          f"rows equal an l2_topk truth up to ties; {serving} masked_l2_topk launches in the "
          f"shared and first fleet runs", flush=True)
    t0 = time.perf_counter()
    fleet["checkout"].reshard(3)
    _sync(fleet["checkout"].engine.device)
    reshard_s = time.perf_counter() - t0
    fleet.reset_shards()

    # writes on one tenant, then save and restore onto fresh collections
    cat = fleet["catalog"]
    rng = np.random.default_rng(43)
    src = rng.choice(n_each, 64, replace=False)
    cat.upsert(np.asarray(qt[:64], np.float32), cat.engine.cat[src], cat.engine.num[src])
    cat.delete(rng.choice(n_each, 256, replace=False))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        fleet.save(ck, step=1)
        save_s = time.perf_counter() - t0
        fresh = Fleet(total_shards=8)
        t0 = time.perf_counter()
        for n in names:
            fresh.add(TenantCollection(fleet[n].schema, carried_engine(fleet[n].engine)))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh.restore(ck)
        restore_s = time.perf_counter() - t0
    n_cmp = 0
    for n in names:
        check(fresh[n].manifest()["live_count"] == fleet[n].manifest()["live_count"]
              and fresh[n].n_shards == fleet[n].n_shards, f"[fleet] {n}: restored manifest differs")
        for i in range(24):
            a, b = fleet[n].query(qs[i], pool[i % len(pool)], k), fresh[n].query(qs[i], pool[i % len(pool)], k)
            if exact_plan(a.plan):
                n_cmp += 1
                check(np.array_equal(a.result.ids, b.result.ids)
                      and np.array_equal(a.result.dists, b.result.dists),
                      f"[fleet] {n} query {i}: restored {b.result.ids} differs from {a.result.ids}")
    check(n_cmp > 0, "[fleet] no exact row to compare after restore")
    print(f"[fleet] reshard(3) of a {n_each}-row tenant {reshard_s:.2f} s; save {save_s:.3f} s, "
          f"3 fresh collections {build_s:.2f} s, restore {restore_s:.2f} s; {n_cmp} exact rows "
          f"equal bitwise after restore", flush=True)
    del fresh, fleet
    return serving


def runtime_phase(mp: dict, k: int = 10) -> dict:
    """Phase 4e: the runtime, checkpoints, observability and the fleet over
    a plain engine at phase 4's size, its state carried from phase 4."""
    import gc

    import torch

    from repro_torch.kernels import ops

    ds, qs, ps, eng4 = mp["ds"], mp["qs"], mp["preds"], mp["engine"]
    pool = ps[:POOL]
    t_phase = time.perf_counter()
    if eng4.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    eng = carried_engine(eng4)
    _sync(eng.device)
    print(f"[runtime] plain engine {time.perf_counter() - t0:.2f} s (build + phase 4's planner, "
          f"GBM and IVF layout)", flush=True)
    serving = runtime_replays(eng, qs, pool, k)["launches"]
    serving += writes_and_checkpoint(eng, ds, eng4, qs, pool, mp["train"][0], k)
    serving += observability(eng, qs, pool, k)
    del eng
    gc.collect()
    if eng4.device.type == "cuda":
        torch.cuda.empty_cache()
    serving += fleet_phase(ds, qs, ps[:24], mp["train"], k, eng4.device.type)
    gc.collect()
    peak = 0.0
    if eng4.device.type == "cuda":
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 1e9
    check(serving > 0, "phase 4e's serving launched masked_l2_topk no time")
    print(f"[runtime] masked_l2_topk launches in 4e: {serving} serving, "
          f"{ops.kernel_launches()['masked_l2_topk']} in the whole phase; peak {peak:.2f} GB "
          f"allocated; phase 4e took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": {"masked_l2_topk": serving}}


# ----------------------------------------------------------------------
# phase 3b: the decode attention kernel against its plain version
# ----------------------------------------------------------------------
def decode_bound(lengths, s: int, kv: int, gq: int, dh: int, elem: int):
    """(ms, "bytes" or "operations"): the least time for one call.  Each K/V
    byte below a row's length is read once, q read and out written once;
    4 flops (q.k and p.v) per K/V element per query head, on the fp32 CUDA
    cores the kernel uses."""
    pos = sum(min(int(n), s) for n in lengths)
    b = len(lengths)
    bytes_ = pos * kv * dh * 2 * elem + 2 * b * kv * gq * dh * 4 + 4 * b
    flops = 4 * pos * kv * gq * dh
    tb, tf = bytes_ / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def sdpa_call(q, k, v, length):
    """The library yardstick, timed here and used nowhere in the port: one
    scaled_dot_product_attention call with GQA and a boolean length mask."""
    import torch

    b, kv, gq, dh = q.shape
    mask = (torch.arange(k.shape[2], device=q.device)[None, :] < length[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(b, kv * gq, 1, dh).to(k.dtype), k, v, attn_mask=mask, enable_gqa=True)


def ragged_lengths(b: int, s: int, rng, chunk: int) -> list:
    """Lengths in [1, S] with S, 1 and one in the middle of a chunk."""
    if b == 1:
        return [s]
    lengths = [int(n) for n in rng.integers(1, s + 1, b)]
    lengths[0], lengths[-1] = s, 1
    if b > 2:
        lengths[1] = (s // 2 // chunk) * chunk + chunk // 2 + 3
    return lengths


def decode_checks() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import chunk_positions, decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    rows, max_err = {}, 0.0
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    cases = [(b, 8, 5, s, 128, dt, True) for dt in (torch.bfloat16, torch.float32)
             for s in (2088, 32768) for b in (1, 8, 32)]
    # the reference's kernel-test shapes (tests/test_kernels.py), and the
    # other head widths and group sizes the kernel takes
    cases += [(b, kv, gq, s, dh, torch.float32, False) for b, kv, gq, s, dh in
              [(2, 4, 2, 1024, 64), (1, 2, 8, 512, 128), (3, 1, 4, 1536, 64),
               (2, 8, 1, 512, 128), (3, 2, 4, 300, 32)]]
    cases += [(2, 2, 16, 700, 256, dt, False) for dt in (torch.bfloat16, torch.float32)]
    # bf16 at qwen3's dh 128 and the other group sizes: exact (1, 16) and padded (3, 12)
    cases += [(b, kv, gq, s, 128, torch.bfloat16, False) for b, kv, gq, s in
              [(2, 4, 1, 512), (3, 2, 3, 300), (2, 2, 12, 700), (2, 2, 16, 700)]]
    for b, kv, gq, s, dh, dt, timed in cases:
        chunk = chunk_positions(s, dh, torch.finfo(dt).bits // 8)
        lengths = ragged_lengths(b, s, rng, chunk)
        q = torch.randn((b, kv, gq, dh), generator=g, device=dev)
        k = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        v = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, length)
        err = float((out - ref).abs().max())
        tag = f"B={b} KV={kv} GQ={gq} S={s} dh={dh} {names[dt]} chunk {chunk} ({-(-s // chunk)} chunks)"
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL), f"decode_attention {tag}: err {err}")
        max_err = max(max_err, err)
        for _ in range(2):
            check(torch.equal(decode_attention_cuda(q, k, v, length), out),
                  f"decode_attention {tag}: a repeated call differs")
        if b == 32:
            for r in (0, 1, 17, 31):
                solo = decode_attention_cuda(q[r:r + 1].contiguous(), k[r:r + 1], v[r:r + 1],
                                             length[r:r + 1])
                check(torch.equal(solo[0], out[r]),
                      f"decode_attention {tag}: row {r} alone differs from the same row in the batch")
        if not timed:
            print(f"[decode] {tag} lengths {lengths[:4]}: max_abs_err {err:.3g}", flush=True)
            continue
        big = b * s >= 8 * 32768
        fns = {"kernel": lambda: decode_attention_cuda(q, k, v, length),
               "plain": lambda: decode_attention_ref(q, k, v, length),
               "sdpa": lambda: sdpa_call(q, k, v, length)}
        wall = {n: cuda_ms(f, 20 if n == "kernel" else (3 if big else 10)) for n, f in fns.items()}
        prof = {n: device_ms(f, 10, expect=1) if n == "kernel" else device_ms(f, 3)
                for n, f in fns.items()}
        on_card = {n: p[0] for n, p in prof.items()}
        check(all(v > 0 for v in on_card.values()),
              f"decode_attention {tag}: torch.profiler saw no device time in three windows: {on_card}")
        per_call = prof["kernel"][1]
        check(per_call == 1, f"decode_attention {tag}: {per_call} CUDA kernels per call, not 1")
        bound, by = decode_bound(lengths, s, kv, gq, dh, k.element_size())
        rows[(b, s, names[dt])] = dict(
            ms=wall["kernel"], plain_ms=wall["plain"], library_ms=wall["sdpa"],
            device_ms=on_card["kernel"], plain_device_ms=on_card["plain"],
            library_device_ms=on_card["sdpa"], launches_per_call=per_call, chunk=chunk,
            bound_ms=bound, bound_by=by, max_abs_err=err, lengths=lengths)
        print(f"[decode] {tag} positions {sum(lengths)}: kernel {wall['kernel']:.4f} ms "
              f"(device {on_card['kernel']:.4f}, {per_call:g} kernel per call), plain "
              f"{wall['plain']:.4f} ({on_card['plain']:.4f}), sdpa {wall['sdpa']:.4f} "
              f"({on_card['sdpa']:.4f}), bound {bound:.6g} ms ({by}); device / bound "
              f"{on_card['kernel'] / bound:.3f}, device / sdpa device "
              f"{on_card['kernel'] / on_card['sdpa']:.3f}; max_abs_err {err:.3g}", flush=True)
        if (b, s, dt) == (8, 2088, torch.bfloat16):
            for r, n in enumerate(lengths):     # the kernel never reads past a length
                k[r, :, n:], v[r, :, n:] = float("nan"), float("nan")
            again = decode_attention_cuda(q, k, v, length)
            torch.cuda.synchronize()
            check(torch.equal(again, out), "decode_attention read a position past a row's length")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    print("[decode] every shape within rtol=atol=2e-4 of the plain version; repeated calls "
          "equal (bitwise); a row alone equals the row in a batch of 32 (bitwise); NaN past each "
          "length never reaches the output; one CUDA kernel per call", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


# ----------------------------------------------------------------------
# phase 6: LM serving at qwen3-14b's full width and depth
# ----------------------------------------------------------------------
def lm_serving(n_requests: int = 16, slots: int = 8, new: int = 32, max_len: int = 2088) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models import Model
    from repro_torch.models.layers import attn_qkv, rms_norm
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(QWEN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[lm] {QWEN}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {w_bytes / 1e9:.3f} GB of weights initialised on the card in "
          f"{init_s:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    plens = rng.integers(256, 2049, n_requests)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    eng = ServeEngine(model, batch_slots=slots, max_len=max_len)
    prefill, decode = eng._prefill, eng._decode
    prefill_s, step_ms, positions, last = [], [], [], {}

    def timed_prefill(batch, lens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(batch, lens)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        last.update(cache=out[1], lens=lens, tokens=batch["tokens"])
        return out

    def timed_decode(cache, tok, lens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(cache, tok, lens)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        positions.append(int((lens + 1).sum()))
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_launches()
    n_steps = len(step_ms)
    check(launches["decode_attention"] == cfg.n_layers * n_steps,
          f"decode_attention launched {launches['decode_attention']} times over {n_steps} "
          f"decode steps of {cfg.n_layers} layers")
    check(all(len(results[r.uid]) == new and all(0 <= t < cfg.vocab_size for t in results[r.uid])
              for r in reqs), "a request came back without its tokens")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(v) for v in results.values())
    med = float(np.median(step_ms))
    kv_elem = last["cache"]["k"].element_size()
    embed_bytes = model.embed.numel() * model.embed.element_size()
    kv_bytes = float(np.median(positions)) * cfg.n_layers * cfg.n_kv_heads * cfg.dh * 2 * kv_elem
    bound = 1e3 * (w_bytes - embed_bytes + kv_bytes) / H100_BYTES_PER_S
    print(f"[lm] served {len(reqs)} requests ({n_tok} tokens; prompts {int(plens.min())}-"
          f"{int(plens.max())}) in {slots} slots in {serve_s:.2f} s: {n_tok / serve_s:.1f} tokens/s "
          f"end to end", flush=True)
    print(f"[lm] prefill per batch of {slots}: " + ", ".join(f"{x:.3f} s" for x in prefill_s),
          flush=True)
    print(f"[lm] decode: {n_steps} steps, median {med:.3f} ms/step (p90 "
          f"{np.percentile(step_ms, 90):.3f}), {slots / med * 1e3:.1f} tokens/s in decode; bound "
          f"{bound:.3f} ms/step (weights read {(w_bytes - embed_bytes) / 1e9:.3f} GB + KV "
          f"{kv_bytes / 1e9:.3f} GB at 3.35 TB/s; {1e3 * (w_bytes + kv_bytes) / H100_BYTES_PER_S:.3f}"
          f" ms counting every weight), step / bound {med / bound:.3f}", flush=True)
    print(f"[lm] decode_attention launches {launches['decode_attention']} = {cfg.n_layers} x "
          f"{n_steps} steps; peak memory {peak:.2f} GB", flush=True)

    # the kernel against its plain version on the model's own cache
    cache, lens, toks = last["cache"], last["lens"], last["tokens"]
    rows = torch.arange(toks.shape[0], device=toks.device)
    x = model._embed(toks[rows, lens.long() - 1][:, None])
    cache_err = 0.0
    for layer in (0, cfg.n_layers - 1):
        lp = model.layers[layer]
        q = attn_qkv(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, lens.long()[:, None])[0]
        q = q[:, 0].float().contiguous()
        kc, vc = cache["k"][layer], cache["v"][layer]
        out = decode_attention_cuda(q, kc, vc, lens.to(torch.int32))
        ref = decode_attention_ref(q, kc, vc, lens)
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL),
              f"decode_attention on the model's cache, layer {layer}: err {err}")
        cache_err = max(cache_err, err)
    print(f"[lm] kernel vs plain on the model's cache after prefill (layers 0 and "
          f"{cfg.n_layers - 1}, lengths {lens.tolist()}): max_abs_err {cache_err:.3g}", flush=True)
    last.clear()
    del cache

    agree = 0
    for r in reqs:
        out = np.asarray(results[r.uid])
        seq = np.concatenate([r.prompt, out[:-1].astype(np.int32)])
        h, _ = model._hidden({"tokens": seq[None]})
        tf = model._logits(h[:, len(r.prompt) - 1:])[0].argmax(-1).cpu().numpy()
        agree += int((tf == out).sum())
    print(f"[lm] served tokens equal to the teacher-forced argmax: {agree}/{n_tok} = "
          f"{agree / n_tok:.4f} (bf16, not gated: prefill and decode round at other places)",
          flush=True)
    idle, attn_ms = decode_idle_share(model, reqs[:slots], max_len, med)
    return {"model": model, "launches": launches, "step_ms": med, "bound_ms": bound,
            "attention_ms_per_step": attn_ms,
            "tokens_per_s": n_tok / serve_s, "prefill_s": prefill_s, "peak_gb": peak,
            "idle_share": idle, "cache_err": cache_err}


def decode_idle_share(model, reqs, max_len: int, step_ms: float, n: int = 8) -> float:
    """Device busy time of n decode steps under torch.profiler, as
    ServeEngine runs them (argmax copied to the host each step), against
    the un-profiled median step wall time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plens = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), int(plens.max())), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :plens[i]] = r.prompt
    lens = torch.as_tensor(plens, device=model.device)
    logits, cache = model.prefill({"tokens": toks}, max_len, lengths=lens)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(2):
        logits, cache = model.decode_step(cache, tok, lens)
        lens, tok = lens + 1, torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            logits, cache = model.decode_step(cache, tok, lens)
            lens, tok = lens + 1, torch.argmax(logits, -1).to(torch.int32)
            tok.cpu()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ka) / 1e3 / n
    if busy <= 0:
        print("[lm] decode step device time not measured (profiler saw none)", flush=True)
        return float("nan"), float("nan")
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:5]
    attn = sum(e.self_device_time_total for e in ka if "decode_attention" in e.key) / 1e3 / n
    idle = 1.0 - busy / step_ms
    print(f"[lm] decode step under torch.profiler: device busy {busy:.3f} ms/step against the "
          f"un-profiled {step_ms:.3f} ms/step (device idle share {idle:.3f}; profiled wall "
          f"{wall:.3f} ms/step); decode_attention kernel {attn:.4f} ms/step; top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top), flush=True)
    return idle, attn


# ----------------------------------------------------------------------
# phase 7: RAG over the phase-6 model and the phase-4 engine
# ----------------------------------------------------------------------
def rag_phase(model, mp: dict, k: int = 10) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import Predicate, RangePred
    from repro_torch.index.flat import l2_topk
    from repro_torch.kernels import ops
    from repro_torch.serve import RetrievalAugmentedServer

    eng, ds, preds, served = mp["engine"], mp["ds"], mp["preds"], mp["served"]
    rag = RetrievalAugmentedServer(model, eng,
                                   generator=torch.Generator(device="cuda").manual_seed(1))
    tokens = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (8, 512)).astype(np.int32)
    # examples/rag_serve.py's range predicate, and gen_queries predicates
    # whose phase-4 plans were exact and approximate
    year_lo = float(np.quantile(ds.num[:, 0], 0.6))
    chosen = [("range year >= q0.6",
               Predicate(ranges=(RangePred(0, ((year_lo, float(ds.num[:, 0].max()) + 1),)),)))]
    exact = [i for i, r in enumerate(served) if r.plan.strategy in ("pre", "ipre")][:3]
    approx = [i for i, r in enumerate(served) if r.plan.strategy == "post"][:2]
    chosen += [(f"gen_queries[{i}]", preds[i]) for i in exact + approx]
    q_host = rag.embed(tokens) * rag.scale        # what retrieve queries with

    ops.reset_kernel_launches()
    ops.reset_dispatch_stats()
    runs, embed_ms, ann_ms = [], [], []
    for name, pred in chosen:
        runs.append((name, pred, rag.retrieve(tokens, pred, k)))
        embed_ms.append(rag.last_timing["embed_s"] * 1e3 / len(tokens))
        ann_ms.append(rag.last_timing["ann_s"] * 1e3 / len(tokens))
    launches = ops.kernel_launches()
    check(launches["masked_l2_topk"] > 0, "RAG retrieval launched masked_l2_topk no time")

    vd = eng.vectors_dev
    n_exact = 0
    for j, (name, pred, outs) in enumerate(runs):
        mask = pred.eval(ds.cat, ds.num)
        for i, out in enumerate(outs):
            ids = out.result.ids[0][out.result.ids[0] >= 0]
            check(ids.size > 0 and bool(mask[ids].all()),
                  f"RAG {name} prompt {i}: an id fails the predicate, or none came back")
            if out.plan.strategy in ("pre", "ipre"):
                n_exact += 1
                td, ti = l2_topk(torch.as_tensor(q_host[i:i + 1], device=vd.device), vd, k,
                                 torch.as_tensor(mask, device=vd.device))
                check(same_up_to_ties(q_host[i], out.result.ids, out.result.dists,
                                      ti.cpu().numpy(), td.cpu().numpy()),
                      f"RAG {name} prompt {i}: exact plan differs from ground truth")
        print(f"[rag] {name}: plans " + ", ".join(sorted({o.plan.strategy for o in outs})) +
              f"; embed {embed_ms[j]:.3f} ms, ANN {ann_ms[j]:.3f} ms per request", flush=True)
    print(f"[rag] {len(runs)} predicates x {len(tokens)} prompts of {tokens.shape[1]} tokens: "
          f"median embed {np.median(embed_ms):.3f} ms/request, median ANN "
          f"{np.median(ann_ms):.3f} ms/request; every id passes its predicate; {n_exact} exact "
          f"plans equal ground truth up to ties; launches {launches}", flush=True)
    return {"launches": launches, "embed_ms": float(np.median(embed_ms)),
            "ann_ms": float(np.median(ann_ms))}


# ----------------------------------------------------------------------
# phase 8: fp32 exactness at full width, depth 4
# ----------------------------------------------------------------------
def fp32_exactness(n_layers: int = 4, new: int = 16) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_config(QWEN), n_layers=n_layers, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(64, 513, 4)]
    max_len = 512 + new
    batch = ServeEngine(model, batch_slots=4, max_len=max_len).run(
        [Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        solo = ServeEngine(model, batch_slots=1, max_len=max_len).run(
            [Request(uid=0, prompt=p, max_new_tokens=new)])[0]
        check(solo == batch[i], f"fp32: prompt {i} ({len(p)} tokens) served alone gives {solo}, "
                                f"in the batch {batch[i]}")
    near = 0
    for i, p in enumerate(prompts):
        out = np.asarray(batch[i])
        h, _ = model._hidden({"tokens": np.concatenate([p, out[:-1].astype(np.int32)])[None]})
        logits = model._logits(h[:, len(p) - 1:])[0]
        top2 = logits.topk(2, dim=-1).values
        tie = ((top2[:, 0] - top2[:, 1]) < 1e-4 * logits.abs().max(-1).values).cpu().numpy()
        differ = logits.argmax(-1).cpu().numpy() != out
        check(not (differ & ~tie).any(),
              f"fp32: prompt {i}: served tokens differ from the teacher-forced argmax at "
              f"{np.flatnonzero(differ & ~tie).tolist()}")
        near += int(tie.sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[fp32] {QWEN} full width, {n_layers} layers, fp32: {len(prompts)} ragged requests "
          f"({[len(p) for p in prompts]} tokens) x {new} new: batch tokens equal solo tokens; served "
          f"tokens equal the teacher-forced argmax ({near} positions with a top-2 gap below "
          f"1e-4 x max|logit| exempt); peak memory {peak:.2f} GB", flush=True)
    return {"near_ties": near}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_140_000)
    ap.add_argument("--train", type=int, default=200)
    ap.add_argument("--serve", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    from repro_torch.device import strict_fp32

    strict_fp32()
    t_start = time.perf_counter()
    build_kernels()
    kc = kernel_checks(2_140_000, 384)
    dc = decode_checks()
    mp = main_path(args.rows, args.train, args.serve, args.batch)
    dnf = dnf_phase(mp)
    rt = routed_phase(mp, dnf["unions"])
    del rt["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    lv = live_phase(mp)
    ru = runtime_phase(mp)
    lm = lm_serving()
    rag_phase(lm["model"], mp)
    del lm["model"], mp["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    fp32_exactness()
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    head = kc["rows"][(1, 2_140_000, 10)]
    b256 = kc["rows"][(256, 2_140_000, 10)]
    dhead = dc["rows"][(8, 2088, "bf16")]
    kernels = [{
        "name": "masked_l2_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_l2_topk.cu",
        "replaces": "src/repro/kernels/masked_l2.py:33",
        "launches": sum(p["launches"]["masked_l2_topk"] for p in (mp, dnf, rt, lv, ru)),
        "max_abs_err": kc["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": {"B": 1, "N": 2_140_000, "d": 384, "k": 10, "mask_pass": 0.5},
        "ms_b256": b256["ms"], "library_ms_b256": b256["library_ms"],
        "bound_ms_b256": b256["bound_ms"], "path_b256": b256["path"],
        "check": "ok",
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:29",
        "launches": lm["launches"]["decode_attention"],
        "max_abs_err": max(dc["max_abs_err"], lm["cache_err"]),
        "ms": dhead["ms"], "plain_ms": dhead["plain_ms"], "bound_ms": dhead["bound_ms"],
        "bound_by": dhead["bound_by"], "library_ms": dhead["library_ms"],
        "device_ms": dhead["device_ms"], "plain_device_ms": dhead["plain_device_ms"],
        "library_device_ms": dhead["library_device_ms"],
        "launches_per_call": dhead["launches_per_call"], "chunk": dhead["chunk"],
        "shape": {"B": 8, "KV": 8, "GQ": 5, "S": 2088, "dh": 128, "kv_dtype": "bf16",
                  "positions": sum(dhead["lengths"])},
        "check": "ok",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
