"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--rows N] [--train Q] [--serve Q]

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from the sources in this
     checkout (one nvcc per source, started together);
  3. the masked L2 top-k against its plain PyTorch version on the card at
     the ANN path's shapes, with its time, the plain version's, the library
     yardstick's and the bound;
  3b. the flash-decode attention kernel likewise, at qwen3-14b's heads over
     B in {1, 8, 32} x S in {2088, 32768} x {bf16, f32} with ragged lengths,
     and at the reference tests' shapes; row independence (bitwise) and
     never reading past a row's length (NaN there);
  4. the filtered-ANN main path through its public entry points on the
     arxiv dataset at the paper's full size (2.14M x 384): build -> fit ->
     query / batch_query -> ground_truth;
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
just after it (phases 4, 6, 7).  Any failed check raises, so the script
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


def device_ms(fn, reps: int) -> float:
    """Device time per call: the CUDA kernels' self time under torch.profiler
    over reps warm calls.  Back-to-back event timing of a call whose device
    work is shorter than its host-side enqueue measures the enqueue; this
    does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / reps


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
    from repro_torch.kernels.masked_l2 import BIG, masked_l2_topk_cuda
    from repro_torch.kernels.ref import masked_l2_topk_ref

    dev = torch.device("cuda")
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
        for b in (1, 8, 64, 256):
            q = torch.randn((b, d), generator=g, device=dev)
            pd, pi = masked_l2_topk_ref(q, x, mask, 128)
            for k in (1, 10, 128):
                kd, ki = masked_l2_topk_cuda(q, x, mask, k)
                torch.cuda.synchronize()
                rd, ri = pd[:, :k], pi[:, :k]
                err = float((kd - rd).abs().max())
                close = torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
                agree = float((ki == ri).float().mean())
                check(close and agree > 0.95,
                      f"masked_l2_topk B={b} N={n} k={k}: err {err} agree {agree}")
                max_err = max(max_err, err)
                if k != 10 and not (k == 128 and n == 16):
                    continue
                kk = min(k, n)
                reps = 3 if n == n_full and b == 256 else 10
                ms = cuda_ms(lambda: masked_l2_topk_cuda(q, x, mask, k), reps)
                plain = cuda_ms(lambda: masked_l2_topk_ref(q, x, mask, k), 2 if n == n_full else 5)
                lib = cuda_ms(lambda: l2_topk(q, x, kk, mask), 2 if n == n_full else 5)
                bytes_ = 4 * b * d + n + 4 * n_pass * d + 8 * b * k
                flops = 2 * b * n_pass * d + 2 * n_pass * d
                bound = 1e3 * max(bytes_ / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)
                by = "bytes" if bytes_ / H100_BYTES_PER_S >= flops / H100_FP32_FLOPS else "operations"
                rows[(b, n, k)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                       bound_by=by, max_abs_err=err, agree=agree)
                print(f"[kernel] masked_l2_topk B={b} N={n} d={d} k={k} pass={n_pass}: "
                      f"kernel {ms:.4f} ms, plain {plain:.4f} ms, l2_topk {lib:.4f} ms, "
                      f"bound {bound:.6g} ms ({by}), max_abs_err {err:.3g}, "
                      f"id agreement {agree:.4f}", flush=True)
    # all masked, padding never returned, ties, row independence
    x = corpus[:4096]
    q = torch.randn((8, d), generator=g, device=dev)
    kd, ki = masked_l2_topk_cuda(q, x, torch.zeros(4096, dtype=torch.bool, device=dev), 10)
    check(bool((ki == -1).all()) and bool((kd == BIG).all()), "all-masked case")
    kd, ki = masked_l2_topk_cuda(q, x[:513], torch.ones(513, dtype=torch.bool, device=dev), 128)
    check(bool((ki < 513).all()) and bool((ki >= 0).all()), "ragged tail rows")
    dup = torch.cat([x[:2048], x[:2048]])            # row i and i+2048 tie
    kd, ki = masked_l2_topk_cuda(q, dup, torch.ones(4096, dtype=torch.bool, device=dev), 10)
    rd, ri = masked_l2_topk_ref(q, dup, torch.ones(4096, dtype=torch.bool, device=dev), 10)
    check(torch.allclose(kd, rd, rtol=RTOL, atol=ATOL)
          and bool((ki[:, 0::2] < 2048).all())
          and torch.equal(ki[:, 1::2], ki[:, 0::2] + 2048)
          and torch.equal(kd[:, 1::2], kd[:, 0::2]), "ties go to the lowest id")
    mask = torch.rand(n_full, generator=g, device=dev) < 0.5
    qb = torch.randn((64, d), generator=g, device=dev)
    bd, bi = masked_l2_topk_cuda(qb, corpus, mask, 10)
    for r in (0, 9, 37, 63):
        sd, si = masked_l2_topk_cuda(qb[r:r + 1].clone(), corpus, mask, 10)
        check(torch.equal(sd[0], bd[r]) and torch.equal(si[0], bi[r]),
              f"row {r} alone differs from the same row in a batch of 64")
    print("[kernel] all-masked, ragged tail, lowest-id ties, row independence: ok", flush=True)
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
    where_time_goes(eng, qs, ps, served, k)
    return {"launches": launches, "post_recall": post_recall, "engine": eng, "ds": ds,
            "preds": ps, "served": served}


def where_time_goes(eng, qs, ps, served, k: int, n: int = 40) -> None:
    """Device busy time against host wall time for each plan's executor,
    over n warm queries under torch.profiler, and the top device kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = {
        "pre": lambda i: eng.pre_exec.search(qs[i:i + 1], ps[i], k),
        "ipre": lambda i: eng.ipre_exec.search(qs[i:i + 1], ps[i], k),
        "post": lambda i: eng.post_exec.search(qs[i:i + 1], ps[i], k,
                                               est_selectivity=served[i].plan.est),
    }
    for name, run in runs.items():
        for i in range(n):          # warm: predicate cache, allocator
            run(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                run(i)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        # device-side events only: a CPU op's row repeats its kernels' time
        ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ka) / 1e3
        if busy <= 0:
            print(f"[time] {name}: device time not measured (profiler saw none)")
            continue
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[time] {name}: {n} queries, wall {wall / n:.3f} ms/query, device busy "
              f"{busy / n:.3f} ms/query, device idle share {1 - busy / wall:.3f}; top: "
              + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                          for e in top), flush=True)


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

    from repro_torch.kernels.decode_attention import CHUNK, decode_attention_cuda
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
    for b, kv, gq, s, dh, dt, timed in cases:
        lengths = ragged_lengths(b, s, rng, CHUNK)
        q = torch.randn((b, kv, gq, dh), generator=g, device=dev)
        k = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        v = torch.randn((b, kv, s, dh), generator=g, device=dev).to(dt)
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, length)
        err = float((out - ref).abs().max())
        tag = f"B={b} KV={kv} GQ={gq} S={s} dh={dh} {names[dt]}"
        check(torch.allclose(out, ref, rtol=RTOL, atol=ATOL), f"decode_attention {tag}: err {err}")
        max_err = max(max_err, err)
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
        on_card = {n: device_ms(f, 10 if n == "kernel" else 3) for n, f in fns.items()}
        bound, by = decode_bound(lengths, s, kv, gq, dh, k.element_size())
        rows[(b, s, names[dt])] = dict(
            ms=wall["kernel"], plain_ms=wall["plain"], library_ms=wall["sdpa"],
            device_ms=on_card["kernel"], plain_device_ms=on_card["plain"],
            library_device_ms=on_card["sdpa"],
            bound_ms=bound, bound_by=by, max_abs_err=err, lengths=lengths)
        print(f"[decode] {tag} positions {sum(lengths)}: kernel {wall['kernel']:.4f} ms "
              f"(device {on_card['kernel']:.4f}), plain {wall['plain']:.4f} "
              f"({on_card['plain']:.4f}), sdpa {wall['sdpa']:.4f} ({on_card['sdpa']:.4f}), "
              f"bound {bound:.6g} ms ({by}), "
              f"max_abs_err {err:.3g}", flush=True)
        if (b, s, dt) == (8, 2088, torch.bfloat16):
            for r, n in enumerate(lengths):     # the kernel never reads past a length
                k[r, :, n:], v[r, :, n:] = float("nan"), float("nan")
            again = decode_attention_cuda(q, k, v, length)
            torch.cuda.synchronize()
            check(torch.equal(again, out), "decode_attention read a position past a row's length")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    print("[decode] every shape within rtol=atol=2e-4 of the plain version; a row alone equals "
          "the row in a batch of 32 (bitwise); NaN past each length never reaches the output",
          flush=True)
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
    idle = decode_idle_share(model, reqs[:slots], max_len, med)
    return {"model": model, "launches": launches, "step_ms": med, "bound_ms": bound,
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
        return float("nan")
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:5]
    idle = 1.0 - busy / step_ms
    print(f"[lm] decode step under torch.profiler: device busy {busy:.3f} ms/step against the "
          f"un-profiled {step_ms:.3f} ms/step (device idle share {idle:.3f}; profiled wall "
          f"{wall:.3f} ms/step); top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top), flush=True)
    return idle


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
    lm = lm_serving()
    rag_phase(lm["model"], mp)
    del lm["model"], mp["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    fp32_exactness()
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    head = kc["rows"][(1, 2_140_000, 10)]
    dhead = dc["rows"][(8, 2088, "bf16")]
    kernels = [{
        "name": "masked_l2_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_l2_topk.cu",
        "replaces": "src/repro/kernels/masked_l2.py:33",
        "launches": mp["launches"]["masked_l2_topk"],
        "max_abs_err": kc["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": {"B": 1, "N": 2_140_000, "d": 384, "k": 10, "mask_pass": 0.5},
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
