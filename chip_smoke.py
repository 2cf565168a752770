"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--rows N] [--train Q] [--serve Q]

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the build of every hand-written kernel from the sources in this
     checkout (one nvcc per source, started together);
  3. each kernel against its plain PyTorch version on the card at the
     main path's shapes, with its time, the plain version's, the library
     yardstick's and the bound;
  4. the port's main path through its public entry points on the arxiv
     dataset at the paper's full size (2.14M x 384): build -> fit ->
     query / batch_query -> ground_truth, with the kernel launch counts
     read around exactly this phase;
  5. one JSON line listing every kernel, then the card line, then the
     result line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result.  It needs a CUDA card and the repo's ``src/`` beside it, and
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
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

    builders = {"masked_l2_topk": masked_l2.build_library}
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
    return {"launches": launches, "post_recall": post_recall}


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
    build_kernels()
    kc = kernel_checks(2_140_000, 384)
    mp = main_path(args.rows, args.train, args.serve, args.batch)
    head = kc["rows"][(1, 2_140_000, 10)]
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
